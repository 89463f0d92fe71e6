"""device_idle.rag: Share of the profiled slice in which no operation ran on the device."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device (H100)"
MOVES = "ttft_p90_ms"


def read(rec):
    return C.device_idle(rec)
