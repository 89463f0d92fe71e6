"""device_idle.chat: Share of the profiled slice in which no operation ran on the device."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device (H100)"
MOVES = "gen_tokens_per_s"


def read(rec):
    return C.device_idle(rec)
