"""mfu.rag: Model FLOPs of the profiled slice (2 per active parameter for every
prompt token ingested and every live decode row, and attention over
its context) over the slice's length times 989 TFLOP/s."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "device (H100)"
MOVES = "ttft_p90_ms"


def read(rec):
    return C.mfu(C.serve_model_flops(rec), rec)
