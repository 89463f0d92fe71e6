"""mfu.train: Model FLOPs of the profiled steps (work.train_flops: 6 per active
parameter per token and the causal attention, no recomputation) over
the slice's length times 989 TFLOP/s."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "device (H100)"
MOVES = "train_tokens_per_s"


def read(rec):
    return C.mfu(C.train_model_flops(rec), rec)
