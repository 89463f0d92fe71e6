"""flash_roofline.train: The flash attention kernels' forward and backward launches together:
least time of their work (work.flash) over their profiled device time."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (kernels/paged_attention.py, kernels/moe_gemm.py, kernels/flash_attention.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    return C.flash_roofline(rec)
