"""grouped_ffn_roofline.chat: The grouped-expert kernels of MoE serving: least time of every launch's
work (work.grouped_ffn) over their profiled device time."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (kernels/paged_attention.py, kernels/moe_gemm.py, kernels/flash_attention.py)"
MOVES = "gen_tokens_per_s"


def read(rec):
    return C.grouped_ffn_roofline(rec)
