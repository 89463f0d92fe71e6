"""paged_decode_roofline.chat: The paged attention kernel's decode launches: least time of their work
(work.paged_decode) over their profiled device time."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (kernels/paged_attention.py, kernels/moe_gemm.py, kernels/flash_attention.py)"
MOVES = "gen_tokens_per_s"


def read(rec):
    return C.paged_roofline(rec, "decode")
