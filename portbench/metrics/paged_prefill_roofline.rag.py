"""paged_prefill_roofline.rag: The paged attention kernel's prompt launches: least time of their work
(work.paged_prefill) over their profiled device time."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (kernels/paged_attention.py, kernels/moe_gemm.py, kernels/flash_attention.py)"
MOVES = "ttft_p90_ms"


def read(rec):
    return C.paged_roofline(rec, "prefill")
