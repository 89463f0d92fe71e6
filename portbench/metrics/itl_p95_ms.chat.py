"""itl_p95_ms.chat: The chat cells' inter-token tail (95th percentile) in the untraced part."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "front door (serve/api.py LLM)"
MOVES = "gen_tokens_per_s"


def read(rec):
    return C.percentile(C.itl_ms(rec), 95)
