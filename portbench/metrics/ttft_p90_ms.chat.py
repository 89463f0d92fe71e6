"""ttft_p90_ms.chat: The chat cells' time-to-first-token tail (90th percentile, every turn
and document due in the untraced part), paced by the host there and so
not judged."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "front door (serve/api.py LLM)"
MOVES = "gen_tokens_per_s"


def read(rec):
    return C.percentile(C.ttft_ms(rec), 90)
