"""arrival_lateness_ms.rag: 95th percentile of how late the harness submitted or resumed a
request against its schedule, in the untraced part of the window."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "front door (serve/api.py LLM)"
MOVES = "ttft_p90_ms"


def read(rec):
    return C.percentile(C.lateness_ms(rec), 95)
