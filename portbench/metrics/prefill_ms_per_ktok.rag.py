"""prefill_ms_per_ktok.rag: Synchronised wall of Engine._prefill per thousand prompt tokens
ingested, in the spans part."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "forward passes (Engine._decode, Engine._prefill)"
MOVES = "ttft_p90_ms"


def read(rec):
    sp = rec.spans
    n = sp.notes.get("prefill_tokens", 0) if sp is not None else 0
    if not n:
        return None
    return 1e3 * sp.total["prefill"] / n * 1e3
