"""decode_ms_per_step.rag: Mean synchronised wall of one Engine._decode pass, in the spans part."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "forward passes (Engine._decode, Engine._prefill)"
MOVES = "itl_p98_ms"


def read(rec):
    return C.span_ms_per_call(rec, "decode")
