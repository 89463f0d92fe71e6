"""decode_ms_per_step.chat: Mean synchronised wall of one Engine._decode pass, in the spans part."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "forward passes (Engine._decode, Engine._prefill)"
MOVES = "gen_tokens_per_s"


def read(rec):
    return C.span_ms_per_call(rec, "decode")
