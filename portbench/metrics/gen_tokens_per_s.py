"""gen_tokens_per_s: All tokens generated in the window over the window's length."""

from portbench.metrics import _common as C

UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(rec):
    w = C.window_s(rec)
    return C.tokens_in_window(rec) / w if w > 0 else None
