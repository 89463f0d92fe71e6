"""kv_bytes_per_token.chat: KV bytes moved between HBM and host memory (stats() bytes_moved) per
generated token, in the untraced part."""

from portbench.metrics import _common as C

UNIT = "B/token"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "tier migration (serve/kvcache.py)"
MOVES = "gen_tokens_per_s"


def read(rec):
    n = C.tokens_in_window(rec)
    return C.delta(rec, "bytes_moved") / n if n > 0 else None
