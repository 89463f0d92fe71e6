"""migration_share.chat: Share of the spans part spent in the pool's batched migrations
(exchange, swap_in_many, swap_out_many), each synchronised."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "tier migration (serve/kvcache.py)"
MOVES = "gen_tokens_per_s"


def read(rec):
    if rec.spans is None or rec.spans_wall <= 0:
        return None
    return 100.0 * rec.spans.outermost(C.MIGRATION) / rec.spans_wall
