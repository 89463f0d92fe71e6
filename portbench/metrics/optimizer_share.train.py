"""optimizer_share.train: Share of the spans part's training steps spent in AdamW.update,
synchronised."""

from portbench.metrics import _common as C

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "trainer and optimizer (train/trainer.py, optim/adamw.py)"
MOVES = "train_tokens_per_s"


def read(rec):
    sp = rec.spans
    if sp is None or not sp.calls.get("optimizer") or rec.spans_wall <= 0:
        return None
    return 100.0 * sp.total["optimizer"] / rec.spans_wall
