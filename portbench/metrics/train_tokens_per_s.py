"""train_tokens_per_s: Tokens of every step finished in the window over the time from the
first timed step's start to the last one's end."""

from portbench.metrics import _common as C

UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(rec):
    steps = [s for s in rec.steps if rec.in_window(s[1])]
    if not steps:
        return None
    span = steps[-1][1] - steps[0][0]
    return sum(s[2] for s in steps) / span if span > 0 else None
