"""admission_wait_steps.chat: Engine steps a request waited for admission, per admission, in the
untraced part: stats() admission_wait_steps over admissions."""

from portbench.metrics import _common as C

UNIT = "steps"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "scheduler (serve/scheduler.py, Engine._admit_waiting)"
MOVES = "gen_tokens_per_s"


def read(rec):
    n = C.delta(rec, "admissions")
    return C.delta(rec, "admission_wait_steps") / n if n > 0 else None
