"""setup_s: Process start to the first timed operation: drawing the weights,
building the kernels, warming every shape the traffic uses, and the
set-up the traffic needs (sessions' prompts, the first training steps)."""

from portbench.metrics import _common as C

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(rec):
    return rec.setup_s
