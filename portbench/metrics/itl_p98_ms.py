"""itl_p98_ms: 98th percentile of every gap between consecutive tokens of
one request in the window.  Under prompts of 1-4k tokens about one gap in
twenty holds a prefill that stalled the decode batch: the 98th percentile
reads those stalls (some twenty gaps lie beyond it in a window), where the
95th sits at the edge between them and plain decode gaps."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(rec):
    return C.percentile(C.itl_ms(rec), 98)
