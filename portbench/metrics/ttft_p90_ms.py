"""ttft_p90_ms: 90th percentile of the time to first token of every request due in the
window, from when it was due (a request that never got one counts at the
end of the drain that waited for it)."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(rec):
    return C.percentile(C.ttft_ms(rec), 90)
