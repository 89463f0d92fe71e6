"""engine_step_ms.chat: Mean host wall of one LLM.step in the untraced part."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "engine step loop (serve/engine.py Engine.step)"
MOVES = "gen_tokens_per_s"


def read(rec):
    v = C.step_ms(rec)
    return sum(v) / len(v) if v else None
