"""guidance_ms_per_step.chat: Synchronised wall of the guidance controllers' on_step, less the
migrations nested inside it, per engine step of the spans part."""

from portbench.metrics import _common as C

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "guidance (core/runtime.py GuidanceRuntime.on_step)"
MOVES = "gen_tokens_per_s"


def read(rec):
    sp = rec.spans
    if sp is None or not sp.calls.get("guidance"):
        return None
    own = sp.total["guidance"] - sum(
        v for (p, c), v in sp.nested.items() if p == "guidance")
    return 1e3 * own / sp.calls["guidance"]
