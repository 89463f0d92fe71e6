"""SCHED01 — serve/ft randomness must come from an explicitly seeded
generator (``repro/check/rules/sched01.py``, with torch's draws).

The scheduling and workload layers are deterministic-by-contract: a
replayed trace must schedule, sample, and score identically
(DESIGN.md §14), and the conformance tests compare whole token streams
bitwise.  One unseeded or global-state random draw anywhere in those
packages breaks every downstream replay guarantee — silently, because the
run still "works".

Flagged inside any ``serve``/``ft`` directory (same scope rule as FT01):

* ``numpy.random.default_rng()`` with no seed argument (or an explicit
  ``None``) — a fresh OS-entropy generator.
* Any draw on numpy's GLOBAL legacy state (``numpy.random.poisson``,
  ``numpy.random.rand``, ...) — shared mutable state whose sequence
  depends on every other caller in the process.
* The stdlib ``random`` module's global functions, and ``random.Random()``
  constructed without a seed.
* torch's draws on its global generator: ``torch.rand``/``randn``/
  ``randint``/``randperm``/``multinomial``/``bernoulli``/``normal``/
  ``poisson`` without ``generator=`` (or with ``generator=None``), the
  ``*_like`` draws (they take no generator), and ``torch.manual_seed``,
  which reseeds that shared state for every other caller.

The sanctioned pattern threads one seeded generator::

    rng = np.random.default_rng(cfg.seed)   # SCHED01-clean
    n = rng.poisson(rate)
    gen = torch.Generator(device).manual_seed(cfg.seed)
    u = torch.rand(shape, generator=gen)    # SCHED01-clean
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..registry import Module, Rule, register
from ..report import Finding
from ._torch_rng import global_draw
from .ft01 import _in_scope

# numpy's global-state draw/seed surface (legacy RandomState module
# functions).  Methods on a Generator object never match: their qualname
# roots at the local variable, not at ``numpy.random``.
_NUMPY_GLOBAL = {
    "beta", "binomial", "bytes", "chisquare", "choice", "dirichlet",
    "exponential", "gamma", "geometric", "gumbel", "integers", "laplace",
    "lognormal", "multinomial", "normal", "permutation", "poisson",
    "rand", "randint", "randn", "random", "random_sample", "ranf",
    "sample", "seed", "shuffle", "standard_normal", "uniform", "vonmises",
    "weibull", "zipf",
}

_STDLIB_RANDOM = {
    "betavariate", "choice", "choices", "expovariate", "gauss",
    "getrandbits", "lognormvariate", "normalvariate", "paretovariate",
    "randbytes", "randint", "random", "randrange", "sample", "seed",
    "shuffle", "triangular", "uniform", "vonmisesvariate",
    "weibullvariate",
}


def _unseeded(node: ast.Call) -> bool:
    """No positional seed and no seed= keyword, or an explicit None."""
    if node.args:
        first = node.args[0]
        return isinstance(first, ast.Constant) and first.value is None
    for kw in node.keywords:
        if kw.arg == "seed":
            return (isinstance(kw.value, ast.Constant)
                    and kw.value.value is None)
    return True


@register
class Sched01(Rule):
    id = "SCHED01"
    title = ("unseeded or global-state randomness in serve/ or ft/ — "
             "draw from an explicitly seeded np.random.default_rng(seed) "
             "or torch.Generator")

    def check(self, module: Module) -> Iterator[Finding]:
        if not _in_scope(module.path):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.imports.qualname(node.func)
            if qn is None:
                continue
            if qn == "numpy.random.default_rng" and _unseeded(node):
                yield module.finding(
                    node, self.id,
                    f"unseeded default_rng() in {module.path} — pass an "
                    f"explicit seed so traces and schedules replay "
                    f"identically")
            elif (qn.startswith("numpy.random.")
                  and qn.rsplit(".", 1)[1] in _NUMPY_GLOBAL):
                yield module.finding(
                    node, self.id,
                    f"numpy GLOBAL-state draw '{qn}()' in {module.path} — "
                    f"its sequence depends on every other caller in the "
                    f"process; draw from a local seeded "
                    f"np.random.default_rng(seed) instead")
            elif (qn.startswith("random.")
                  and qn.rsplit(".", 1)[1] in _STDLIB_RANDOM):
                yield module.finding(
                    node, self.id,
                    f"stdlib global random call '{qn}()' in {module.path} "
                    f"— use a local seeded np.random.default_rng(seed)")
            elif qn == "torch.manual_seed":
                yield module.finding(
                    node, self.id,
                    f"torch.manual_seed() in {module.path} reseeds the "
                    f"process-wide generator behind every other caller — "
                    f"build a torch.Generator().manual_seed(seed) and pass "
                    f"it as generator=")
            elif global_draw(node, module.imports, methods=False):
                yield module.finding(
                    node, self.id,
                    f"torch global-generator draw '{qn}()' in "
                    f"{module.path} — pass generator= a seeded "
                    f"torch.Generator so streams replay identically")
            elif qn == "random.Random" and _unseeded(node):
                yield module.finding(
                    node, self.id,
                    f"unseeded random.Random() in {module.path} — "
                    f"construct with an explicit seed (or use "
                    f"np.random.default_rng(seed))")
