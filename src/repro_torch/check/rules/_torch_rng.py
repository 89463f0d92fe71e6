"""torch's draws on its global generator, shared by SCHED01 and DET02.

A torch draw takes its bits from the process-wide default generator of
its device unless a ``generator=`` is passed: its values then depend on
every other draw in the process, and a replay, a second replica or a
prefill-then-decode run stops reproducing them.
"""

from __future__ import annotations

import ast
from typing import Optional

from ..callgraph import Imports

# torch.<name>(..., generator=...) draws.  The *_like variants take no
# generator at all, so every call of one reads the global state.
DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
         "bernoulli", "normal", "poisson"}
LIKE_DRAWS = {"rand_like", "randn_like", "randint_like"}
# Tensor methods that fill in place from a generator (matched by name: no
# numpy or stdlib method ends in the same underscore form).
INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                 "random_", "cauchy_", "log_normal_", "geometric_"}
# torch.nn.init initialisers that draw (zeros_, ones_, constant_, eye_ and
# dirac_ draw nothing).
INIT_DRAWS = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
              "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
              "orthogonal_", "sparse_"}
SEEDERS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
           "torch.random.seed", "torch.cuda.manual_seed",
           "torch.cuda.manual_seed_all", "torch.cuda.seed",
           "torch.cuda.seed_all"}


def _has_generator(call: ast.Call) -> bool:
    """A ``generator=`` keyword that is not the literal None."""
    for kw in call.keywords:
        if kw.arg == "generator":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
        if kw.arg is None:
            return True               # **kwargs may carry it: stay silent
    return False


def global_draw(call: ast.Call, imports: Imports,
                methods: bool) -> Optional[str]:
    """What global-generator draw ``call`` is (its dotted name), or None.
    ``methods`` adds the in-place Tensor draws and ``torch.nn.init``."""
    qn = imports.qualname(call.func)
    if qn is None:
        qn = ""
    parts = qn.split(".")
    if len(parts) == 2 and parts[0] == "torch":
        if parts[1] in LIKE_DRAWS:
            return qn
        if parts[1] in DRAWS and not _has_generator(call):
            return qn
    if not methods:
        return None
    if qn.startswith("torch.nn.init.") and parts[-1] in INIT_DRAWS:
        return None if _has_generator(call) else qn
    # x.normal_(...) or torch.Tensor.normal_(x, ...); not torch.<name>_.
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in INPLACE_DRAWS and \
            (qn.startswith("torch.Tensor.") or not qn.startswith("torch.")):
        return None if _has_generator(call) else f"Tensor.{call.func.attr}"
    return None
