"""EXC01 — broad exception handlers must not swallow silently
(``repro/check/rules/exc01.py``, word for word in its contract).

A bare ``except:`` or ``except Exception/BaseException:`` whose body
neither re-raises nor visibly reports (logging/warnings/traceback
print) hides real failures: a kernel launch that fails inside one
turns into a silent fallback or a wrong answer far from its cause.
Narrow the type to what the guarded call can actually raise, or log and
re-raise.  Genuinely-broad probes (sweeps that record per-case
failures, private-API capability probes) carry a
documented ``# check: disable=EXC01 -- reason`` suppression instead.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..registry import Module, Rule, register
from ..report import Finding

_BROAD = {"Exception", "BaseException"}
# A call to any of these inside the handler counts as visible reporting.
_REPORTING_ATTRS = {"warn", "warning", "error", "exception", "critical",
                    "log", "print_exc"}
_REPORTING_ROOTS = {"logging", "warnings", "logger", "log"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True
    return False


def _handles(handler: ast.ExceptHandler, module: Module) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            qn = module.imports.qualname(node.func)
            if qn is None:
                continue
            parts = qn.split(".")
            if parts[0] in _REPORTING_ROOTS or \
                    parts[-1] in _REPORTING_ATTRS:
                return True
    return False


@register
class Exc01(Rule):
    id = "EXC01"
    title = ("broad except (bare/Exception/BaseException) that neither "
             "re-raises nor logs")

    def check(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and not _handles(node, module):
                what = ("bare except" if node.type is None
                        else "except Exception")
                yield module.finding(
                    node, self.id,
                    f"{what} swallows errors silently — narrow the "
                    f"exception type, or log/re-raise (suppress with a "
                    f"documented reason if breadth is the contract)")
