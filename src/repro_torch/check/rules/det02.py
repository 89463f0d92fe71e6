"""DET02 — generator discipline (``repro/check/rules/det02.py``, the key
discipline restated for torch's stateful generators).

torch has no keys: a draw takes its bits from a ``torch.Generator``, the
one passed as ``generator=`` or else the process-wide default of its
device.  Three patterns:

(a) *Global-state draws* anywhere in the port: ``torch.rand``/``randn``/
    ``randint``/``randperm``/``multinomial``/``bernoulli``/``normal``/
    ``poisson`` without ``generator=``, the ``*_like`` draws (they take
    none), the in-place ``Tensor.uniform_``/``normal_``/``bernoulli_``/
    ``exponential_``/``random_``/``cauchy_``/``log_normal_``/
    ``geometric_`` and the drawing ``torch.nn.init.*_`` without one, and
    the reseeding of the shared state (``torch.manual_seed``,
    ``torch.seed``, ``torch.cuda.manual_seed(_all)``).  The bits then
    depend on every other draw in the process: the counterpart of a key
    nobody split.
(b) *Hardcoded fallbacks*: ``torch.Generator(...).manual_seed(<literal>)``
    as a parameter default, or as the fallback arm of ``x if x is not None
    else ...`` / ``x or ...``.  A silent constant default makes every
    caller share one stream while looking seeded — require the generator
    (or an explicit seed) instead.
(c) *Reuse*, the counterpart of key reuse: a generator built and seeded
    inside a loop (or a comprehension) from a seed expression that no
    name of the loop changes.  Every iteration then redraws the same bits.

The sanctioned pattern builds one generator from an explicit seed and
threads it (``serve/api.py`` ``LLM.from_arch``, ``train/trainer.py``
``Trainer.__init__``)::

    gen = torch.Generator(device).manual_seed(seed)
    w = torch.randn(shape, generator=gen)

Only files in the port's scope (``rules/_port.py``) are read.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from ..registry import Module, Rule, register
from ..report import Finding
from ._port import in_port
from ._torch_rng import SEEDERS, global_draw

_GENERATORS = {"torch.Generator", "torch._C.Generator"}


def _is_generator(node: ast.AST, module: Module) -> bool:
    return isinstance(node, ast.Call) and \
        module.imports.qualname(node.func) in _GENERATORS


def _seeding(node: ast.AST, module: Module):
    """The ``(receiver, seed expression)`` of ``<x>.manual_seed(seed)``."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "manual_seed" and node.args:
        return node.func.value, node.args[0]
    return None


def _literal_generator(node: ast.AST, module: Module) -> bool:
    got = _seeding(node, module)
    return got is not None and _is_generator(got[0], module) and \
        isinstance(got[1], ast.Constant)


def _names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _assigned(body: List[ast.AST]) -> Set[str]:
    """Every name bound anywhere in ``body`` (nested defs excluded)."""
    out: Set[str] = set()
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Assign):
            for t in node.targets:
                out |= _names(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                               ast.AsyncFor, ast.comprehension)):
            out |= _names(node.target)
        elif isinstance(node, ast.NamedExpr):
            out |= _names(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            out |= _names(node.optional_vars)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _loops(tree: ast.AST):
    """(loop node, its body nodes, the names the loop changes)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            body = node.body
            yield node, body, _names(node.target) | _assigned(body)
        elif isinstance(node, ast.While):
            yield node, node.body, _assigned(node.body) | _assigned(
                [node.test])
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            elts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                    else [node.elt])
            body = elts + [c for g in node.generators for c in g.ifs]
            changed = _assigned(list(node.generators))
            yield node, body, changed | _assigned(elts)


def _walk_body(body: List[ast.AST]):
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class Det02(Rule):
    id = "DET02"
    title = ("torch generator discipline: global-generator draws, a "
             "hardcoded Generator().manual_seed(<literal>) fallback, or a "
             "generator reseeded to the same seed in a loop")

    def check(self, module: Module) -> Iterator[Finding]:
        if not in_port(module.path):
            return
        yield from self._global_draws(module)
        yield from self._fallbacks(module)
        yield from self._loop_reseeds(module)

    def _global_draws(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.imports.qualname(node.func)
            if qn in SEEDERS:
                yield module.finding(
                    node, self.id,
                    f"'{qn}' reseeds the process-wide generator behind "
                    f"every other caller — build a seeded torch.Generator "
                    f"and pass it as generator=")
                continue
            what = global_draw(node, module.imports, methods=True)
            if what:
                yield module.finding(
                    node, self.id,
                    f"'{what}' draws from torch's global generator: its "
                    f"bits depend on every other draw in the process — "
                    f"pass generator= a seeded torch.Generator")

    def _fallbacks(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                defaults = (list(node.args.defaults)
                            + [d for d in node.args.kw_defaults if d])
                for d in defaults:
                    if _literal_generator(d, module):
                        yield module.finding(
                            d, self.id,
                            "hardcoded Generator().manual_seed(<literal>) "
                            "as a parameter default shares one stream "
                            "across all callers — require a generator or "
                            "an explicit seed")
            elif isinstance(node, ast.IfExp):
                for arm in (node.body, node.orelse):
                    if _literal_generator(arm, module):
                        yield module.finding(
                            arm, self.id,
                            "hardcoded Generator().manual_seed(<literal>) "
                            "as a silent fallback — require a generator "
                            "or derive it from an explicit config seed")
            elif isinstance(node, ast.BoolOp) and isinstance(node.op,
                                                             ast.Or):
                for arm in node.values[1:]:
                    if _literal_generator(arm, module):
                        yield module.finding(
                            arm, self.id,
                            "hardcoded Generator().manual_seed(<literal>) "
                            "as an 'or' fallback — require a generator or "
                            "derive it from an explicit config seed")

    def _loop_reseeds(self, module: Module) -> Iterator[Finding]:
        reported: Set[int] = set()
        for loop, body, changed in _loops(module.tree):
            built: Set[str] = set()
            for node in _walk_body(body):
                if isinstance(node, ast.Assign) and \
                        _is_generator(node.value, module):
                    for t in node.targets:
                        built |= _names(t)
            for node in _walk_body(body):
                got = _seeding(node, module)
                if got is None or id(node) in reported:
                    continue
                receiver, seed = got
                fresh = _is_generator(receiver, module) or (
                    isinstance(receiver, ast.Name) and receiver.id in built)
                if fresh and not (_names(seed) & changed):
                    reported.add(id(node))
                    yield module.finding(
                        node, self.id,
                        "generator built and seeded inside a loop from a "
                        "seed the loop never changes: every iteration "
                        "redraws the same bits — fold the loop index into "
                        "the seed or build the generator once outside")
