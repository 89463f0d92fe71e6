"""DET01 — nondeterminism must not reach the device
(``repro/check/rules/det01.py``, restated for torch and CUDA).

The port's bar is bitwise: prefill == decode, tiered == resident, N
replicas == 1, two backward passes equal.  Flagged:

(a) in Python, CUDA's nondeterministic accumulations: ``index_add(_)``,
    ``scatter_add(_)``, ``scatter_reduce(_)``, ``index_reduce(_)``, and
    ``index_put(_)``/``put_`` with ``accumulate=True``.  On the card they
    add through atomics in whatever order the threads arrive, so two runs
    differ in their last bits.  Use a fixed-order reduction (a sort and a
    segment sum, a dense matmul against a one-hot);
(b) in ``.cu`` sources, every ``atomic*`` intrinsic (and
    ``cuda::atomic``/``atomic_ref``), and every PTX ``red.``/``atom.``/
    ``cp.reduce.`` in inline asm: the same arrival-order sum;
(c) the JAX rule's trace checks, from the port's "traced" entries — the
    ``forward``/``backward`` of ``torch.autograd.Function`` subclasses and
    ``nn.Module.forward`` — over the module-local call graph: stdlib
    ``random.*`` and ``np.random.*`` calls (host draws that differ from
    run to run or process to process), and iteration over a set (its
    order depends on PYTHONHASHSEED, so op order and numerics do).

Wall-clock reads are left out: eager torch has no trace to bake a
constant into, so a clock read in a forward is a measurement, not a
numerics hazard.  Only files in the port's scope (``rules/_port.py``)
are read.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Set

from .. import callgraph, cudasrc
from ..registry import AnyModule, CudaModule, Module, Rule, register
from ..report import Finding
from ._port import in_port

_ACCUMULATE = {"index_add", "index_add_", "scatter_add", "scatter_add_",
               "scatter_reduce", "scatter_reduce_", "index_reduce",
               "index_reduce_"}
# name -> index of the positional ``accumulate`` argument (after self for
# the Tensor method, after the tensor for the torch function).
_PUT = {"index_put": 2, "index_put_": 2, "put_": 2, "put": 2}
_TORCH_PUT = {"torch.index_put": 3, "torch.put": 3}

_FUNCTION_BASES = {"torch.autograd.Function",
                   "torch.autograd.function.Function"}
_MODULE_BASES = {"torch.nn.Module", "torch.nn.modules.module.Module"}

_CUDA_ATOMIC = re.compile(
    r"\b(atomic[A-Z]\w*|__nv_atomic\w*|atomic_ref|cuda::atomic)\b")
_PTX_ACCUMULATE = re.compile(r"\b(red|atom|cp\.reduce)\.")
# A PTX comment inside an asm string runs to its "\n" escape or the end.
_PTX_COMMENT = re.compile(r"//.*?(?=\\n|$)|/\*.*?\*/")


def _literal_true(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _accumulating_put(call: ast.Call, qn: str) -> bool:
    name = call.func.attr if isinstance(call.func, ast.Attribute) else ""
    for kw in call.keywords:
        if kw.arg == "accumulate":
            return _literal_true(kw.value)
    idx = _TORCH_PUT.get(qn)
    if idx is None and name in _PUT and not qn.startswith("torch."):
        idx = _PUT[name]
    return idx is not None and len(call.args) > idx and \
        _literal_true(call.args[idx])


def _traced_classes(module: Module) -> List[ast.ClassDef]:
    """Classes deriving (directly, or through a class of this module) from
    ``torch.autograd.Function`` or ``torch.nn.Module``."""
    classes = [n for n in ast.walk(module.tree)
               if isinstance(n, ast.ClassDef)]
    traced: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for cls in classes:
            if cls.name in traced:
                continue
            for base in cls.bases:
                qn = module.imports.qualname(base) or ""
                if qn in _FUNCTION_BASES or qn in _MODULE_BASES or \
                        qn in traced:
                    traced.add(cls.name)
                    changed = True
                    break
    return [c for c in classes if c.name in traced]


def _entry_points(module: Module) -> List[ast.AST]:
    entries: List[ast.AST] = []
    for cls in _traced_classes(module):
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in ("forward", "backward"):
                entries.append(node)
    return entries


def _set_valued(node: ast.expr) -> bool:
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


@register
class Det01(Rule):
    id = "DET01"
    title = ("nondeterminism reaching the device: scatter/index "
             "accumulations, CUDA atomics, host randomness or set "
             "iteration under an autograd/nn.Module forward")
    kinds = ("py", "cu")

    def check(self, module: AnyModule) -> Iterator[Finding]:
        if not in_port(module.path):
            return
        if isinstance(module, CudaModule):
            yield from self._check_cuda(module)
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.imports.qualname(node.func) or ""
            name = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else qn.split(".")[-1])
            if name in _ACCUMULATE:
                yield module.finding(
                    node, self.id,
                    f"'{name}' accumulates by index through atomics on "
                    f"the card: the sum order, so the bits, change from "
                    f"run to run — use a fixed-order reduction")
            elif (name in _PUT or qn in _TORCH_PUT) and \
                    _accumulating_put(node, qn):
                yield module.finding(
                    node, self.id,
                    f"'{name}(..., accumulate=True)' adds duplicates "
                    f"through atomics on the card — use a fixed-order "
                    f"reduction")
        yield from self._check_traced(module)

    def _check_traced(self, module: Module) -> Iterator[Finding]:
        entries = _entry_points(module)
        if not entries:
            return
        seen = set()
        for fn in callgraph.reachable(entries, module.functions):
            where = getattr(fn, "name", "<lambda>")
            for node in ast.walk(fn):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                if isinstance(node, ast.Call):
                    qn = module.imports.qualname(node.func)
                    if qn is None:
                        continue
                    if qn.startswith("random.") or \
                            qn.startswith("numpy.random."):
                        yield module.finding(
                            node, self.id,
                            f"'{qn}' inside a forward/backward (via "
                            f"'{where}') draws host bits that differ from "
                            f"run to run — draw from a seeded "
                            f"torch.Generator passed in")
                elif isinstance(node, (ast.For, ast.comprehension)):
                    it = node.iter
                    if _set_valued(it):
                        yield module.finding(
                            it, self.id,
                            f"iteration over a set inside a forward/"
                            f"backward (via '{where}') depends on "
                            f"PYTHONHASHSEED — sort it or use a "
                            f"list/tuple")

    def _check_cuda(self, module: CudaModule) -> Iterator[Finding]:
        for m in _CUDA_ATOMIC.finditer(module.code):
            yield module.finding(
                m.start(), self.id,
                f"'{m.group(1)}' adds in the order the threads arrive: the "
                f"result's bits change from launch to launch — reduce in a "
                f"fixed order (per-block partials summed in order)")
        for m in re.finditer(r"\basm\b(\s+volatile\b|\s+__volatile__\b)?"
                             r"\s*\(", module.code):
            close = cudasrc.matching(module.code, m.end() - 1)
            for start, end in module.strings:
                if m.end() <= start and end <= close:
                    ptx = _PTX_COMMENT.sub(lambda c: " " * len(c.group(0)),
                                           module.text[start:end])
                    for p in _PTX_ACCUMULATE.finditer(ptx):
                        yield module.finding(
                            start + p.start(), self.id,
                            f"PTX '{p.group(0)}' in inline asm reduces "
                            f"into memory in arrival order — reduce in a "
                            f"fixed order")

