"""KRN01 — the kernel launch contract (``repro/check/rules/krn01.py``'s
Pallas grid/BlockSpec contract, restated for CUDA kernels bound through
``ctypes``).

A failed launch that nobody reads leaves the output buffer as
``torch.empty`` left it, and the run goes on with garbage; a launch that
nobody counts lets the plain version stand in for the kernel unseen.  The
rule checks both sides of the binding:

In ``.cu`` sources:

(a) every ``kernel<<<...>>>(...);`` launch is followed by a
    ``cudaGetLastError()`` before the next launch and before the function
    returns, and its value is returned, tested in an ``if``, or assigned
    and then tested or returned by the next statement;
(b) every function defined in an ``extern "C"`` block returns ``int``:
    the error code the Python wrapper reads.

In Python (a "library entry" is an attribute call on the result of a
module-local loader, a function that calls ``_build.load`` or
``ctypes.CDLL``, e.g. ``_lib().paged_attention_launch(...)``):

(c) every library entry's result is tested against 0 with a ``raise`` on
    the failing branch (``err = ...`` then ``if err != 0: raise``);
(d) every public module-level function that reaches a library entry,
    directly or through private module-local helpers (not through another
    public function, which answers for itself), adds to the module's
    ``LAUNCHES`` counter, in its own body or in the helper that holds the
    entry: the launches a run reports are the launches it made;
(e) no launch — a library entry, or a call of a ``*_cuda`` wrapper —
    sits inside a ``try`` with a handler that neither raises nor
    re-raises: that is a silent fallback to the plain version.

The JAX rule's bounds and revisited-store checks have no lexical CUDA
counterpart: a CUDA kernel indexes memory with runtime arithmetic, not
declared block specs, so which stores a thread may revisit is not in the
text.  The kernels' own plans (``plan`` in each wrapper, tested on the
CPU) and the launchers' refusal of any other plan carry that contract.
Macros are not expanded (a launch inside ``#define`` is not seen), and
sites the rule cannot resolve are skipped — it under-reports rather than
guessing.  Only files in the port's scope (``rules/_port.py``) are read.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set

from .. import callgraph, cudasrc
from ..registry import AnyModule, CudaModule, Module, Rule, register
from ..report import Finding
from ._port import in_port

_LOADERS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary", "ctypes.PyDLL"}
_COUNTER = "LAUNCHES"


# ------------------------------------------------------------------ CUDA
def _check_launches(module: CudaModule) -> Iterator[Finding]:
    code = module.code
    for m in re.finditer(r"<<<", code):
        fn = module.innermost(m.start(), ("function",))
        if fn is None:
            continue
        gt = code.find(">>>", m.end())
        if gt < 0:
            continue
        j = gt + 3
        while j < len(code) and code[j].isspace():
            j += 1
        if j >= len(code) or code[j] != "(":
            continue
        close = cudasrc.matching(code, j)
        end = code.find(";", close) if close >= 0 else -1
        if end < 0 or end > fn.close:
            continue
        s, _ = cudasrc.statement_bounds(code, m.start())
        while code[s].isspace():
            s += 1
        yield from _after_launch(module, s, end + 1, fn)


def _after_launch(module: CudaModule, launch: int, start: int,
                  fn: cudasrc.Block) -> Iterator[Finding]:
    code = module.code
    region = code[start:fn.close]
    get = re.search(r"\bcudaGetLastError\s*\(\s*\)", region)
    nxt = re.search(r"<<<", region)
    ret = re.search(r"\breturn\b", region)
    g = get.start() if get else None
    if nxt and (g is None or nxt.start() < g):
        yield module.finding(
            launch, "KRN01",
            "kernel launch is not followed by cudaGetLastError() before "
            "the next launch — a failed launch goes unread")
        return
    if ret and (g is None or ret.start() < g):
        s, e = cudasrc.statement_bounds(code, start + ret.start())
        if g is None or not (s <= start + g < e):
            yield module.finding(
                launch, "KRN01",
                "kernel launch is not followed by cudaGetLastError() "
                "before the function returns — a failed launch goes "
                "unread")
            return
    if g is None:
        yield module.finding(
            launch, "KRN01",
            "kernel launch is never followed by cudaGetLastError() — a "
            "failed launch goes unread")
        return
    if not _error_used(code, start + g):
        yield module.finding(
            start + g, "KRN01",
            "cudaGetLastError() after a launch is discarded — return it, "
            "or test it and return on failure")


def _error_used(code: str, pos: int) -> bool:
    s, e = cudasrc.statement_bounds(code, pos)
    stmt = " ".join(code[s:e].split())
    if re.match(r"(return|if)\b", stmt):
        return True
    m = re.match(r"(?:[\w:]+\s+)?(\w+)\s*=\s*(?:\(\w+\)\s*)?"
                 r"cudaGetLastError\s*\(\s*\)\s*;$", stmt)
    if m is None:
        return False
    name = m.group(1)
    ne = code.find(";", e)
    following = " ".join(code[e:len(code) if ne < 0 else ne].split())
    return bool(re.match(rf"(if\s*\(.*\b{name}\b|return\b.*\b{name}\b)",
                         following))


def _check_extern_c(module: CudaModule) -> Iterator[Finding]:
    for b in module.blocks:
        if b.kind != "function":
            continue
        parent = module.blocks[b.parent] if b.parent is not None else None
        in_c = (parent is not None and parent.kind == "extern_c") or \
            re.match(r'\s*extern\s+"\s*"', b.header)
        if not in_c:
            continue
        ret, name = cudasrc.function_name(b.header)
        if ret != "int":
            start = b.open - len(b.header.lstrip())
            yield module.finding(
                start, "KRN01",
                f"extern \"C\" function '{name}' returns '{ret}', not the "
                f"int error code its wrapper reads")


# ---------------------------------------------------------------- Python
def _loaders(module: Module) -> Set[str]:
    out: Set[str] = set()
    for node in module.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for call in ast.walk(node):
            if isinstance(call, ast.Call):
                qn = module.imports.qualname(call.func) or ""
                if qn in _LOADERS or qn.split(".")[-2:] == ["_build",
                                                            "load"]:
                    out.add(node.name)
    return out


def _entry_calls(fn: ast.AST, loaders: Set[str]) -> List[ast.Call]:
    """Library entries called in ``fn``: ``loader().name(...)``, or
    ``lib.name(...)`` after ``lib = loader()`` in the same function."""
    bound: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _is_loader_call(node.value, loaders):
            bound.add(node.targets[0].id)
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            obj = node.func.value
            if _is_loader_call(obj, loaders) or (
                    isinstance(obj, ast.Name) and obj.id in bound):
                out.append(node)
    return out


def _is_loader_call(node: ast.AST, loaders: Set[str]) -> bool:
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
        and node.func.id in loaders


def _body_of(stmt: ast.stmt, parents) -> Optional[List[ast.stmt]]:
    parent = parents.get(stmt)
    for field in ("body", "orelse", "finalbody"):
        seq = getattr(parent, field, None)
        if isinstance(seq, list) and stmt in seq:
            return seq
    return None


def _raises(body: List[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Raise) for s in body for n in ast.walk(s))


def _tests_nonzero(test: ast.expr, name: Optional[str],
                   call: ast.Call) -> bool:
    """``x != 0`` / ``0 != x`` / ``x`` where x is ``name`` or ``call``."""
    def is_x(node):
        return node is call or (name is not None and isinstance(
            node, ast.Name) and node.id == name)

    if is_x(test):
        return True
    if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
            isinstance(test.ops[0], (ast.NotEq, ast.IsNot)):
        a, b = test.left, test.comparators[0]
        zero = (lambda n: isinstance(n, ast.Constant) and n.value == 0)
        return (is_x(a) and zero(b)) or (is_x(b) and zero(a))
    return False


def _result_checked(call: ast.Call, module: Module) -> bool:
    parents = module.parents
    parent = parents.get(call)
    if isinstance(parent, ast.If) or (
            isinstance(parent, ast.Compare)
            and isinstance(parents.get(parent), ast.If)):
        node = parent if isinstance(parent, ast.If) else parents[parent]
        return _tests_nonzero(node.test, None, call) and _raises(node.body)
    if not (isinstance(parent, ast.Assign) and len(parent.targets) == 1
            and isinstance(parent.targets[0], ast.Name)):
        return False
    name = parent.targets[0].id
    body = _body_of(parent, parents)
    if body is None:
        return False
    i = body.index(parent)
    if i + 1 >= len(body) or not isinstance(body[i + 1], ast.If):
        return False
    nxt = body[i + 1]
    return _tests_nonzero(nxt.test, name, call) and _raises(nxt.body)


def _counts(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Subscript) and \
                isinstance(node.target.value, ast.Name) and \
                node.target.value.id == _COUNTER:
            return True
    return False


def _private_walk(fn: ast.FunctionDef, funcs: Dict[str, ast.AST],
                  public: Set[str]) -> List[ast.AST]:
    """``fn`` and the module-local functions it reaches without passing
    through another public function."""
    seen, order, queue = set(), [], [fn]
    while queue:
        f = queue.pop(0)
        if id(f) in seen:
            continue
        seen.add(id(f))
        order.append(f)
        for name in sorted(callgraph.called_names(f)):
            callee = funcs.get(name)
            if callee is not None and name not in public:
                queue.append(callee)
    return order


def _silent_try(call: ast.Call, parents) -> Optional[ast.Try]:
    child, cur = call, parents.get(call)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return None
        if isinstance(cur, ast.Try) and child in cur.body:
            for h in cur.handlers:
                if not _raises(h.body):
                    return cur
        child, cur = cur, parents.get(cur)
    return None


@register
class Krn01(Rule):
    id = "KRN01"
    title = ("kernel launch contract: cudaGetLastError after every "
             "launch, int extern \"C\" entries, wrapper results tested and "
             "raised, launches counted, no silent fallback")
    kinds = ("py", "cu")

    def check(self, module: AnyModule) -> Iterator[Finding]:
        if not in_port(module.path):
            return
        if isinstance(module, CudaModule):
            yield from _check_launches(module)
            yield from _check_extern_c(module)
            return
        loaders = _loaders(module)
        entries: List[ast.Call] = []
        if loaders:
            entries = _entry_calls(module.tree, loaders)
        for call in entries:
            if not _result_checked(call, module):
                yield module.finding(
                    call, self.id,
                    f"result of '{call.func.attr}' is not tested against 0 "
                    f"with a raise — a refused or failed launch would "
                    f"return garbage silently")
        if entries:
            yield from self._check_counted(module, loaders)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else node.func.id if isinstance(node.func, ast.Name)
                    else "")
            if node in entries or name.endswith("_cuda"):
                if _silent_try(node, module.parents) is not None:
                    yield module.finding(
                        node, self.id,
                        f"launch '{name}' inside a try whose handler "
                        f"neither raises nor re-raises — a failed launch "
                        f"silently falls back")

    def _check_counted(self, module: Module,
                       loaders: Set[str]) -> Iterator[Finding]:
        top = {n.name: n for n in module.tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        public = {n for n in top if not n.startswith("_")}
        for name in sorted(public):
            fn = top[name]
            walk = _private_walk(fn, module.functions, public)
            holders = [f for f in walk if _entry_calls(f, loaders)
                       and getattr(f, "name", "") not in loaders]
            if not holders:
                continue
            if not any(_counts(f) for f in [fn] + holders):
                yield module.finding(
                    fn, self.id,
                    f"'{name}' launches a kernel but never adds to "
                    f"{_COUNTER}: the run's launch counts would not show "
                    f"it")
