"""KV01 — the PagedKVPool acquire/copy_page/release_request protocol
(``repro/check/rules/kv01.py``; the port's ``serve/kvcache.py`` keeps
the same protocol).

The pool's refcount protocol (DESIGN.md Sec. 11) has three statically
checkable caller obligations.  Receivers are matched by name — the rule
applies to attribute calls whose object chain mentions ``pool`` (so
``threading.Lock.acquire`` and friends never false-positive), and the
class that *implements* the protocol (defines ``acquire``, ``free`` and
``release_request`` itself) is exempt:

1. **Leaked references** — a class (or a module's top-level functions)
   that calls ``pool.acquire(...)`` must somewhere drop references too
   (``pool.free``/``pool.release_request``): references taken but never
   returned pin physical pages forever.
2. **Copy-on-write** — a handle obtained ``acquire(..., shared=True)``
   is immutable; mutating its bookkeeping (``tokens_used`` etc.) without
   an intervening ``copy_page`` corrupts every other holder's KV.
3. **Freeing held pages** — a page reached through
   ``pool.request_pages(rid)`` is still in the pool's authoritative
   ``_seq`` table; ``pool.free`` on it desynchronizes the table from the
   refcounts.  Ownership is dropped per-request via ``release_request``.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from ..registry import Module, Rule, register
from ..report import Finding

_PROTOCOL = {"acquire", "free", "release_request"}
_RELEASERS = {"free", "release_request"}
# Page bookkeeping a shared handle may still touch (the eviction clock).
_SAFE_SHARED_ATTRS = {"last_used"}


def _pool_method(node: ast.AST, name: str) -> bool:
    """True for ``<...pool...>.name(...)`` attribute calls."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == name):
        return False
    chain: List[str] = []
    cur = node.func.value
    while isinstance(cur, ast.Attribute):
        chain.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        chain.append(cur.id)
    return any("pool" in part.lower() for part in chain)


def _implements_protocol(cls: ast.ClassDef) -> bool:
    defined = {n.name for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return _PROTOCOL <= defined


def _shared_kwarg(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "shared" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


@register
class Kv01(Rule):
    id = "KV01"
    title = ("PagedKVPool protocol: acquire without release, shared-page "
             "mutation without copy_page, free on a held request page")

    def check(self, module: Module) -> Iterator[Finding]:
        scopes: List[ast.AST] = [module.tree]
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                scopes.append(node)
        for scope in scopes:
            yield from self._check_scope(module, scope)
        for fn in module.functions.values():
            yield from self._check_shared_mutation(module, fn)
            yield from self._check_free_held(module, fn)

    # ------------------------------------------------ 1. leaked acquires
    def _check_scope(self, module: Module,
                     scope: ast.AST) -> Iterator[Finding]:
        if isinstance(scope, ast.ClassDef):
            if _implements_protocol(scope):
                return
            nodes = list(ast.walk(scope))
        else:
            # Module scope: everything not inside a class.
            in_class: Set[int] = set()
            for cls in ast.walk(scope):
                if isinstance(cls, ast.ClassDef):
                    in_class.update(id(n) for n in ast.walk(cls))
            nodes = [n for n in ast.walk(scope) if id(n) not in in_class]
        acquires = [n for n in nodes if _pool_method(n, "acquire")]
        if not acquires:
            return
        releases = any(_pool_method(n, r)
                       for n in nodes for r in _RELEASERS)
        if releases:
            return
        where = (f"class {scope.name}" if isinstance(scope, ast.ClassDef)
                 else "module scope")
        for node in acquires:
            yield module.finding(
                node, self.id,
                f"pool.acquire takes a page reference but {where} never "
                f"calls free/release_request — the reference (and its "
                f"physical slot at refcount>0) leaks")

    # ------------------------------------- 2. shared handles are immutable
    def _check_shared_mutation(self, module: Module,
                               fn: ast.AST) -> Iterator[Finding]:
        shared: dict = {}
        copy_lines: List[int] = [
            n.lineno for n in ast.walk(fn)
            if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "copy_page"]
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _pool_method(node.value, "acquire") \
                    and _shared_kwarg(node.value):
                shared[node.targets[0].id] = node.lineno
        if not shared:
            return
        for node in ast.walk(fn):
            target: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                target = node.targets[0] if len(node.targets) == 1 else None
            elif isinstance(node, ast.AugAssign):
                target = node.target
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id in shared
                    and target.attr not in _SAFE_SHARED_ATTRS):
                continue
            acquired_at = shared[target.value.id]
            if any(acquired_at < line <= node.lineno
                   for line in copy_lines):
                continue
            yield module.finding(
                node, self.id,
                f"'{target.value.id}' was acquired shared=True; writing "
                f"'.{target.attr}' mutates a page every holder shares — "
                f"take a private copy_page first")

    # ------------------------------------------ 3. free on held pages
    def _check_free_held(self, module: Module,
                         fn: ast.AST) -> Iterator[Finding]:
        held_lists: Set[str] = set()
        held_pages: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name, value = node.targets[0].id, node.value
                if _pool_method(value, "request_pages"):
                    held_lists.add(name)
                elif isinstance(value, ast.Subscript):
                    if isinstance(value.value, ast.Name) \
                            and value.value.id in held_lists:
                        held_pages.add(name)
                    elif _pool_method(value.value, "request_pages"):
                        held_pages.add(name)
            elif isinstance(node, ast.For) \
                    and isinstance(node.target, ast.Name):
                it = node.iter
                if (isinstance(it, ast.Name) and it.id in held_lists) \
                        or _pool_method(it, "request_pages"):
                    held_pages.add(node.target.id)
        if not held_pages:
            return
        for node in ast.walk(fn):
            if not _pool_method(node, "free") or not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Attribute) and arg.attr == "page_id" \
                    and isinstance(arg.value, ast.Name) \
                    and arg.value.id in held_pages:
                yield module.finding(
                    node, self.id,
                    f"pool.free on '{arg.value.id}' obtained from "
                    f"request_pages — the page is still in the pool's "
                    f"sequence table; drop the request's ownership with "
                    f"release_request instead")
