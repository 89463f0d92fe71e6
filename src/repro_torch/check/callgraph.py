"""Import-aware name resolution and the module-local call graph (the
port's copy of ``repro/check/callgraph.py``).

Rules reason about *which library function* an AST call hits, so names
must resolve through the module's import aliases (``np.random.rand`` ->
``numpy.random.rand`` whatever numpy was imported as; ``dist.all_reduce``
-> ``torch.distributed.all_reduce``).  The call graph is deliberately
module-local: a rule walking from an autograd ``forward`` follows calls to
functions defined in the same file and stops at module boundaries —
best-effort by design, the whole-tree sweep catches each module from its
own entries.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set


class Imports:
    """Local name -> dotted origin, from the module's import statements."""

    def __init__(self) -> None:
        self.aliases: Dict[str, str] = {}

    @classmethod
    def of(cls, tree: ast.Module) -> "Imports":
        out = cls()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        out.aliases[a.asname] = a.name
                    else:
                        # ``import os.path`` binds the top package name.
                        top = a.name.split(".")[0]
                        out.aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    out.aliases[a.asname or a.name] = (
                        f"{mod}.{a.name}" if mod else a.name)
        return out

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Best-effort dotted name of an attribute chain.

        The root resolves through the import table when it can; otherwise
        the bare chain is returned (``self.pool.acquire``) so rules can
        still pattern-match on suffixes.  Non-name roots (calls,
        subscripts) resolve to None.
        """
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))


def local_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """Every (possibly nested) function definition in the module, by bare
    name.  On collisions the first definition wins — enough for the
    helper-lookup the rules do."""
    out: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def called_names(fn: ast.AST) -> Set[str]:
    """Bare names referenced as callables or passed by name inside ``fn``
    (higher-order uses like ``torch.utils.checkpoint.checkpoint(body,
    ...)`` count: the callee runs inside the same step)."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                names.add(node.func.id)
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    names.add(arg.id)
    return names


def reachable(entries: Iterable[ast.AST],
              funcs: Dict[str, ast.FunctionDef]) -> List[ast.AST]:
    """BFS over the module-local call graph from the given entry bodies.

    Returns the entries plus every module-local function transitively
    referenced from them, each node once, in first-seen order.
    """
    seen: Set[int] = set()
    order: List[ast.AST] = []
    queue: List[ast.AST] = list(entries)
    while queue:
        fn = queue.pop(0)
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        order.append(fn)
        for name in sorted(called_names(fn)):
            callee = funcs.get(name)
            if callee is not None and id(callee) not in seen:
                queue.append(callee)
    return order


def parent_map(tree: ast.Module) -> Dict[ast.AST, ast.AST]:
    """Child -> parent links (ast doesn't carry them natively)."""
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing(node: ast.AST, parents: Dict[ast.AST, ast.AST],
              kinds) -> Optional[ast.AST]:
    """Nearest ancestor of one of the given AST types, or None."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = parents.get(cur)
    return None


def resolve_str(name: str, *scopes: ast.AST) -> Optional[str]:
    """Resolve ``name`` to a string constant via a single plain assignment
    in any of the given scopes (innermost first)."""
    for scope in scopes:
        if scope is None:
            continue
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if (isinstance(t, ast.Name) and t.id == name
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    return node.value.value
    return None


def resolve_assignment(name: str, *scopes: ast.AST) -> Optional[ast.expr]:
    """The value expression of ``name``'s single plain assignment in the
    given scopes (innermost first), or None if absent/ambiguous."""
    for scope in scopes:
        if scope is None:
            continue
        found: List[ast.expr] = []
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and t.id == name:
                    found.append(node.value)
        if len(found) == 1:
            return found[0]
        if found:
            return None               # ambiguous: refuse to guess
    return None
