"""SPMD01 — collectives bound to a group (``repro/check/rules/spmd01.py``,
restated for ``torch.distributed``).

The JAX rule holds every collective inside ``shard_map`` to an axis the
mesh binds.  The port's collectives take a process group instead, and go
through one module, ``dist/collectives.py``, whose ``_issued`` adds each
to the records ``count_collectives`` holds open: the dry run, the cost
walk and the tests read those counts.  Three checks, resolution-gated (a
site the rule cannot resolve is skipped, not guessed at):

(a) *Counted collectives*: outside ``dist/collectives.py``, no call of a
    raw ``torch.distributed`` collective or point-to-point op
    (``all_reduce``, ``all_gather*``, ``reduce_scatter*``,
    ``all_to_all*``, ``broadcast*``, ``reduce``, ``gather``, ``scatter``,
    ``send``/``recv``/``isend``/``irecv``, ``batch_isend_irecv``,
    ``P2POp``): the counts would not see it.  Process-group plumbing
    (``get_world_size``, ``get_rank``, ``get_global_rank``, ``new_group``,
    ``init_process_group``, ``barrier``) is not a collective.
(b) *Bound groups*: inside it, every such call names its group —
    ``group=`` (not the literal None), or ``P2POp``'s fourth argument.
    Leaving it out runs on the world group: the torch form of an unbound
    axis name.  ``batch_isend_irecv`` takes its groups from its ops.
(c) *Perm coverage*: a peer passed to ``isend``/``irecv``/``send``/
    ``recv``/``P2POp`` — or to a module-local helper's parameter that
    reaches one — written as rank arithmetic must be a rotation
    ``(r ± k) % n``: ``r ± k`` alone leaves the ring's ends without a
    peer.  A literal ``perm=`` list of (source, destination) pairs must be
    a permutation, as the JAX rule checks ``ppermute``'s, and the
    rotation idiom ``[(j, (j ± k) % n) for j in range(n)]`` covers.

Only files in the port's scope (``rules/_port.py``) are read.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set

from .. import callgraph
from ..registry import Module, Rule, register
from ..report import Finding
from ._port import in_port

_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "all_gather_coalesced",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
                "all_to_all_single", "broadcast", "broadcast_object_list",
                "reduce", "gather", "gather_object", "scatter",
                "scatter_object_list", "send", "recv", "isend", "irecv",
                "batch_isend_irecv", "P2POp"}
# op -> (index of its positional peer argument, its peer keywords).
_PEER = {"send": (1, ("dst", "group_dst")), "isend": (1, ("dst",
                                                          "group_dst")),
         "recv": (1, ("src", "group_src")), "irecv": (1, ("src",
                                                          "group_src")),
         "P2POp": (2, ("peer", "group_peer"))}


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _dist_op(call: ast.Call, module: Module) -> Optional[str]:
    qn = module.imports.qualname(call.func) or ""
    parts = qn.split(".")
    if len(parts) == 3 and parts[:2] == ["torch", "distributed"] and \
            parts[2] in _COLLECTIVES:
        return parts[2]
    return None


def _is_collectives_module(path: str) -> bool:
    return os.path.normpath(path).split(os.sep)[-2:] == ["dist",
                                                         "collectives.py"]


def _peer_arg(call: ast.Call, op: str) -> Optional[ast.expr]:
    idx, names = _PEER[op]
    for name in names:
        got = _kwarg(call, name)
        if got is not None:
            return got
    return call.args[idx] if len(call.args) > idx else None


def _names_group(call: ast.Call, op: str) -> bool:
    group = _kwarg(call, "group")
    if group is None and op == "P2POp" and len(call.args) > 3:
        group = call.args[3]
    return group is not None and not (isinstance(group, ast.Constant)
                                      and group.value is None)


def _rank_arithmetic(node: ast.expr) -> Optional[bool]:
    """True for a rotation ``(x ± k) % n``, False for bare ``x ± k``,
    None for anything else (a name, a call: unresolved)."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod) and \
            isinstance(node.left, ast.BinOp) and \
            isinstance(node.left.op, (ast.Add, ast.Sub)):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add,
                                                            ast.Sub)):
        return False
    return None


def _peer_params(module: Module) -> Dict[str, List[int]]:
    """Module-local function -> the positional indices of its parameters
    that reach a p2p op's peer slot (as the name, or a call's only
    argument: ``g(frm)``)."""
    out: Dict[str, List[int]] = {}
    for name, fn in module.functions.items():
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        hits: Set[int] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            op = _dist_op(node, module)
            if op not in _PEER:
                continue
            peer = _peer_arg(node, op)
            if isinstance(peer, ast.Call) and len(peer.args) == 1:
                peer = peer.args[0]
            if isinstance(peer, ast.Name) and peer.id in params:
                hits.add(params.index(peer.id))
        if hits:
            out[name] = sorted(hits)
    return out


def _rotation_comprehension(expr: ast.expr) -> bool:
    """[(j, f(j)) for j in range(n)] — covers every source once."""
    if not isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
        return False
    if len(expr.generators) != 1:
        return False
    gen = expr.generators[0]
    over_range = (isinstance(gen.iter, ast.Call)
                  and isinstance(gen.iter.func, ast.Name)
                  and gen.iter.func.id == "range")
    if not (over_range and isinstance(gen.target, ast.Name)):
        return False
    elt = expr.elt
    return (isinstance(elt, ast.Tuple) and len(elt.elts) == 2
            and isinstance(elt.elts[0], ast.Name)
            and elt.elts[0].id == gen.target.id)


@register
class Spmd01(Rule):
    id = "SPMD01"
    title = ("torch.distributed collective outside dist/collectives.py "
             "(uncounted), without a group, or with a peer/perm that does "
             "not cover the ring")

    def check(self, module: Module) -> Iterator[Finding]:
        if not in_port(module.path):
            return
        home = _is_collectives_module(module.path)
        peer_params = _peer_params(module)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            op = _dist_op(node, module)
            if op is not None and not home:
                yield module.finding(
                    node, self.id,
                    f"raw torch.distributed.{op} outside "
                    f"dist/collectives.py — count_collectives never sees "
                    f"it; call the counted wrapper there")
            elif op is not None and op != "batch_isend_irecv" and \
                    not _names_group(node, op):
                yield module.finding(
                    node, self.id,
                    f"torch.distributed.{op} names no group — it runs on "
                    f"the world group, not the mesh group the caller "
                    f"meant; pass group=")
            peers: List[ast.expr] = []
            if op in _PEER:
                peer = _peer_arg(node, op)
                if peer is not None:
                    peers.append(peer)
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in peer_params:
                fn = module.functions[node.func.id]
                params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
                for i in peer_params[node.func.id]:
                    got = (node.args[i] if i < len(node.args)
                           else _kwarg(node, params[i]))
                    if got is not None:
                        peers.append(got)
            for peer in peers:
                if _rank_arithmetic(peer) is False:
                    yield module.finding(
                        peer, self.id,
                        "peer rank written as 'r ± k' without '% n' — the "
                        "ring's end ranks address a peer that does not "
                        "exist; use the rotation (r ± k) % n")
            perm = _kwarg(node, "perm")
            if perm is not None:
                yield from self._check_perm(module, node, perm)

    def _check_perm(self, module: Module, call: ast.Call,
                    perm: ast.expr) -> Iterator[Finding]:
        if isinstance(perm, ast.Name):
            scope = callgraph.enclosing(
                call, module.parents,
                (ast.FunctionDef, ast.AsyncFunctionDef))
            perm = callgraph.resolve_assignment(
                perm.id, scope, module.tree)
        if perm is None or _rotation_comprehension(perm):
            return
        if not isinstance(perm, (ast.List, ast.Tuple)):
            return
        pairs: List[tuple] = []
        for e in perm.elts:
            if not (isinstance(e, ast.Tuple) and len(e.elts) == 2
                    and all(isinstance(x, ast.Constant)
                            and isinstance(x.value, int)
                            for x in e.elts)):
                return                 # not fully literal: stay silent
            pairs.append((e.elts[0].value, e.elts[1].value))
        if not pairs:
            return
        srcs = [s for s, _ in pairs]
        dsts = [d for _, d in pairs]
        if len(set(srcs)) != len(srcs):
            yield module.finding(
                call, self.id,
                f"perm has duplicate sources "
                f"{sorted(s for s in set(srcs) if srcs.count(s) > 1)} — "
                f"two payloads race into one receive buffer")
            return
        if len(set(dsts)) != len(dsts):
            yield module.finding(
                call, self.id,
                f"perm has duplicate destinations "
                f"{sorted(d for d in set(dsts) if dsts.count(d) > 1)} — "
                f"one rank receives twice, another's data is dropped")
            return
        missing = sorted(set(range(max(srcs) + 1)) - set(srcs))
        if missing:
            yield module.finding(
                call, self.id,
                f"perm covers sources {sorted(set(srcs))} but skips "
                f"{missing} — uncovered ranks never send")
