"""Declarative parameter definitions of the port (``repro/models/common.py``).

The port's parameters are plain ``nn.Module`` tensors, one per layer.  Their
declarations are ``ArrayDef`` trees keyed as the JAX package's parameter
tree is (nested dicts; a layer stack's leaves carry a leading ``layers``
axis): shape, per-dimension *logical axis* names (resolved to mesh axes by
``repro_torch.dist.sharding``) and dtype.  From them:

* ``abstract_params``  -- tensors on the ``meta`` device (no allocation),
* ``param_pspecs``     -- a ``PartitionSpec`` per leaf, resolved on the
  stacked shape exactly as the reference resolves it,
* ``param_shardings``  -- per port tensor (``layers.3.attn.wq``), its DTensor
  placements and the layer range a rank holds,
* ``sharded_bytes``    -- the bytes one device holds under those specs,
* ``count_params`` / ``tree_bytes``.

``LEAF_AXES`` holds the reference's declarations (``rmsnorm_defs``,
``attention_defs``, ``mlp_defs``, ``moe_defs``, ``ssm_defs``, ``mlstm_defs``,
``slstm_defs``, ``embed_defs``, ``lm_head_defs`` and the adapters), keyed by
the block and leaf names of a path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch

from ..dist.sharding import (PartitionSpec, Rules, _axis_sizes, entry_axes,
                             local_block, logical_to_pspec, mesh_coordinate,
                             spec_shards, to_placements)

Tree = Any


@dataclasses.dataclass(frozen=True)
class ArrayDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def nbytes(self) -> int:
        return numel(self.shape) * self.dtype.itemsize


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` over every leaf of a nested dict, keeping its keys."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, paths joined by ``/`` as JAX's tree
    paths are, keys sorted at every level as JAX flattens a dict."""
    if not isinstance(tree, Mapping):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from flatten(tree[key], f"{prefix}/{key}" if prefix else key)


# ------------------------------------------------ the reference's axes
_ATTN = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
_MLP = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed")}
_SSM = {"w_z": ("embed", "d_inner"), "w_x": ("embed", "d_inner"),
        "w_B": ("embed", None), "w_C": ("embed", None),
        "w_dt": ("embed", "ssm_heads"), "dt_bias": ("ssm_heads",),
        "a_log": ("ssm_heads",), "D": ("ssm_heads",),
        "conv_x": ("conv", "d_inner"), "norm": ("d_inner",),
        "w_out": ("d_inner", "embed")}
_MLSTM = {"w_up": ("embed", "d_inner"), "w_z": ("embed", "d_inner"),
          "w_q": ("d_inner", None), "w_k": ("d_inner", None),
          "w_v": ("d_inner", None), "w_i": ("d_inner", None),
          "w_f": ("d_inner", None), "b_i": (None,), "b_f": (None,),
          "norm": ("d_inner",), "w_down": ("d_inner", "embed")}
_SLSTM = {**{f"{w}_{g}": axes for g in "ifzo" for w, axes in
             (("w", ("embed", None, None)), ("r", (None, None, None)),
              ("b", (None, None)))},
          "norm": ("embed",), "w_ff1": ("embed", "mlp"),
          "w_ff2": ("mlp", "embed")}
LEAF_AXES = {"attn": _ATTN, "xattn": _ATTN, "mlp": _MLP, "ssm": _SSM,
             "mlstm": _MLSTM, "slstm": _SLSTM,
             "embed": {"tok": ("vocab", "embed")},
             "head": {"w": ("embed", "vocab")},
             "vision_adapter": {"w": ("embed", "embed")},
             "audio_adapter": {"w": ("embed", "embed")}}


def moe_axes(parallelism: str) -> Dict[str, Tuple[Optional[str], ...]]:
    """``moe_defs``'s axes: experts over ``model`` under ep, the FFN width
    over ``model`` under tp."""
    ea = "experts" if parallelism == "ep" else None
    ma = None if parallelism == "ep" else "mlp"
    return {"router": ("embed", None), "w_gate": (ea, "embed", ma),
            "w_up": (ea, "embed", ma), "w_down": (ea, ma, "embed")}


def leaf_axes(path: str, moe_parallelism: str = "tp"
              ) -> Tuple[Optional[str], ...]:
    """The logical axes of one per-layer leaf of the JAX tree's ``path``
    (``layers/attn/wq``), without the stack's ``layers`` axis."""
    parts = path.split("/")
    block, leaf = parts[-2], parts[-1]
    if leaf == "scale":                         # every rmsnorm
        return ("embed",)
    table = moe_axes(moe_parallelism) if block == "moe" else LEAF_AXES.get(
        block)
    if table is None or leaf not in table:
        raise KeyError(f"no logical axes declared for {path!r}")
    return table[leaf]


def module_defs(named: Mapping[str, torch.Tensor],
                moe_parallelism: str = "tp") -> Tree:
    """The ``ArrayDef`` tree of a port model's state-dict-named tensors,
    keyed by the JAX tree's paths: a layer stack's tensors become one leaf
    of shape (n_layers, ...) with a leading ``layers`` axis."""
    from ..convert import jax_path     # convert imports the models package

    leaves: Dict[str, ArrayDef] = {}
    layers: Dict[str, int] = {}
    for name, t in named.items():
        path, layer = jax_path(name)
        axes = leaf_axes(path, moe_parallelism)
        leaves[path] = ArrayDef(tuple(t.shape), axes, t.dtype)
        if layer is not None:
            layers[path] = max(layers.get(path, 0), layer + 1)
    tree: Dict = {}
    for path, d in leaves.items():
        if path in layers:
            d = ArrayDef((layers[path],) + d.shape, ("layers",) + d.axes,
                         d.dtype)
        cur = tree
        parts = path.split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = d
    return tree


# --------------------------------------------------------- materialise
def abstract_params(defs: Tree) -> Tree:
    """Tensors of each leaf's shape and dtype on the ``meta`` device."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def param_pspecs(defs: Tree, mesh, rules: Optional[Rules] = None) -> Tree:
    return tree_map(lambda d: logical_to_pspec(d.axes, d.shape, mesh, rules),
                    defs)


def tree_bytes(defs: Tree) -> int:
    return sum(d.nbytes for _, d in flatten(defs))


def count_params(defs: Tree) -> int:
    return sum(numel(d.shape) for _, d in flatten(defs))


def sharded_bytes(defs: Tree, mesh, rules: Optional[Rules] = None,
                  dtype: Optional[torch.dtype] = None) -> int:
    """The bytes one device holds of ``defs`` under their specs on
    ``mesh``: each leaf's bytes over the ways its spec splits it (the
    resolver only shards dims that divide evenly).  ``dtype`` overrides
    every leaf's (the f32 moments of bf16 parameters)."""
    total = 0
    for _, d in flatten(defs):
        spec = logical_to_pspec(d.axes, d.shape, mesh, rules)
        item = (dtype or d.dtype).itemsize
        total += numel(d.shape) * item // spec_shards(spec, mesh)
    return total


# ------------------------------------------------------------ shardings
@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """How one port tensor lies on a ``DeviceMesh``: ``spec`` is the
    per-layer tensor's (the stack's ``layers`` entry taken off), and a
    stacked leaf whose ``layers`` dim is split over ``layer_axes`` is held
    only by the ranks whose block of layers holds ``layer``.  No DTensor
    placement says "held by some ranks only", so ``place`` gives such a
    leaf as a plain tensor of the rank's block."""

    mesh: Any
    spec: PartitionSpec
    layer: Optional[int] = None
    n_layers: int = 0
    layer_axes: Tuple[str, ...] = ()

    @property
    def placements(self) -> Tuple:
        return to_placements(self.spec, self.mesh, len(self.spec))

    def layer_range(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """[lo, hi) of the stack's layers this rank holds."""
        sizes = _axis_sizes(self.mesh)
        coord = mesh_coordinate(self.mesh, rank)
        parts, idx = 1, 0
        for a in self.layer_axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        step = self.n_layers // parts if self.n_layers else 0
        return idx * step, (idx + 1) * step

    @property
    def layer_split(self) -> bool:
        """Do the ranks hold different layers of the stack?"""
        sizes = _axis_sizes(self.mesh)
        return self.layer is not None and numel(
            [sizes[a] for a in self.layer_axes]) > 1

    def holds(self, rank: Optional[int] = None) -> bool:
        if self.layer is None:
            return True
        lo, hi = self.layer_range(rank)
        return lo <= self.layer < hi

    def local(self, full: torch.Tensor) -> Optional[torch.Tensor]:
        """This rank's block of ``full`` (None when it holds no block)."""
        if not self.holds():
            return None
        return local_block(full, self.spec, self.mesh)

    def place(self, full: torch.Tensor):
        """``full`` as a ``DTensor`` on the mesh from this rank's block
        (no communication: every rank holds ``full``); None when this rank
        holds no block.  A layer-split leaf comes back as the plain tensor
        of the block: a DTensor collective on it would wait for the ranks
        that hold other layers."""
        from torch.distributed.tensor import DTensor

        block = self.local(full)
        if block is None:
            return None
        if self.mesh.device_type == "cuda":
            block = block.cuda()          # the rank's current card
        if self.layer_split:
            return block
        return DTensor.from_local(block, self.mesh, self.placements,
                                  run_check=False, shape=full.shape,
                                  stride=full.contiguous().stride())


def param_shardings(defs: Tree, mesh, rules: Optional[Rules] = None,
                    names=None) -> Dict[str, LeafSharding]:
    """Per port tensor name (``layers.3.attn.wq``, ``embed.tok``), its
    ``LeafSharding`` on ``mesh``, resolved on the stacked shape as the
    reference resolves it.  ``names`` restricts the result to those tensor
    names (default: every tensor the defs declare)."""
    out: Dict[str, LeafSharding] = {}
    for path, d in flatten(defs):
        spec = logical_to_pspec(d.axes, d.shape, mesh, rules)
        stacked = d.axes[:1] == ("layers",)
        parts = path.split("/")
        if not stacked:
            out[".".join(parts)] = LeafSharding(mesh, spec)
            continue
        per_layer = PartitionSpec(*tuple(spec)[1:])
        for i in range(d.shape[0]):
            name = ".".join([parts[0], str(i)] + parts[1:])
            out[name] = LeafSharding(mesh, per_layer, i, d.shape[0],
                                     entry_axes(spec[0]))
    if names is not None:
        missing = set(names) - set(out)
        if missing:
            raise KeyError(f"no declaration for {sorted(missing)[:4]}")
        out = {n: out[n] for n in names}
    return out
