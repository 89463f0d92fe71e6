"""Logical-axis sharding rules of the port (``repro/dist/sharding.py``).

Model code names tensor dimensions *logically* (``batch``, ``kv_heads``,
``mlp``, ...).  A ruleset maps each logical name to one mesh axis (str),
one joint axis group (tuple), or None; ``logical_to_pspec`` resolves the
names of one tensor against a mesh, with the reference's invariants:

* axes the mesh lacks are dropped from the group, so ``batch -> ("pod",
  "data")`` spans both data-parallel axes on a multi-pod mesh and
  degrades to ``data`` alone on one pod;
* a mesh axis is consumed by at most one dimension of the tensor;
* a dimension is sharded only if its size divides by the product of the
  remaining axes' sizes: trailing axes are shed until it divides, and the
  dimension replicates when none fit (the GQA fallback).

A mesh is anything with axis names and sizes: the port's ``AbstractMesh``
(a frozen name -> size mapping, no processes) or a
``torch.distributed.device_mesh.DeviceMesh`` built with
``mesh_dim_names``.  ``use_mesh`` installs the ambient mesh (the port's
``with mesh:``) and ``active_mesh`` returns it.

``to_placements`` turns a spec into DTensor placements, one per mesh dim.
A joint entry such as ``("pod", "data")`` shards one tensor dim over two
mesh dims; JAX takes the tuple's order as major to minor and DTensor shards
in mesh-dim order, so the two agree when the mesh lists ``pod`` before
``data``, as ``launch.mesh.make_production_mesh`` does.  ``local_block``
cuts a rank's block of a full tensor in DTensor's order and raises on a
joint entry whose order is not the mesh's.

``constrain`` is the port's counterpart of the reference's annotation.
The reference's GSPMD partitions whole tensors by it; the port's model
computes on each rank's local blocks, with its tensor-parallel collectives
issued explicitly through ``dist.collectives`` (``copy_to_group``,
``reduce_from_group``).  So ``constrain`` moves nothing: outside a mesh it
is the identity, and under one it checks that the local tensor has the
block shape its logical names resolve to against the whole sizes it is
given, and raises on any other layout.  ``TPLayout`` is what a model
records when its parameters become a rank's blocks and hands its layers:
the model group, the rank and the whole sizes.  ``model_group``,
``axis_group`` and ``data_groups`` are the process groups a spec's axes
name: the tensor-parallel group, any one axis's, and the data-parallel
groups of ``batch_data_axes``.
On an ``AbstractMesh`` they are ``AbstractGroup``s, a size and no
processes, on which the collectives only record what they would move (the
dry run's per-device walk).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

# logical name -> mesh axis (str), axis group (tuple, applied jointly), or
# None (never shard).  Names absent from the ruleset replicate.
RuleValue = Optional[object]  # None | str | Tuple[str, ...]
Rules = Dict[str, RuleValue]

DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "head_dim": None,
    "qdh": None,
    "layers": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "d_inner": "model",
    "ssm_heads": "model",
}

# FSDP-style parameter layout: weights also shard their non-TP dim over the
# data axis.
FSDP_RULES: Rules = {**DEFAULT_RULES, "embed": "data"}

# Optimizer moments follow the FSDP parameter layout.
MOMENTS_RULES: Rules = {**FSDP_RULES}

# Decode: batch on data alone, heads on model.
DECODE_RULES: Rules = {**DEFAULT_RULES, "batch": "data"}

# Sequence-parallel decode: the KV sequence over the model axis.
SP_DECODE_RULES: Rules = {**DECODE_RULES, "kv_seq": "model",
                          "kv_heads": None}


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names sharded jointly (major to minor).  Equal entry by entry to the
    JAX package's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, in mesh-dim order, with no processes behind
    them: what the rule resolver and the dry run need."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} vs sizes "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_shapes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(axis_names), tuple(int(s) for s in axis_shapes))


def _axis_sizes(mesh) -> Dict[str, int]:
    """Name -> size of an ``AbstractMesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve "
                         "logical axes")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def mesh_sizes(mesh) -> Dict[str, int]:
    """Name -> size of a mesh; empty for None (no mesh)."""
    return {} if mesh is None else _axis_sizes(mesh)


# Process-global, not thread-local: on the card autograd runs the
# backward, and checkpoint's recomputation with it, on its own device
# thread, which must see the mesh and rules the forward ran under.
_STACKS: Dict[str, List] = {"rules": [], "mesh": []}


@contextlib.contextmanager
def use_rules(rules: Rules) -> Iterator[Rules]:
    """Make ``rules`` the ambient ruleset for
    ``logical_to_pspec(..., rules=None)`` within the block."""
    stack = _STACKS["rules"]
    stack.append(rules)
    try:
        yield rules
    finally:
        stack.pop()


def active_rules() -> Rules:
    stack = _STACKS["rules"]
    return stack[-1] if stack else DEFAULT_RULES


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Install ``mesh`` as the ambient mesh within the block (the port's
    ``with mesh:``).  Model code reads it through ``active_mesh``."""
    stack = _STACKS["mesh"]
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def active_mesh():
    """The mesh installed by ``use_mesh``, or None outside any."""
    stack = _STACKS["mesh"]
    return stack[-1] if stack else None


def _shed_until_divisible(axes, axis_sizes, size) -> List[str]:
    """Drop trailing axes until ``size`` divides the product of the rest;
    shedding everything replicates (the GQA fallback).  Shared by
    ``logical_to_pspec`` and ``batch_data_axes``."""
    axes = list(axes)
    while axes:
        total = 1
        for a in axes:
            total *= axis_sizes[a]
        if total > 0 and size % total == 0:
            break
        axes.pop()
    return axes


def logical_to_pspec(names: Sequence[Optional[str]], sizes: Sequence[int],
                     mesh, rules: Optional[Rules] = None) -> PartitionSpec:
    """Resolve logical dimension names to a ``PartitionSpec`` on ``mesh``.
    ``names[i]`` may be None (always replicated); ``rules=None`` uses the
    ambient ruleset, else ``DEFAULT_RULES``."""
    if len(names) != len(sizes):
        raise ValueError("names and sizes must have equal length")
    if rules is None:
        rules = active_rules()
    axis_sizes = _axis_sizes(mesh)
    used: set = set()
    entries = []
    for name, size in zip(names, sizes):
        value = rules.get(name) if name is not None else None
        if value is None:
            axes = []
        elif isinstance(value, str):
            axes = [value]
        else:
            axes = list(value)
        axes = [a for a in axes if a in axis_sizes and a not in used]
        axes = _shed_until_divisible(axes, axis_sizes, size)
        used.update(axes)
        entries.append(
            tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return PartitionSpec(*entries)


def batch_data_axes(mesh, size: Optional[int] = None) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (``pod`` + ``data`` when present)
    that can shard a dimension of ``size``, shed as ``logical_to_pspec``
    sheds; ``size=None`` skips the divisibility check."""
    sizes = _axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    if size is not None:
        axes = _shed_until_divisible(axes, sizes, size)
    return tuple(axes)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]],
              whole: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """The port's sharding annotation: the identity outside a mesh; under
    one, ``x`` must be the local block that ``names`` resolve to on the
    ambient mesh and rules, each named dim's whole size read from
    ``whole`` (a dim without a name, or whose name has no size there, is
    not checked).  A wrong layout raises; nothing is moved."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if len(names) != x.dim():
        raise ValueError(f"constrain: {len(names)} names for a "
                         f"{x.dim()}-dim tensor")
    known = whole or {}
    sizes = [known.get(n, x.shape[i]) if n is not None else x.shape[i]
             for i, n in enumerate(names)]
    spec = logical_to_pspec(names, sizes, mesh)
    ways = _axis_sizes(mesh)
    for i, (name, n) in enumerate(zip(names, sizes)):
        if name not in known:
            continue
        shards = 1
        for a in entry_axes(spec[i]):
            shards *= ways[a]
        if x.shape[i] != n // shards:
            raise ValueError(
                f"constrain: a local tensor of shape {tuple(x.shape)} where "
                f"{tuple(names)} of whole sizes {tuple(sizes)} resolve to "
                f"{spec}: dim {i} ({name}) should hold {n // shards}")
    return x


@dataclasses.dataclass(frozen=True)
class AbstractGroup:
    """The ranks along ``axes`` of an ``AbstractMesh``: a size and no
    processes.  A collective on it records itself and moves no data."""

    axes: Tuple[str, ...]
    size: int


def _group(mesh, axis: str):
    if isinstance(mesh, AbstractMesh):
        return AbstractGroup((axis,), mesh.shape[axis])
    return mesh.get_group(axis)


def axis_group(mesh, axis: str):
    """The group of mesh axis ``axis``, or None when ``mesh`` has no such
    axis of more than one rank."""
    if mesh_sizes(mesh).get(axis, 1) <= 1:
        return None
    return _group(mesh, axis)


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 on an ``AbstractMesh``, whose
    walk reads shapes only, and without the axis)."""
    if mesh is None or isinstance(mesh, AbstractMesh):
        return 0
    return mesh_coordinate(mesh).get(axis, 0)


def model_group(mesh=None):
    """The tensor-parallel group (the ``model`` axis) of ``mesh`` (default:
    the ambient one), or None when it has no ``model`` axis of more than
    one rank: then the layers run their meshless code."""
    return axis_group(active_mesh() if mesh is None else mesh, "model")


def model_rank(mesh=None) -> int:
    """This rank's index along ``model``."""
    return axis_rank(active_mesh() if mesh is None else mesh, "model")


def data_groups(mesh=None) -> List:
    """The data-parallel groups of ``mesh`` (default: the ambient one):
    one a data axis of ``batch_data_axes`` with more than one rank, in
    mesh order (``pod`` before ``data``).  Summing over each in turn sums
    over every data rank, in a fixed order."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None:
        return []
    sizes = mesh_sizes(mesh)
    return [_group(mesh, a) for a in batch_data_axes(mesh) if sizes[a] > 1]


def data_ways(mesh) -> int:
    """How many ranks the data axes of ``mesh`` hold (1 without a
    mesh): the global batch over a rank's block of it."""
    sizes = mesh_sizes(mesh)
    ways = 1
    for a in batch_data_axes(mesh) if mesh is not None else ():
        ways *= sizes[a]
    return ways


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """A model's tensor-parallel layout, recorded once when its parameters
    are cut into a rank's blocks (``Model.shard_``) and handed to the
    layers: the model group (None: no ``model`` axis of more than one
    rank), this rank's index on it, and each logical axis's whole size
    (``heads`` -> H) with the mesh and rules that split it.  ``NO_TP`` is
    the meshless layout, under which every layer runs its meshless code."""

    group: Any = None
    rank: int = 0
    sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)
    mesh: Any = None
    rules: Optional[Rules] = None

    def over(self, name: str, size: Optional[int] = None):
        """The model group when the rules split logical axis ``name`` (of
        ``size``, default its whole size) over it, else None."""
        if self.group is None:
            return None
        spec = logical_to_pspec((name,), (self.sizes[name] if size is None
                                          else size,), self.mesh, self.rules)
        return self.group if "model" in entry_axes(spec[0]) else None


NO_TP = TPLayout()


def tp_layout(sizes: Mapping[str, int], mesh,
              rules: Optional[Rules] = None) -> TPLayout:
    """The layout of a model whose logical axes have the whole ``sizes``
    on ``mesh`` under ``rules`` (default: the ambient ones)."""
    group = model_group(mesh)
    if group is None:
        return TPLayout(sizes=dict(sizes))
    return TPLayout(group, model_rank(mesh), dict(sizes), mesh,
                    active_rules() if rules is None else rules)


def batch_pspec(mesh) -> PartitionSpec:
    """Dim 0 over the data-parallel axes of ``mesh``: how the data
    pipeline places host batches."""
    axes = batch_data_axes(mesh)
    if not axes:
        return PartitionSpec()
    return PartitionSpec(axes if len(axes) > 1 else axes[0])


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Sequence, mesh, ndim: int) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on the mesh dims named in tensor dim d's entry,
    ``Replicate()`` elsewhere.  A spec shorter than ``ndim`` replicates the
    trailing dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(_axis_sizes(mesh))
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the "
                         f"tensor's {ndim} dims")
    out: List = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"joint entry {axes} is not in the mesh's dim "
                             f"order {names}; DTensor would shard it minor "
                             f"to major")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def mesh_coordinate(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """This rank's index along every axis of a ``DeviceMesh`` (or of
    ``rank`` in an ``AbstractMesh``, laid out row-major)."""
    if isinstance(mesh, AbstractMesh):
        if rank is None:
            raise ValueError("an AbstractMesh has no rank of its own")
        coord = {}
        for name, size in reversed(list(mesh.shape.items())):
            coord[name] = rank % size
            rank //= size
        return {n: coord[n] for n in mesh.axis_names}
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def spec_block(spec: Sequence, shape: Sequence[int], sizes: Mapping[str, int],
               coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slices of the block that mesh coordinate ``coord`` holds of a
    tensor of ``shape`` under ``spec``: each dim split evenly over its
    entry's axes, major to minor."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = entry_axes(entry)
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {axes}")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_block(full: torch.Tensor, spec: Sequence, mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a copy): the block
    ``DTensor`` keeps on this rank for ``to_placements(spec, ...)``."""
    to_placements(spec, mesh, full.dim())          # the order check
    sl = spec_block(spec, full.shape, _axis_sizes(mesh),
                    mesh_coordinate(mesh, rank))
    return full[sl].clone()


def spec_shards(spec: Sequence, mesh) -> int:
    """How many ways ``spec`` splits a tensor on ``mesh``: the product of
    the sizes of the axes it names."""
    sizes = _axis_sizes(mesh)
    n = 1
    for entry in spec:
        for a in entry_axes(entry):
            n *= sizes[a]
    return n
