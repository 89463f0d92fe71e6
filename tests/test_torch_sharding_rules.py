"""The port's logical-axis rules (``repro_torch.dist.sharding``) and
parameter, cache and input declarations (``models.common``,
``Model.param_defs``/``cache_defs``/``input_specs``) against the JAX
package's, on abstract meshes (names and sizes, no devices).

- ``logical_to_pspec`` equals the reference's for every rule set, on
  hypothesis-drawn names, sizes and meshes of 1-3 axes of sizes 1-16
  (the GQA fallback and ``batch`` over ``pod`` + ``data`` among them);
  the reference's invariant tests, counterpart for counterpart.
- ``param_defs()``, ``cache_defs()`` and ``input_specs()`` equal the
  reference's leaf for leaf (shapes, axes, dtypes) for all ten configs at
  the published widths, built on ``meta``.
- The per-device bytes of the parameters, the zero1 moments and every
  shape's cache on both production meshes equal the reference's, from its
  ``param_pspecs`` on its ``abstract_mesh`` (exact).
"""

import functools

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import dist as rdist  # noqa: E402
from repro.configs import ARCHS, get as ref_get  # noqa: E402
from repro.launch.dryrun import build_cell as ref_build_cell  # noqa: E402
from repro.models import SHAPES as REF_SHAPES, build_model  # noqa: E402
from repro.models.common import ArrayDef as RefDef  # noqa: E402
from repro.models.common import param_pspecs as ref_pspecs  # noqa: E402
from repro_torch import dist as tdist  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.launch.dryrun import cell_rules  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import SHAPES, Model  # noqa: E402
from repro_torch.models.common import flatten, sharded_bytes  # noqa: E402

RULESETS = ("DEFAULT_RULES", "FSDP_RULES", "MOMENTS_RULES", "DECODE_RULES",
            "SP_DECODE_RULES")
LOGICAL = sorted(tdist.DEFAULT_RULES)
MESH = tdist.abstract_mesh((2, 4), ("data", "model"))

dims = st.lists(st.tuples(st.sampled_from(LOGICAL + [None]),
                          st.integers(1, 64)), min_size=1, max_size=5)
meshes = st.lists(st.integers(1, 16), min_size=1, max_size=3).flatmap(
    lambda sizes: st.tuples(st.just(tuple(sizes)), st.sampled_from(
        [names for names in (("pod", "data", "model"), ("data", "model"),
                             ("pod", "model"), ("data",), ("model",),
                             ("pod", "data"), ("pod",))
         if len(names) == len(sizes)])))


def test_rule_sets_equal_the_reference():
    for name in RULESETS:
        assert getattr(tdist, name) == getattr(rdist, name), name


@settings(max_examples=300, deadline=None)
@given(dims=dims, mesh=meshes, ruleset=st.sampled_from(RULESETS))
def test_logical_to_pspec_equals_reference(dims, mesh, ruleset):
    sizes, names = mesh
    lnames = [d[0] for d in dims]
    lsizes = [d[1] for d in dims]
    got = tdist.logical_to_pspec(lnames, lsizes,
                                 tdist.abstract_mesh(sizes, names),
                                 getattr(tdist, ruleset))
    want = rdist.logical_to_pspec(lnames, lsizes,
                                  rdist.abstract_mesh(sizes, names),
                                  getattr(rdist, ruleset))
    assert tuple(got) == tuple(want)
    assert got == want


@settings(max_examples=200, deadline=None)
@given(dims=dims, ruleset=st.sampled_from(RULESETS))
def test_pspec_invariants(dims, ruleset):
    names = [d[0] for d in dims]
    sizes = [d[1] for d in dims]
    spec = tdist.logical_to_pspec(names, sizes, MESH,
                                  getattr(tdist, ruleset))
    assert len(spec) == len(dims)
    used = []
    for entry, size in zip(spec, sizes):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            assert a in MESH.axis_names
            assert a not in used, "mesh axis reused across dims"
            used.append(a)
            total *= MESH.shape[a]
        assert size % total == 0, "non-divisible dim was sharded"


@settings(max_examples=100, deadline=None)
@given(dims=dims)
def test_none_names_never_shard(dims):
    spec = tdist.logical_to_pspec([None] * len(dims), [d[1] for d in dims],
                                  MESH, tdist.DEFAULT_RULES)
    assert all(e is None for e in spec)


def test_gqa_fallback_behaviour():
    spec = tdist.logical_to_pspec(("kv_heads",), (8,), MESH,
                                  tdist.DEFAULT_RULES)
    assert spec == tdist.PartitionSpec("model")
    mesh8 = tdist.abstract_mesh((1, 8), ("data", "model"))
    spec = tdist.logical_to_pspec(("kv_heads",), (4,), mesh8,
                                  tdist.DEFAULT_RULES)
    assert spec == tdist.PartitionSpec(None)


def test_batch_spans_pod_and_data_on_multipod():
    mesh = make_production_mesh(multi_pod=True)
    spec = tdist.logical_to_pspec(("batch", "seq"), (256, 4096), mesh,
                                  tdist.DEFAULT_RULES)
    assert spec == tdist.PartitionSpec(("pod", "data"), None)
    assert tdist.batch_pspec(mesh) == tdist.PartitionSpec(("pod", "data"))
    mesh1 = make_production_mesh(multi_pod=False)
    spec1 = tdist.logical_to_pspec(("batch", "seq"), (256, 4096), mesh1,
                                   tdist.DEFAULT_RULES)
    assert spec1 == tdist.PartitionSpec("data", None)


def test_use_rules_and_use_mesh_nest():
    assert tdist.active_mesh() is None
    with tdist.use_rules(tdist.DECODE_RULES), tdist.use_mesh(MESH):
        assert tdist.active_rules() is tdist.DECODE_RULES
        assert tdist.active_mesh() is MESH
        assert tdist.logical_to_pspec(("batch",), (4,), MESH) == ("data",)
    assert tdist.active_mesh() is None
    assert tdist.active_rules() is tdist.DEFAULT_RULES


# ------------------------------------------------------- declarations
def ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (RefDef,
                                               jax.ShapeDtypeStruct)))[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in leaves}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def models(arch):
    return build_model(ref_get(arch)), Model(get(arch), device="meta")


def same_leaves(ref, port, axes=True):
    ref, port = ref_flat(ref), dict(flatten(port))
    assert set(ref) == set(port)
    for k, r in ref.items():
        p = port[k]
        assert tuple(r.shape) == tuple(p.shape), k
        assert np.dtype(r.dtype).name == dtype_name(p.dtype), k
        if axes:
            assert tuple(r.axes) == tuple(p.axes), k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_equal_reference(arch):
    rm, pm = models(arch)
    same_leaves(rm.param_defs(), pm.param_defs())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_defs_and_input_specs_equal_reference(arch):
    rm, pm = models(arch)
    for name, sc in SHAPES.items():
        B, S = sc.global_batch, sc.seq_len
        same_leaves(rm.cache_defs(B, S), pm.cache_defs(B, S))
        same_leaves(rm.input_specs(REF_SHAPES[name]), pm.input_specs(sc),
                    axes=False)


def ref_sharded_bytes(defs, mesh, rules, itemsize=None):
    specs = ref_flat(ref_pspecs(defs, mesh, rules))
    total = 0
    for path, d in ref_flat(defs).items():
        ways = 1
        for entry in specs[path]:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                ways *= mesh.shape[a]
        size = itemsize or np.dtype(d.dtype).itemsize
        total += int(np.prod(d.shape)) * size // ways
    return total


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_per_device_bytes_equal_reference(arch, multi_pod):
    """Parameters and zero1 moments under the train rules, and the cache
    of every shape under its cell's rules (the dry run's), per device."""
    rm, pm = models(arch)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    rmesh = rdist.abstract_mesh(shape, names)
    tmesh = make_production_mesh(multi_pod=multi_pod)
    for profile in ("tp", "fsdp"):
        rules = cell_rules("train_4k", profile)
        moments = dict(rules, layers="data")
        pd = pm.param_defs()
        assert sharded_bytes(pd, tmesh, rules) == ref_sharded_bytes(
            rm.param_defs(), rmesh, rules)
        assert sharded_bytes(pd, tmesh, moments, dtype=torch.float32) == \
            ref_sharded_bytes(rm.param_defs(), rmesh, moments, itemsize=4)
    for name, sc in SHAPES.items():
        rules = cell_rules(name)
        B, S = sc.global_batch, sc.seq_len
        assert sharded_bytes(pm.cache_defs(B, S), tmesh, rules) == \
            ref_sharded_bytes(rm.cache_defs(B, S), rmesh, rules), name


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_cell_rules_are_the_reference_dry_runs(shape, profile):
    """The rules the port's dry run picks per shape are the ones the
    reference's ``build_cell`` returns."""
    mesh = rdist.abstract_mesh((1, 1), ("data", "model"))
    arch = "zamba2_7b" if shape == "long_500k" else "llama3_2_1b"
    want = ref_build_cell(arch, shape, mesh, quick_layers=1,
                          profile=profile)[-1]
    assert cell_rules(shape, profile) == want


@pytest.mark.parametrize("smoke", [False, True])
def test_shapes_and_cells_equal_reference(smoke):
    import dataclasses

    from repro.configs import LONG_CONTEXT_OK, shapes_for as ref_shapes_for
    from repro_torch import configs as tconfigs

    assert tconfigs.LONG_CONTEXT_OK == LONG_CONTEXT_OK
    for arch in ARCHS:
        got = tconfigs.shapes_for(arch, smoke=smoke)
        want = ref_shapes_for(arch, smoke=smoke)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == {
            k: dataclasses.astuple(v) for k, v in want.items()}, arch
