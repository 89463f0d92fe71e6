"""The port's meshes on the CPU: a gloo group of 4 ranks
(``_torch_dist_worker.py``'s ``mesh`` suite, one run for the file), and the
JAX package on fake XLA devices in one subprocess (its outputs in an
``.npz``).

- A joint ``("pod", "data")`` entry places each rank's block where the
  JAX package's ``addressable_shards`` put it: on a (2, 2, 2) mesh (eight
  ranks of a fake process group in this process) and on a (2, 2, 1) gloo
  mesh.
- ``moe`` with ep under ``make_test_mesh(data=2, model=2)`` equals one
  process's flat layer on each rank's data block, the output bit for bit
  and x's and the router's gradients within 1e-5; within ep, batched ==
  chunked == per-token; ranks whose experts get no rows; the
  "ep mesh mismatch" refusal from ``moe`` and from the ``Engine``.
- Under ``(data=4, model=1)`` with tp the layer runs per row, equals the
  flat layer bit for bit and issues no collective.
- The mesh ep layer against the JAX mesh ep layer on the same inputs
  (the reference's ``test_ep_dropless_parity_and_chunking_invariance_on_
  mesh``), to its tolerance, 1e-4.
"""

import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_dist_worker import (BATCH, D, biased, layer_grads, layer_inputs,
                                moe_cfg, projection)
from _torch_gloo import run_jax, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.models.moe import _moe_dropless

JAX_SCRIPT = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.dist.sharding import logical_to_pspec
from repro.models.moe import MoEConfig, moe

out = {}
devs = np.array(jax.devices())
full = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
for tag, shape in (("222", (2, 2, 2)), ("221", (2, 2, 1))):
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape),
                ("pod", "data", "model"))
    spec = logical_to_pspec(("batch", None, "mlp"), full.shape, mesh)
    arr = jax.device_put(full, NamedSharding(mesh, spec))
    for shard in arr.addressable_shards:
        coord = np.argwhere(mesh.devices == shard.device)[0]
        out["blk%s_%s" % (tag, "".join(map(str, coord)))] = np.asarray(
            shard.data)

cfg = MoEConfig(d_model=32, d_ff=48, n_experts=6, top_k=2,
                parallelism="ep", ep_axis_size=4)
inp = dict(np.load(INPUTS))
p = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up", "w_down")}
x = jnp.asarray(inp["x"])
mesh = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
with mesh:
    out["y"] = np.asarray(jax.jit(lambda xx: moe(p, xx, cfg))(x))
    gx, gp = jax.jit(jax.grad(lambda xx, pp: moe(pp, xx, cfg).sum(),
                              argnums=(0, 1)))(x, p)
out["gx"], out["grouter"] = np.asarray(gx), np.asarray(gp["router"])
np.savez(OUT, **out)
"""

FULL = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)


def jax_inputs():
    """The JAX mesh ep test's layer (d 32, f 48, 8 padded experts) and
    input, from a seeded numpy generator, f32."""
    rng = np.random.default_rng(2)

    def w(*s):
        return (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)

    return {"router": w(32, 8), "w_gate": w(8, 32, 48),
            "w_up": w(8, 32, 48), "w_down": w(8, 48, 32),
            "x": rng.normal(size=(2, 12, 32)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, the JAX outputs): the gloo group and the
    JAX subprocess run side by side."""
    tmp = str(tmp_path_factory.mktemp("mesh4"))
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **jax_inputs())
    with ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_jax, f"INPUTS = {path!r}\n" + JAX_SCRIPT,
                              tmp, 8)
        ranks = run_ranks("_torch_dist_worker.py", 4, tmp, "mesh", path)
        return ranks, jax_run.result()


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_out(runs):
    return runs[1]


def coord(r):
    """(data, model) of rank r of ``make_test_mesh(data=2, model=2)``."""
    return divmod(r, 2)


def flat_block(r, p=None):
    """The flat layer of one process on rank r's data block, and its
    gradients against the rank's projection."""
    cfg = moe_cfg()
    p0, x = layer_inputs(1, (BATCH, 9, D), cfg)
    c = coord(r)[0]
    xb = x[c * BATCH // 2:(c + 1) * BATCH // 2]
    return cfg, xb, layer_grads(
        lambda q, t: _moe_dropless(q, t, cfg, per_row=False), p or p0, xb,
        projection(xb.shape, 2 + c))


def test_joint_axis_blocks_on_2x2x2_match_jax(jax_out):
    """Eight ranks of a fake process group: each one's DTensor block, and
    ``local_block`` on the DeviceMesh and on the AbstractMesh, equal the
    JAX block of its coordinate (exact)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist import abstract_mesh, logical_to_pspec
    from repro_torch.dist.sharding import (local_block, mesh_coordinate,
                                           to_placements)

    names = ("pod", "data", "model")
    amesh = abstract_mesh((2, 2, 2), names)
    spec = logical_to_pspec(("batch", None, "mlp"), FULL.shape, amesh)
    assert spec == (("pod", "data"), None, "model")
    for r in range(8):
        dist.init_process_group("fake", rank=r, world_size=8,
                                store=FakeStore())
        try:
            mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=names)
            c = mesh_coordinate(mesh)
            want = jax_out["blk222_" + "".join(str(c[a]) for a in names)]
            got = distribute_tensor(FULL, mesh,
                                    to_placements(spec, mesh, 3),
                                    src_data_rank=None).to_local()
            assert np.array_equal(got.numpy(), want), r
            assert torch.equal(local_block(FULL, spec, mesh), got)
            assert torch.equal(local_block(FULL, spec, amesh, rank=r), got)
        finally:
            dist.destroy_process_group()


def test_joint_axis_out_of_mesh_order_refused():
    from repro_torch.dist import abstract_mesh
    from repro_torch.dist.sharding import local_block

    mesh = abstract_mesh((2, 2), ("pod", "data"))
    with pytest.raises(ValueError, match="mesh's dim order"):
        local_block(FULL, (("data", "pod"),), mesh, rank=0)


def test_joint_axis_blocks_on_gloo_2x2x1_match_jax(ranks, jax_out):
    for r, res in enumerate(ranks):
        assert res["joint_spec"] == (("pod", "data"), None, "model")
        c = res["joint_coord"]
        want = jax_out["blk221_%d%d%d" % (c["pod"], c["data"], c["model"])]
        for key in ("joint_block", "joint_dtensor", "joint_place"):
            assert np.array_equal(res[key].numpy(), want), (r, key)


def close(got, want, tol=1e-5):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_ep_2x2_equals_flat_on_each_block(ranks):
    """The output bit for bit.  x's and the router's gradients, and a
    rank's own experts' weight gradients, within 1e-5 of the largest
    entry, as ``test_torch_moe_ep.py`` holds them: the router's gradient
    sums the model group's slices, and x's comes through whole-tensor
    products over the slice's rows, so both round differently from the
    flat layer's (by an ulp)."""
    for r, res in enumerate(ranks):
        assert res["data_sharded_2x2"]
        cfg, _, (y, g) = flat_block(r)
        assert torch.equal(res["ep"], y), r
        for name in ("x", "router"):
            assert close(res["grads"][name], g[name]), (r, name)
        E_loc = cfg.padded_experts // 2
        mine = slice(coord(r)[1] * E_loc, (coord(r)[1] + 1) * E_loc)
        for name in ("w_gate", "w_up", "w_down"):
            assert close(res["grads"][name][mine], g[name][mine]), (r, name)


def test_ep_2x2_batched_equals_chunked_and_per_token(ranks):
    for res in ranks:
        assert torch.equal(res["ep_chunked"], res["ep"])
        assert torch.equal(res["ep_per_token"], res["ep"])


def test_ep_2x2_empty_expert_shards(ranks):
    """Only experts 0 and 1 get rows: the second model rank's experts
    receive nothing, and the layer still equals flat dropless (exact)."""
    for r, res in enumerate(ranks):
        cfg = moe_cfg()
        p, x = layer_inputs(1, (BATCH, 9, D), cfg)
        c = coord(r)[0]
        want = _moe_dropless(biased(p), x[c * 2:(c + 1) * 2], cfg,
                             per_row=False)
        assert torch.equal(res["ep_empty"], want), r


@pytest.mark.parametrize("where", ["moe", "engine"])
def test_ep_mesh_mismatch_raises(ranks, where):
    for res in ranks:
        assert "ep mesh mismatch" in res[f"mismatch_{where}"]


def test_per_row_under_data_mesh_issues_no_collective(ranks):
    """tp under a (4, 1) mesh: the per-row layout on each rank's row,
    equal to the flat layer bit for bit, with no collective at all."""
    cfg = moe_cfg(parallelism="tp", n_experts=8)
    p, x = layer_inputs(5, (BATCH, 9, D), cfg)
    for r, res in enumerate(ranks):
        assert res["data_sharded_4x1"]
        want = _moe_dropless(p, x[r:r + 1], cfg, per_row=False)
        assert torch.equal(res["per_row"], want), r
        assert all(v["count"] == 0 and v["bytes"] == 0
                   for v in res["per_row_collectives"].values())


def test_ep_2x2_matches_jax_mesh_ep(ranks, jax_out):
    """Each rank's block of the output and of x's gradient (of the
    output's sum) within 1e-4 of the JAX mesh ep's; the router's
    gradient summed over the data ranks within 1e-4 of JAX's (scaled by
    the largest entry)."""
    router = torch.zeros(jax_out["grouter"].shape)
    for r, res in enumerate(ranks):
        c, m = coord(r)
        y, g = res["jax_case"]
        np.testing.assert_allclose(y.numpy(), jax_out["y"][c:c + 1],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["x"].numpy(), jax_out["gx"][c:c + 1],
                                   rtol=1e-4, atol=1e-4)
        if m == 0:
            router += g["router"]
    want = jax_out["grouter"]
    assert np.abs(router.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_meshless_ep_is_flat():
    """Without a mesh ``moe`` with ep is the flat layer (no process group
    is needed)."""
    from repro_torch.models.moe import moe

    cfg = moe_cfg(d=32, f=48)
    inp = {k: torch.from_numpy(v) for k, v in jax_inputs().items()}
    x = inp.pop("x")
    p = types.SimpleNamespace(**inp)
    assert torch.equal(moe(p, x, cfg), _moe_dropless(p, x, cfg,
                                                      per_row=False))
