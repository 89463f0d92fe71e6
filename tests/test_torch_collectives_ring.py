"""The ring matmuls, the overlapped MLP and the collective counter on the
CPU: a gloo group of 4 ranks (``_torch_dist_worker.py``'s ``ring`` suite,
one run for the file) against the fused references, plain products, and
the JAX package's ring functions on 4 fake XLA devices (one subprocess).

- ``ring_allgather_matmul`` equals its all-gather reference bit for bit:
  each block product is the same product.
- ``ring_matmul_reducescatter`` is within 1e-5 of its reduce-scatter
  reference (the partial sums add in another order).
- Both equal the JAX ring functions' outputs at the reference test's
  tolerances (1e-5 and 1e-4).
- ``make_overlapped_mlp`` equals ``relu(x @ w1) @ w2`` with and without
  overlap; the overlapped variant records only ``send_recv`` hops (n - 1
  a ring, two rings), the plain one an ``all_gather`` and a
  ``reduce_scatter``: the counterpart of the reference's
  ``test_overlap_replaces_allgather_with_permutes``.
- A collective in a Python loop of 5 trips counts 5.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_gloo import run_jax, run_ranks

WORLD = 4

JAX_SCRIPT = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.collectives import (
    shard_map, ring_allgather_matmul, allgather_matmul_reference,
    ring_matmul_reducescatter, matmul_reducescatter_reference,
    make_overlapped_mlp)

inp = dict(np.load(INPUTS))
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
ag = jax.jit(shard_map(
    lambda x, w: (ring_allgather_matmul(x, w, "model"),
                  allgather_matmul_reference(x, w, "model")),
    mesh=mesh, in_specs=(P("model", None), P(None, "model")),
    out_specs=(P(None, "model"), P(None, "model"))))
rs = jax.jit(shard_map(
    lambda h, w: (ring_matmul_reducescatter(h, w, "model"),
                  matmul_reducescatter_reference(h, w, "model")),
    mesh=mesh, in_specs=(P(None, "model"), P("model", None)),
    out_specs=(P("model", None), P("model", None))))
out = {}
out["ring_ag"], out["ref_ag"] = map(np.asarray, ag(inp["x"], inp["w1"]))
out["ring_rs"], out["ref_rs"] = map(np.asarray, rs(inp["h"], inp["w2"]))
for overlap in (True, False):
    out["mlp_%s" % overlap] = np.asarray(make_overlapped_mlp(
        mesh, overlap=overlap)(inp["mlp_x"], inp["mlp_w1"], inp["mlp_w2"]))
np.savez(OUT, **out)
"""


def inputs():
    """The reference test's shapes, from a seeded numpy generator."""
    rng = np.random.default_rng(0)

    def n(*s):
        return rng.normal(size=s).astype(np.float32)

    return {"x": n(64, 32), "w1": n(32, 48), "w2": n(48, 32),
            "h": n(64, 48), "mlp_x": n(64, 32), "mlp_w1": n(32, 64),
            "mlp_w2": n(64, 32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring4"))
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **inputs())
    with ThreadPoolExecutor(2) as pool:        # side by side
        jax_run = pool.submit(run_jax, f"INPUTS = {path!r}\n" + JAX_SCRIPT,
                              tmp, WORLD)
        ranks = run_ranks("_torch_dist_worker.py", WORLD, tmp, "ring", path)
        return ranks, jax_run.result()


def rows(a, r):
    m = a.shape[0] // WORLD
    return a[r * m:(r + 1) * m]


def cols(a, r):
    m = a.shape[1] // WORLD
    return a[:, r * m:(r + 1) * m]


def test_ring_allgather_matmul_equals_reference_bitwise(runs):
    ranks, _ = runs
    inp = {k: torch.from_numpy(v) for k, v in inputs().items()}
    for r, res in enumerate(ranks):
        assert torch.equal(res["ring_ag"], res["ref_ag"]), r
        # Each block is the product of the chunk that came from its rank.
        for j in range(WORLD):
            want = torch.matmul(rows(inp["x"], j), cols(inp["w1"], r))
            assert torch.equal(rows(res["ring_ag"], j), want), (r, j)


def test_ring_matmul_reducescatter_within_1e5_of_reference(runs):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        got, want = res["ring_rs"], res["ref_rs"]
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), r


def test_rings_match_jax_rings(runs):
    ranks, jax_out = runs
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["ring_ag"].numpy(),
                                   cols(jax_out["ring_ag"], r),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["ring_rs"].numpy(),
                                   rows(jax_out["ring_rs"], r),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("overlap", [True, False])
def test_overlapped_mlp_equals_plain(runs, overlap):
    ranks, jax_out = runs
    inp = inputs()
    want = np.maximum(inp["mlp_x"] @ inp["mlp_w1"], 0) @ inp["mlp_w2"]
    for r, res in enumerate(ranks):
        got = res[f"mlp_{overlap}"].numpy()
        np.testing.assert_allclose(got, rows(want, r), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got, rows(jax_out[f"mlp_{overlap}"], r),
                                   rtol=1e-4, atol=1e-4)


def test_overlap_replaces_allgather_with_send_recv(runs):
    ranks, _ = runs
    for res in ranks:
        fused, plain = res["mlp_True_rec"], res["mlp_False_rec"]
        assert fused["send_recv"]["count"] == 2 * (WORLD - 1)
        assert fused["send_recv"]["max_group"] == WORLD
        assert all(v["count"] == 0 for k, v in fused.items()
                   if k != "send_recv")
        assert plain["all_gather"]["count"] == 1
        assert plain["reduce_scatter"]["count"] == 1
        assert plain["send_recv"]["count"] == 0


def test_collective_in_a_loop_counts_each_trip(runs):
    ranks, _ = runs
    for res in ranks:
        rec = res["loop_rec"]["all_reduce"]
        assert rec["count"] == 5 and rec["bytes"] == 5 * 3 * 4
