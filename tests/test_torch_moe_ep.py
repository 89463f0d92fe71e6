"""Expert parallelism over a mesh's model axis, on the CPU: gloo groups of
2 and 4 ranks (``_torch_gloo.run_ranks``), each rank a subprocess
(``_torch_ep_worker.py``) running the layer under
``use_mesh(make_test_mesh(data=1, model=n, device="cpu"))``, so every rank
holds the whole batch.  One run per world size computes every case; the
tests read it.

- ``ragged_all_to_all`` == its all-gather oracle == a ground truth built
  with numpy, with a rank that sends nothing and one that receives
  nothing; its gradient is the exchange back.
- The ep layer (``moe`` with ``parallelism="ep"`` under the mesh) ==
  the flat dropless layer of one process, bit for bit on every rank: a
  token's rows and their combine order are the same in both.
- Within ep, batched == chunked == per-token, bit for bit.
- One token: two experts get rows, the other ranks' experts none.
- Gradients, as every rank computes them: x's and the router's equal
  the flat layer's, and so do a rank's own experts' weights.
- An ep group that does not divide the padded experts raises.
- The model's cases run in float64 (weights drawn in f32) with the f32
  islands widened (``_torch_tp_worker.wide``): under a model axis its
  attention is tensor-parallel, and one process's f32 sums in another
  order would stand between the two.
- A ``Model`` with ``moe_parallelism="ep"``, on the rank's blocks
  (``Model.shard_``), gives one process's logits, and on every rank its
  blocks of one process's gradients: each norm and router leaf whole, the
  attention and the vocab on the rank's heads and rows (tensor
  parallelism), each expert stack on the rank's own experts.
- The same model in f32, the card's dtype, on rules that split only the
  experts (``EP_ONLY``): one process's f32 logits and gradients within
  1e-5 on every rank.
- The model's backward run on another thread (as autograd runs a CUDA
  backward) with remat on: the recomputed MoE layers see the mesh and
  take the forward's layout, ep under (1, n) and per-row under (n, 1);
  the gradients equal the calling thread's, bit for bit.
"""

import functools
import types

import numpy as np
import pytest
import torch

from _torch_ep_worker import (D, a2a_plan, case_inputs, ep_cfg, ep_model,
                              model_gradients)
from _torch_gloo import run_ranks as run_worker
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_worker import wide
from repro_torch.models.moe import _moe_dropless

WORLDS = (2, 4)


def run_ranks(world, tmp):
    """Every rank's saved results of ``_torch_ep_worker.py``."""
    return run_worker("_torch_ep_worker.py", world, tmp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(world)``: every rank's results, one run per world size."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = run_ranks(
                world, str(tmp_path_factory.mktemp(f"ep{world}")))
        return done[world]

    return get


@functools.lru_cache(maxsize=None)
def flat_case():
    """The single-process flat dropless layer on the workers' inputs."""
    cfg = ep_cfg()
    p, x = case_inputs(1, (2, 9, D), cfg)
    y = _moe_dropless(p, x, cfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in vars(p).items()}
    xt = x.clone().requires_grad_(True)
    proj = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    yy = _moe_dropless(types.SimpleNamespace(**leaves), xt, cfg)
    grads = torch.autograd.grad((yy * proj).sum(), [xt, *leaves.values()])
    return cfg, p, x, y, dict(zip(["x", *leaves], grads))


def close(a, b, tol=1e-5):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) <= tol * scale


@pytest.mark.parametrize("world", WORLDS)
def test_ragged_all_to_all_equals_oracle_and_numpy(world, ranks):
    send, rows = a2a_plan(world)
    for r, res in enumerate(ranks(world)):
        want = torch.cat([rows[j][int(send[j, :r].sum()):
                                  int(send[j, :r + 1].sum())]
                          for j in range(world)])
        assert torch.equal(res["a2a"], want)
        assert torch.equal(res["a2a_reference"], want)
        assert (res["a2a"][:, 1] == r).all()
        # The gradient is dout (10 * row + 1) sent back: each row's own.
        assert torch.equal(res["a2a_grad"], rows[r] * 10 + 1)
    assert ranks(world)[world - 1]["a2a"].shape[0] == 0
    assert ranks(world)[0]["a2a_grad"].shape[0] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_ep_layer_equals_flat_dropless(world, ranks):
    _, _, _, y, _ = flat_case()
    for res in ranks(world):
        assert torch.equal(res["ep"], y)


@pytest.mark.parametrize("world", WORLDS)
def test_ep_batched_equals_chunked_equals_per_token(world, ranks):
    for res in ranks(world):
        assert torch.equal(res["ep_chunked"], res["ep"])
        assert torch.equal(res["ep_per_token"], res["ep"])


@pytest.mark.parametrize("world", WORLDS)
def test_ep_ranks_whose_experts_get_no_rows(world, ranks):
    """One token routes to 2 of 8 experts, so at least world - 2 ranks'
    experts receive nothing; the layer still equals flat dropless."""
    cfg, p, x, _, _ = flat_case()
    want = _moe_dropless(p, x[:1, :1], cfg)
    for res in ranks(world):
        assert torch.equal(res["ep_one_token"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_ep_gradients_equal_flat(world, ranks):
    cfg, _, _, _, flat = flat_case()
    E_loc = cfg.padded_experts // world
    for r, res in enumerate(ranks(world)):
        g = res["grads"]
        assert close(g["x"], flat["x"]) and close(g["router"],
                                                  flat["router"])
        for name in ("w_gate", "w_up", "w_down"):
            mine = slice(r * E_loc, (r + 1) * E_loc)
            assert close(g[name][mine], flat[name][mine]), (r, name)


@pytest.mark.parametrize("world", WORLDS)
def test_ep_refusals(world, ranks):
    for res in ranks(world):
        assert "ep mesh mismatch" in res["mismatch"]


@functools.lru_cache(maxsize=None)
def one_process_model():
    """The workers' model, logits and loss gradients in one process (ep
    without a group is the flat dropless layer)."""
    with wide():
        model, tokens, batch = ep_model()
        with torch.no_grad():
            logits = model(tokens)
        return model.cfg, logits, model_gradients(model, batch)


@pytest.mark.parametrize("world", WORLDS)
def test_ep_model_equals_one_process(world, ranks):
    _, want, _ = one_process_model()
    for res in ranks(world):
        assert close(res["model"], want)
    assert np.isfinite(want.numpy()).all()


def rank_block(cfg, name, g, world, r):
    """Rank r's block of one process's whole gradient ``g`` of ``name``
    on the (1, world) mesh the workers shard the model on."""
    from repro_torch.dist import abstract_mesh
    from repro_torch.models import Model

    mesh = abstract_mesh((1, world), ("data", "model"))
    return Model(cfg, device="meta").local_params(mesh, {name: g},
                                                  rank=r)[name]


@pytest.mark.parametrize("world", WORLDS)
def test_ep_model_gradients_equal_one_process(world, ranks):
    """Training under ep needs no sum over the ranks: the MoE layer's
    backward hands the layers around it x's whole gradient on every
    rank, so every leaf outside the expert stacks gets its block of one
    process's gradient (whole where it is not split: the norms, the
    router; the rank's heads and vocab rows under tensor parallelism),
    and each expert stack its rank's experts'."""
    cfg, _, want = one_process_model()
    E_loc = cfg.moe_ep_axis_size * -(-cfg.n_experts // cfg.moe_ep_axis_size
                                     ) // world
    experts = ("moe.w_gate", "moe.w_up", "moe.w_down")
    for r, res in enumerate(ranks(world)):
        got = res["model_grads"]
        assert set(got) == set(want)
        for name, g in want.items():
            if name.endswith(experts):
                mine = slice(r * E_loc, (r + 1) * E_loc)
                assert close(got[name], g[mine]), (r, name)
            else:
                assert close(got[name], rank_block(cfg, name, g, world, r)),\
                    (r, name)


@pytest.mark.parametrize("world", WORLDS)
def test_ep_model_f32_equals_one_process(world, ranks):
    """In f32, the card's dtype, on rules that split only the experts
    (``EP_ONLY``: attention, the vocab and the FFN width whole on every
    rank): the logits, and on every rank each leaf's gradient, within 1e-5
    of one process's f32 model, each expert stack on the rank's own
    experts."""
    model, tokens, batch = ep_model(torch.float32)
    with torch.no_grad():
        logits = model(tokens)
    want = model_gradients(model, batch)
    cfg = model.cfg
    E_loc = cfg.moe_ep_axis_size * -(-cfg.n_experts // cfg.moe_ep_axis_size
                                     ) // world
    experts = ("moe.w_gate", "moe.w_up", "moe.w_down")
    for r, res in enumerate(ranks(world)):
        assert close(res["model_f32"], logits), r
        got = res["model_grads_f32"]
        assert set(got) == set(want)
        for name, g in want.items():
            if name.endswith(experts):
                g = g[r * E_loc:(r + 1) * E_loc]
            assert close(got[name], g), (r, name)
    assert np.isfinite(logits.numpy()).all()


@pytest.mark.parametrize("world", WORLDS)
def test_remat_backward_on_another_thread_keeps_the_layout(world, ranks):
    """The ambient mesh is process-wide: a backward on another thread
    recomputes each checkpointed MoE layer in the forward's layout (ep,
    then per-row), so its gradients are the calling thread's bitwise;
    the per-row model's are one process's within 1e-5 of the leaf's
    largest entry."""
    _, _, want = one_process_model()
    for r, res in enumerate(ranks(world)):
        for key, base in (("model_thread", "model_grads"),
                          ("per_row_thread", "per_row_grads")):
            got = res[key]
            assert "error" not in got, (r, key, got.get("error"))
            assert got["grads"].keys() == res[base].keys()
            for name, g in res[base].items():
                assert torch.equal(got["grads"][name], g), (r, key, name)
        for name, g in want.items():
            assert close(res["per_row_grads"][name], g), (r, name)
