"""Expert parallelism over a process group, on the CPU: gloo groups of 2
and 4 ranks, each rank a subprocess (``_torch_ep_worker.py``) joined
through a ``FileStore`` under the test's temporary directory, each with
its own time limit, so a stuck rendezvous fails its test and nothing
else.  One run per world size computes every case; the tests read it.

- ``ragged_all_to_all`` == its all-gather oracle == a ground truth built
  with numpy, with a rank that sends nothing and one that receives
  nothing; its gradient is the exchange back.
- The ep layer (``moe`` with ``parallelism="ep"`` under the group) ==
  the flat dropless layer of one process, bit for bit on every rank: a
  token's rows and their combine order are the same in both.
- Within ep, batched == chunked == per-token, bit for bit.
- One token: two experts get rows, the other ranks' experts none.
- Gradients, as every rank computes them: x's and the router's equal
  the flat layer's, and so do a rank's own experts' weights.
- An ep group that does not divide the padded experts raises.
- A ``Model`` with ``moe_parallelism="ep"`` gives one process's logits,
  and on every rank the gradients of its loss: each attention, norm,
  embedding, head and router leaf whole, each expert stack on the rank's
  own experts.
"""

import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_ep_worker import (D, a2a_plan, case_inputs, ep_cfg, ep_model,
                              model_gradients)
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.models.moe import _moe_dropless

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLDS = (2, 4)
RANK_TIMEOUT = 240          # seconds for one rank's whole run


def run_ranks(world, tmp):
    """Run ``world`` ranks to the end in ``tmp``; each rank's saved
    results.  A rank's output goes to a file (a full pipe could stall it
    inside a collective)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_ep_worker.py"),
         os.path.join(tmp, "store"), str(world), str(r), tmp], env=env,
        stdout=log, stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            assert p.returncode == 0, f"rank {r} of {world}:\n{f.read()}"
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


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


@pytest.mark.parametrize("world", WORLDS)
def test_ep_model_gradients_equal_one_process(world, ranks):
    """Training under ep needs no sum over the ranks: the MoE layer's
    backward hands the layers around it x's whole gradient on every
    rank, so every leaf outside the expert stacks gets the gradient of
    one process, and the router its whole one."""
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
                assert close(got[name][mine], g[mine]), (r, name)
            else:
                assert close(got[name], g), (r, name)
