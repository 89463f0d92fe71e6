"""One rank of the ep tests (``test_torch_moe_ep.py``): joins a gloo group
through a ``FileStore``, runs every case on the CPU (the MoE layer and the
model under ``use_mesh(make_test_mesh(data=1, model=world))``, the model
again under ``(world, 1)``: the per-row layout) and saves what it got to
``<out>/rank<r>.pt``.  The parent builds the same inputs from the same
seeds (``case_inputs``, ``a2a_plan``) and holds the ranks' results against
its own single-process ones.

    python tests/_torch_ep_worker.py STORE_FILE WORLD RANK OUT_DIR
"""

import os
import sys
import threading
import types

import numpy as np
import torch

D, FF = 96, 64          # granite's smoke widths


def ep_cfg(n_experts=6, ep_axis_size=4):
    from repro_torch.models.moe import MoEConfig

    return MoEConfig(d_model=D, d_ff=FF, n_experts=n_experts, top_k=2,
                     parallelism="ep", ep_axis_size=ep_axis_size)


def case_inputs(seed, shape, cfg):
    """Layer weights (full expert stacks) and input rows from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    E = cfg.padded_experts

    def w(*s):
        return torch.randn(s, generator=g) / s[-2] ** 0.5

    p = types.SimpleNamespace(router=w(D, E), w_gate=w(E, D, FF),
                              w_up=w(E, D, FF), w_down=w(E, FF, D))
    return p, torch.randn(shape, generator=g)


def a2a_plan(world, seed=0):
    """(send matrix, rows of each rank): ``send[i][j]`` rows go from rank
    i to rank j.  Rank 0 sends nothing and the last rank receives
    nothing; row values name their source, destination and index."""
    rng = np.random.default_rng(seed + world)
    send = rng.integers(0, 5, (world, world))
    send[0, :] = 0
    send[:, world - 1] = 0
    send[1, 0] = 3                   # someone sends to rank 0
    rows = []
    for i in range(world):
        r = [[i, j, n] for j in range(world) for n in range(send[i, j])]
        rows.append(torch.tensor(r, dtype=torch.float32).reshape(-1, 3))
    return send, rows


# The rules of the f32 model case: only the experts split over the model
# axis; attention, the vocab and the FFN width stay whole on every rank.
EP_ONLY = {"heads": None, "kv_heads": None, "vocab": None, "mlp": None}


def ep_model(dtype=torch.float64):
    """The smoke granite MoE with ep over 4 padded experts a rank group,
    and a loss batch from fixed seeds.  Its weights are drawn in f32 and
    held in ``dtype``.  The float64 cases run with the f32 islands widened
    (``_torch_tp_worker.wide``), since under a model axis its attention is
    tensor-parallel, whose f32 sums in another order would stand between
    the ranks and one process; the f32 case runs on ``EP_ONLY``."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke("granite_moe_3b_a800m"),
                              dtype=dtype, moe_parallelism="ep",
                              moe_ep_axis_size=4)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    model.to(dtype)
    tokens = torch.randint(1, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(4))
    labels = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(5))
    return model, tokens, {"tokens": tokens, "labels": labels}


def model_gradients(model, batch):
    """Every leaf's gradient of the model's loss, by name."""
    params = {n: t.requires_grad_(True)
              for n, t in model.named_parameters()}
    grads = torch.autograd.grad(model.loss(batch), list(params.values()))
    return dict(zip(params, grads))


def thread_gradients(model, batch):
    """``model_gradients`` with the backward run on another thread, as
    autograd runs a CUDA backward, and remat's recomputation in it, on its
    device thread: {"grads": ...} or {"error": what the thread raised}."""
    params = {n: t.requires_grad_(True)
              for n, t in model.named_parameters()}
    loss = model.loss(batch)
    got = {}

    def work():
        try:
            grads = torch.autograd.grad(loss, list(params.values()))
            got["grads"] = dict(zip(params, grads))
        # check: disable=EXC01 -- recorded for the test, which shows it
        except Exception as e:
            got["error"] = repr(e)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    return got


def run(world, rank):
    from _torch_tp_worker import wide
    from repro_torch.dist import (ragged_all_to_all,
                                  ragged_all_to_all_reference, use_mesh)
    from repro_torch.launch.mesh import make_test_mesh

    out = {}
    send, rows = a2a_plan(world)
    mine = rows[rank].requires_grad_(True)
    got = ragged_all_to_all(mine, send[rank], send[:, rank])
    out["a2a"] = got.detach()
    out["a2a_reference"] = ragged_all_to_all_reference(
        rows[rank], send[rank], send[:, rank])
    dout = got.detach() * 10 + 1
    (out["a2a_grad"],) = torch.autograd.grad(got, mine, dout)

    with use_mesh(make_test_mesh(data=1, model=world, device="cpu")):
        out.update(run_mesh())
    # No model axis: the data-sharded mesh takes the per-row layout.
    with use_mesh(make_test_mesh(data=world, model=1, device="cpu")), \
            wide():
        model, _, batch = ep_model()
        out["per_row_grads"] = model_gradients(model, batch)
        out["per_row_thread"] = thread_gradients(model, batch)
    return out


def run_mesh():
    """The layer's and the model's cases under the ambient mesh."""
    from _torch_tp_worker import wide
    from repro_torch.dist.sharding import DEFAULT_RULES, use_rules
    from repro_torch.models.moe import moe

    out = {}
    cfg = ep_cfg()
    p, x = case_inputs(1, (2, 9, D), cfg)
    out["ep"] = moe(p, x, cfg)
    out["ep_chunked"] = torch.cat([moe(p, x[:, i:i + 4], cfg)
                                   for i in range(0, 9, 4)], dim=1)
    out["ep_per_token"] = torch.cat([moe(p, x[:, i:i + 1], cfg)
                                     for i in range(9)], dim=1)
    one = x[:1, :1]                       # one token: 2 experts get rows
    out["ep_one_token"] = moe(p, one, cfg)

    # Gradients: every rank computes the same loss from the whole output.
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in vars(p).items()}
    xt = x.clone().requires_grad_(True)
    proj = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    y = moe(types.SimpleNamespace(**leaves), xt, cfg)
    grads = torch.autograd.grad((y * proj).sum(), [xt, *leaves.values()])
    out["grads"] = dict(zip(["x", *leaves], grads))

    try:
        moe(p, x, ep_cfg(n_experts=3, ep_axis_size=3))
    except ValueError as e:
        out["mismatch"] = str(e)

    with wide():
        model, tokens, batch = ep_model()
        model.shard_()                # the rank's blocks under the mesh
        with torch.no_grad():
            out["model"] = model(tokens)
        out["model_grads"] = model_gradients(model, batch)
        out["model_thread"] = thread_gradients(model, batch)

    # f32, the card's dtype, with only the experts split.
    with use_rules({**DEFAULT_RULES, **EP_ONLY}):
        model, tokens, batch = ep_model(torch.float32)
        model.shard_()
        with torch.no_grad():
            out["model_f32"] = model(tokens)
        out["model_grads_f32"] = model_gradients(model, batch)
    return out


def main():
    from _torch_gloo import join_group

    store_file, world, rank, out_dir = sys.argv[1:]
    world, rank = int(world), int(rank)
    import torch.distributed as dist

    join_group(store_file, world, rank)
    try:
        out = run(world, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
