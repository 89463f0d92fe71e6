"""One rank of the port's mesh, ring, loader and elastic tests: joins a
gloo group through a ``FileStore`` (``_torch_gloo``), runs one suite of
cases on the CPU and saves what it got to ``<out>/rank<r>.pt``.  The tests
build the same inputs from the same seeds and hold the ranks' results
against single-process ones and against the JAX package's.

    python tests/_torch_dist_worker.py STORE WORLD RANK OUT_DIR SUITE [ARG]

Suites: ``mesh`` (world 4: the MoE layer's data x model layout, the
per-row choice, the joint-axis placement), ``ring`` (world 4: the ring
matmuls and the overlapped MLP against ``ARG``'s inputs), ``save``
(world 4: a checkpoint written from state placed on a 2 x 2 mesh, into
``ARG``) and ``restore`` (world 2: ``ShardedLoader``, the restore onto 1 x 2 from
``ARG`` and the zero1 moments' onto 2 x 1).
"""

import dataclasses
import os
import sys
import types

import numpy as np
import torch

D, FF = 96, 64          # granite's smoke widths
BATCH = 4               # the mesh suite's global batch
LOADER = (512, 16, 4, 3)  # vocab, seq, batch, seed of the loader case
TRAIN = (32, 4, 9)      # seq, batch, seed of the elastic training case


def moe_cfg(parallelism="ep", n_experts=6, ep_axis_size=4, d=D, f=FF):
    from repro_torch.models.moe import MoEConfig

    return MoEConfig(d_model=d, d_ff=f, n_experts=n_experts, top_k=2,
                     parallelism=parallelism, ep_axis_size=ep_axis_size)


def layer_inputs(seed, shape, cfg):
    """Layer weights (whole expert stacks) and input rows from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    E, d, f = cfg.padded_experts, cfg.d_model, cfg.d_ff

    def w(*s):
        return torch.randn(s, generator=g) / s[-2] ** 0.5

    p = types.SimpleNamespace(router=w(d, E), w_gate=w(E, d, f),
                              w_up=w(E, d, f), w_down=w(E, f, d))
    return p, torch.randn(shape, generator=g)


def biased(p):
    """``p`` routed to experts 0 and 1 only: the other experts' ranks
    receive no rows."""
    router = p.router.clone()
    router[:, 2:] = -30.0
    return types.SimpleNamespace(**{**vars(p), "router": router})


def projection(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def layer_grads(fn, p, x, proj):
    """(y, gradients of (y * proj).sum() in x and every leaf of p)."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in vars(p).items()}
    xt = x.clone().requires_grad_(True)
    y = fn(types.SimpleNamespace(**leaves), xt)
    grads = torch.autograd.grad((y * proj).sum(), [xt, *leaves.values()])
    return y.detach(), dict(zip(["x", *leaves], grads))


def llama_model(device="cpu"):
    """The smoke llama without remat, from a fixed seed."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke("llama3_2_1b"), remat=False)
    return Model(cfg, device=device).init(torch.Generator().manual_seed(0))


def train_batch(vocab, step):
    from repro_torch.data import SyntheticLM

    seq, batch, seed = TRAIN
    return {k: torch.from_numpy(v) for k, v in
            SyntheticLM(vocab, seq, batch, seed=seed).batch_np(step).items()}


def trainer_parts(model):
    """(params in the JAX leaf order, AdamW, its state, the step)."""
    from repro_torch.convert import jax_order
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_step

    named = dict(model.named_parameters())
    params = {n: named[n] for n in jax_order(named)}
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    return params, opt, opt.init(params), make_train_step(model, opt)


# ================================================================== suites
def suite_mesh(world, rank, _arg):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import count_collectives, logical_to_pspec
    from repro_torch.dist.sharding import (local_block, mesh_coordinate,
                                           to_placements, use_mesh)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Model
    from repro_torch.models.common import LeafSharding
    from repro_torch.models.moe import _data_sharded, moe
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.engine import Engine

    out = {}
    mesh = make_test_mesh(data=2, model=2, device="cpu")
    c = mesh_coordinate(mesh)["data"]
    rows = slice(c * BATCH // 2, (c + 1) * BATCH // 2)
    cfg = moe_cfg()
    p, x = layer_inputs(1, (BATCH, 9, D), cfg)
    xb = x[rows]
    with use_mesh(mesh):
        out["data_sharded_2x2"] = _data_sharded()
        out["ep"], out["grads"] = layer_grads(
            lambda q, t: moe(q, t, cfg), p, xb, projection(xb.shape, 2 + c))
        out["ep_chunked"] = torch.cat([moe(p, xb[:, i:i + 4], cfg)
                                       for i in range(0, 9, 4)], dim=1)
        out["ep_per_token"] = torch.cat([moe(p, xb[:, i:i + 1], cfg)
                                         for i in range(9)], dim=1)
        out["ep_empty"] = moe(biased(p), xb, cfg)
        try:
            moe(p, xb, moe_cfg(n_experts=3, ep_axis_size=3))
        except ValueError as e:
            out["mismatch_moe"] = str(e)
        from repro_torch.configs import get_smoke

        bad = dataclasses.replace(get_smoke("granite_moe_3b_a800m"),
                                  dtype=torch.float32,
                                  moe_parallelism="ep", moe_ep_axis_size=3)
        try:
            Engine(Model(bad, device="cpu"), ServeConfig())
        except ValueError as e:
            out["mismatch_engine"] = str(e)
        # The JAX package's mesh ep test's layer and inputs.
        jin = np.load(_arg)
        jcfg = moe_cfg(d=32, f=48)
        jp = types.SimpleNamespace(**{k: torch.from_numpy(jin[k]) for k in
                                      ("router", "w_gate", "w_up",
                                       "w_down")})
        jx = torch.from_numpy(jin["x"])[c:c + 1]
        out["jax_case"] = layer_grads(lambda q, t: moe(q, t, jcfg), jp, jx,
                                      torch.ones_like(jx))

    # tp under a (4, 1) mesh: per row, this rank's row of the batch.
    mesh4 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    tcfg = moe_cfg(parallelism="tp", n_experts=8)
    tp_p, tx = layer_inputs(5, (BATCH, 9, D), tcfg)
    with use_mesh(mesh4), count_collectives() as rec:
        out["data_sharded_4x1"] = _data_sharded()
        out["per_row"] = moe(tp_p, tx[rank:rank + 1], tcfg)
    out["per_row_collectives"] = rec

    # A joint (pod, data) entry on a (2, 2, 1) mesh.
    joint = init_device_mesh("cpu", (2, 2, 1),
                             mesh_dim_names=("pod", "data", "model"))
    full = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    spec = logical_to_pspec(("batch", None, "mlp"), full.shape, joint)
    out["joint_spec"] = tuple(spec)
    out["joint_coord"] = mesh_coordinate(joint)
    out["joint_block"] = local_block(full, spec, joint)
    out["joint_dtensor"] = distribute_tensor(
        full, joint, to_placements(spec, joint, 3),
        src_data_rank=None).to_local()
    out["joint_place"] = LeafSharding(joint, spec).place(full).to_local()
    return out


def suite_ring(world, rank, arg):
    from repro_torch.dist import (allgather_matmul_reference,
                                  count_collectives, make_overlapped_mlp,
                                  matmul_reducescatter_reference,
                                  ring_allgather_matmul,
                                  ring_matmul_reducescatter)
    from repro_torch.dist.collectives import all_reduce
    from repro_torch.launch.mesh import make_test_mesh

    inp = {k: torch.from_numpy(v) for k, v in np.load(arg).items()}
    mesh = make_test_mesh(data=1, model=world, device="cpu")
    group = mesh.get_group("model")
    r = rank

    def rows(t):
        m = t.shape[0] // world
        return t[r * m:(r + 1) * m]

    def cols(t):
        m = t.shape[1] // world
        return t[:, r * m:(r + 1) * m]

    out = {}
    x, w1, w2, h = inp["x"], inp["w1"], inp["w2"], inp["h"]
    out["ring_ag"] = ring_allgather_matmul(rows(x), cols(w1), group)
    out["ref_ag"] = allgather_matmul_reference(rows(x), cols(w1), group)
    out["ring_rs"] = ring_matmul_reducescatter(cols(h), rows(w2), group)
    out["ref_rs"] = matmul_reducescatter_reference(cols(h), rows(w2), group)
    mx, m1, m2 = inp["mlp_x"], inp["mlp_w1"], inp["mlp_w2"]
    for overlap in (True, False):
        with count_collectives() as rec:
            y = make_overlapped_mlp(mesh, overlap)(rows(mx), cols(m1),
                                                   rows(m2))
        out[f"mlp_{overlap}"], out[f"mlp_{overlap}_rec"] = y, rec
    with count_collectives() as rec:
        t = torch.ones(3)
        for _ in range(5):
            all_reduce(t.clone(), group)
    out["loop_rec"] = rec
    return out


def suite_save(world, rank, ckpt):
    """Place the smoke llama on a 2 x 2 mesh, gather it back and save it
    (rank 0); then one training step in every rank, and the trained state
    saved the same way."""
    import torch.distributed as dist

    from repro_torch.ckpt import save
    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import param_shardings

    mesh = make_test_mesh(data=2, model=2, device="cpu")
    model = llama_model()
    sh = param_shardings(model.param_defs(), mesh)

    def through_mesh(state):
        return {n: sh[n].place(t.detach()).full_tensor()
                for n, t in state.items()}

    out = {}
    init = through_mesh(dict(model.named_parameters()))
    if rank == 0:
        save(os.path.join(ckpt, "init"), 7,
             {"params": params_to_numpy(init)})
    params, _, state, step = trainer_parts(model)
    params, state, metrics = step(params, state,
                                  train_batch(model.cfg.vocab, 0))
    out["loss0"] = float(metrics["loss"])
    trained = {"params": params_to_numpy(through_mesh(params)),
               "m": params_to_numpy(through_mesh(state.m)),
               "v": params_to_numpy(through_mesh(state.v)),
               "opt_step": np.int32(int(state.step))}
    if rank == 0:
        save(os.path.join(ckpt, "trained"), 1, trained)
    dist.barrier()
    return out


def suite_restore(world, rank, ckpt):
    """``ShardedLoader``'s blocks on a (2, 1) mesh, then the elastic
    restore of ``suite_save``'s checkpoints onto a 1 x 2 mesh."""
    from repro_torch.ckpt import restore
    from repro_torch.data import ShardedLoader, SyntheticLM
    from repro_torch.ft import plan_rescale
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adamw import AdamWState

    out = {}
    vocab, seq, batch, seed = LOADER
    loader = ShardedLoader(SyntheticLM(vocab, seq, batch, seed=seed),
                           make_test_mesh(data=2, model=1, device="cpu"),
                           prefetch=2, device="cpu")
    it = iter(loader)
    out["loader"] = [next(it) for _ in range(3)]
    loader.close()

    plan = plan_rescale(world, (2, 2))
    out["plan"] = plan.new_shape
    mesh = make_test_mesh(*plan.new_shape, device="cpu")
    from repro_torch.models.common import param_shardings

    model = llama_model()
    sh = param_shardings(model.param_defs(), mesh)
    tree, meta = restore(os.path.join(ckpt, "init"),
                         shardings={"params": sh})
    out["init_step"] = meta["step"]
    out["init_local"] = {n: t.to_local() for n, t in tree["params"].items()}
    out["init_placements"] = {n: tuple(map(str, t.placements))
                              for n, t in tree["params"].items()}
    from repro_torch.ft import reshard_state

    out["reshard_local"] = {n: t.to_local() for n, t in reshard_state(
        dict(model.named_parameters()), model.param_defs(), mesh).items()}

    # zero1 moments (layers -> data) on a (2, 1) mesh: each rank holds
    # its own layers, as plain tensors.
    from repro_torch.dist.sharding import MOMENTS_RULES

    zero1 = param_shardings(model.param_defs(),
                            make_test_mesh(data=2, model=1, device="cpu"),
                            {**MOMENTS_RULES, "layers": "data"})
    tree, _ = restore(os.path.join(ckpt, "trained"), shardings={"m": zero1})
    out["zero1"] = {n: (type(t).__name__, getattr(t, "to_local",
                                                   lambda: t)())
                    for n, t in tree["m"].items()}

    tree, _ = restore(os.path.join(ckpt, "trained"),
                      shardings={"params": sh, "m": sh, "v": sh})
    full = {k: {n: t.full_tensor() for n, t in tree[k].items()}
            for k in ("params", "m", "v")}
    params, _, _, step = trainer_parts(model)
    for n, p in params.items():
        p.data.copy_(full["params"][n])
    state = AdamWState(step=torch.tensor(int(tree["opt_step"]),
                                         dtype=torch.int32),
                       m=full["m"], v=full["v"])
    _, _, metrics = step(params, state, train_batch(model.cfg.vocab, 1))
    out["loss1"] = float(metrics["loss"])
    return out


SUITES = {"mesh": suite_mesh, "ring": suite_ring, "save": suite_save,
          "restore": suite_restore}


def main():
    from _torch_gloo import join_group

    store_file, world, rank, out_dir, suite, arg = sys.argv[1:]
    world, rank = int(world), int(rank)
    import torch.distributed as dist

    join_group(store_file, world, rank)
    try:
        out = SUITES[suite](world, rank, arg)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
