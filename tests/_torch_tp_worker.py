"""One rank of the port's tensor- and data-parallel tests
(``test_torch_tp.py``): joins a gloo group of 4 ranks through a
``FileStore`` (``_torch_gloo``), trains the smoke models on the rank's
blocks under several meshes cut from the 4 ranks, and saves what it got to
``<out>/rank<r>.pt``.

    python tests/_torch_tp_worker.py STORE 4 RANK OUT_DIR INPUTS

``INPUTS`` (``torch.save``) holds each model's whole f32 parameters and
the batch, made by the test from seeds.  Meshes: 1 x 2 on ranks 0-1 while
2 x 1 runs on ranks 2-3, then 2 x 2, 1 x 4 and 1 x 1 (each rank its own),
each a ``DeviceMesh`` over ``(data, model)``.  Every case records the
loss and the gradients of the step's reduced value-and-grad, the
collectives they issued, the losses and grad norms of two AdamW steps and
the parameters after them: all the rank's blocks.  On 1 x 4 the hybrid
also trains with two SSM heads of 128 (``WIDE_HEADS``).  On 2 x 2 and 1 x 4
each model also prefills its data block, and on 2 x 2 a ``Trainer`` made
under the mesh runs the dense model's two steps.  The cases run in
float64 with the f32 islands widened (``wide``); the 2 x 2 mesh also runs
each model in f32, for the JAX comparison.
"""

import contextlib
import dataclasses
import os
import sys

import torch

MODELS = ("llama3_2_1b", "granite_moe_3b_a800m", "zamba2_7b")
# The hybrid with 2 SSM heads of 128: on a model axis of 4 its ssm_heads
# cannot split while its d_inner of 256 could.
WIDE_HEADS = {"ssm_head_dim": 128}
BATCH, SEQ = 4, 32


@contextlib.contextmanager
def wide():
    """The port's f32 islands (the module constants ``F32`` of the layers,
    the MoE and Mamba2 blocks, the plain kernels and AdamW) in float64
    within the block, as ``test_torch_hybrid_train.py`` widens them: the
    float64 comparison's only change to the port."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers, moe, ssm
    from repro_torch.optim import adamw

    mods = (layers, moe, ssm, ref, adamw)
    for m in mods:
        m.F32 = torch.float64
    try:
        yield
    finally:
        for m in mods:
            m.F32 = torch.float32


def model_cfg(arch, dtype=torch.float32, **kw):
    from repro_torch.configs import get_smoke

    return dataclasses.replace(get_smoke(arch), dtype=dtype, **kw)


def make_model(arch, state, dtype=torch.float32, **kw):
    """The smoke model of ``arch`` holding ``state``, every tensor in
    ``dtype`` (float64: the f32 ones too)."""
    from repro_torch.models import Model

    model = Model(model_cfg(arch, dtype, **kw), device="cpu")
    model.load_state_dict(state)
    return model.to(dtype)


def optimizer():
    from repro_torch.optim import AdamW

    return AdamW(lr=1e-3, eps=1e-4)


def data_block(batch, mesh):
    """The rank's rows of the batch: its block over the data axis."""
    from repro_torch.dist.sharding import mesh_coordinate, mesh_sizes

    n = mesh_sizes(mesh)["data"]
    c = mesh_coordinate(mesh)["data"]
    rows = BATCH // n
    return {k: v[c * rows:(c + 1) * rows] for k, v in batch.items()}


def train(arch, state, batch, mesh, steps=2, dtype=torch.float64, **kw):
    """Loss, gradients and collectives of the reduced value-and-grad, then
    ``steps`` AdamW steps: the rank's blocks, under ``mesh``."""
    from repro_torch.convert import jax_order
    from repro_torch.dist import count_collectives
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.train.step import make_train_step, reduced_value_and_grad

    model = make_model(arch, state, dtype, **kw)
    opt = optimizer()
    out = {}
    with use_mesh(mesh):
        model.shard_()
        named = dict(model.named_parameters())
        params = {n: named[n] for n in jax_order(named)}
        mine = data_block(batch, mesh)
        with count_collectives() as rec:
            loss, grads = reduced_value_and_grad(model, params, mine)
        out.update(loss=loss, grads=grads, collectives=rec)
        step = make_train_step(model, opt)
        state_ = opt.init(params)
        losses, norms = [], []
        for _ in range(steps):
            _, state_, metrics = step(params, state_, mine)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
    out.update(losses=losses, norms=norms,
               params={n: p.detach().clone() for n, p in params.items()})
    return out


def prefill(arch, state, batch, mesh):
    """The rank's prefill of its data block of the prompts under
    ``mesh`` (float64): the whole last logits and its cache blocks."""
    from repro_torch.dist.sharding import use_mesh

    model = make_model(arch, state, torch.float64)
    with use_mesh(mesh):
        model.shard_()
        tokens = data_block(batch, mesh)["tokens"]
        cache = model.init_cache(tokens.shape[0], SEQ + 4)
        logits, cache = model.prefill(tokens, cache)
    return {"logits": logits, "cache": cache}


def trainer(arch, state, batch, mesh, steps=2):
    """A ``Trainer`` made under ``mesh`` (float64) run ``steps`` steps on
    the rank's data block: its losses and the blocks it holds after."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.train import Trainer, TrainerConfig

    model = make_model(arch, state, torch.float64)
    with use_mesh(mesh):
        tr = Trainer(model, optimizer(),
                     TrainerConfig(steps=steps, log_every=1),
                     params=model.state_dict())
    tr.run(iter([data_block(batch, mesh)] * steps))
    return {"losses": [m["loss"] for m in tr.metrics_log],
            "params": {n: p.detach().clone() for n, p in tr.params.items()}}


def meshes(rank, world):
    """(name, mesh) of each layout this rank runs, every mesh built on
    every rank (a process group is made by all of them)."""
    from torch.distributed.device_mesh import DeviceMesh

    def mesh(rows):
        return DeviceMesh("cpu", torch.tensor(rows),
                          mesh_dim_names=("data", "model"))

    pair = (mesh([[0, 1]]), mesh([[2], [3]]))
    square = mesh([[0, 1], [2, 3]])
    row = mesh([[0, 1, 2, 3]])
    ones = [mesh([[r]]) for r in range(world)]
    first = ("1x2", pair[0]) if rank < 2 else ("2x1", pair[1])
    return [first, ("2x2", square), ("1x4", row), ("1x1", ones[rank])]


def run(world, rank, inputs):
    inp = torch.load(inputs, weights_only=False)
    batch = inp["batch"]
    out = {}
    for name, mesh in meshes(rank, world):
        with wide():
            for arch in MODELS:
                out[name, arch] = train(arch, inp["state"][arch], batch,
                                        mesh)
                if name in ("2x2", "1x4"):
                    out[name + " prefill", arch] = prefill(
                        arch, inp["state"][arch], batch, mesh)
        if name == "1x4":
            with wide():
                out["1x4 wide heads", MODELS[2]] = train(
                    MODELS[2], inp["state"]["wide heads"], batch, mesh,
                    **WIDE_HEADS)
        if name != "2x2":
            continue
        for arch in MODELS:
            out["2x2 f32", arch] = train(arch, inp["state"][arch], batch,
                                         mesh, steps=0, dtype=torch.float32)
        with wide():
            # Two runs of one layout give the same bits.
            out["2x2 again", MODELS[0]] = train(
                MODELS[0], inp["state"][MODELS[0]], batch, mesh)
            out["2x2 trainer", MODELS[0]] = trainer(
                MODELS[0], inp["state"][MODELS[0]], batch, mesh)
            # ep over the model axis with the data reduction: the router's
            # gradient is the whole batch's.
            out["2x2 ep", MODELS[1]] = train(
                MODELS[1], inp["state"][MODELS[1]], batch, mesh, steps=1,
                moe_parallelism="ep", moe_ep_axis_size=2)
    return out


def main():
    from _torch_gloo import join_group

    store_file, world, rank, out_dir, inputs = sys.argv[1:]
    world, rank = int(world), int(rank)
    import torch.distributed as dist

    join_group(store_file, world, rank)
    try:
        out = run(world, rank, inputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
