"""One rank of the port's fsdp and zero1 tests (``test_torch_fsdp.py``):
joins a gloo group of 4 ranks through a ``FileStore`` (``_torch_gloo``),
trains the smoke ``llama3_2_1b`` under the ``fsdp`` profile
(``FSDP_RULES``) with zero1 moments on meshes cut from the 4 ranks, and
saves what it got to ``<out>/rank<r>.pt``.

    python tests/_torch_fsdp_worker.py STORE 4 RANK OUT_DIR INPUTS

``INPUTS`` (``torch.save``) holds the 2- and 3-layer models' whole f32
parameters and the batch.  Meshes: 2 x 1 on ranks 0-1 (and on ranks 2-3,
which skip it), then 2 x 2 and 1 x 1 (rank 0 alone), each a
``DeviceMesh`` over ``(data, model)``.
Each case records the loss, gradients and collectives of the step's
reduced value-and-grad, the collectives of the first AdamW step, the
losses and grad norms of two steps and the parameters after them: the
rank's blocks, in float64 with the f32 islands widened.  On 2 x 2 the
2-layer model also trains with zero1 alone (``DEFAULT_RULES``), a second
time under fsdp, through a ``Trainer`` with ``profile="fsdp"`` and
``moments="zero1"``, and in f32 (loss and gradients, the JAX comparison).
"""

import os
import sys

import torch

from _torch_tp_worker import data_block, make_model, optimizer, wide

ARCH = "llama3_2_1b"
DEPTHS = (2, 3)        # a layer count the data axis divides, and one not


def train(state, batch, mesh, profile="fsdp", moments="zero1", steps=2,
          dtype=torch.float64, n_layers=2):
    """Loss, gradients and collectives of the reduced value-and-grad, then
    ``steps`` AdamW steps (the first one's collectives counted): the
    rank's blocks, under ``mesh`` (None: one process) and the profile's
    rules."""
    import contextlib

    from repro_torch.convert import jax_order
    from repro_torch.dist import count_collectives
    from repro_torch.dist.sharding import (DEFAULT_RULES, FSDP_RULES,
                                           use_mesh, use_rules)
    from repro_torch.train.step import (make_train_step,
                                        reduced_value_and_grad, zero1_layout)

    model = make_model(ARCH, state, dtype, n_layers=n_layers)
    opt = optimizer()
    rules = FSDP_RULES if profile == "fsdp" else DEFAULT_RULES
    out = {}
    with contextlib.ExitStack() as ctx:
        layout = None
        if mesh is not None:
            ctx.enter_context(use_rules(rules))
            ctx.enter_context(use_mesh(mesh))
            model.shard_()
            batch = data_block(batch, mesh)
            if moments == "zero1":
                layout = zero1_layout(model, mesh)
        named = dict(model.named_parameters())
        params = {n: named[n] for n in jax_order(named)}
        with count_collectives() as rec:
            loss, grads = reduced_value_and_grad(model, params, batch)
        out.update(loss=loss, grads=grads, collectives=rec)
        step = make_train_step(model, opt)
        st = opt.init(params, layout)
        out["moments"] = sorted(st.m)
        losses, norms = [], []
        for i in range(steps):
            with count_collectives() as rec:
                _, st, metrics = step(params, st, batch)
            if i == 0:
                out["step_collectives"] = rec
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
    out.update(losses=losses, norms=norms,
               params={n: p.detach().clone() for n, p in params.items()})
    return out


def trainer(state, batch, mesh, steps=2):
    """A ``Trainer`` made under ``mesh`` with the fsdp profile and zero1
    moments (float64) run ``steps`` steps on the rank's data block."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.train import Trainer, TrainerConfig

    model = make_model(ARCH, state, torch.float64)
    with use_mesh(mesh):
        tr = Trainer(model, optimizer(),
                     TrainerConfig(steps=steps, log_every=1, profile="fsdp",
                                   moments="zero1"),
                     params=model.state_dict())
    tr.run(iter([data_block(batch, mesh)] * steps))
    return {"losses": [m["loss"] for m in tr.metrics_log],
            "params": {n: p.detach().clone() for n, p in tr.params.items()}}


def meshes(rank, world):
    from torch.distributed.device_mesh import DeviceMesh

    def mesh(rows):
        return DeviceMesh("cpu", torch.tensor(rows),
                          mesh_dim_names=("data", "model"))

    pair = (mesh([[0], [1]]), mesh([[2], [3]]))
    square = mesh([[0, 1], [2, 3]])
    ones = [mesh([[r]]) for r in range(world)]
    return [("2x1", pair[rank // 2]), ("2x2", square), ("1x1", ones[rank])]


def run(world, rank, inputs):
    inp = torch.load(inputs, weights_only=False)
    batch = inp["batch"]
    out = {}
    for name, mesh in meshes(rank, world):
        if rank >= 2 and name == "2x1" or rank and name == "1x1":
            continue            # the copies on the other ranks: idle
        with wide():
            for L in DEPTHS:
                out[name, L] = train(inp["state"][L], batch, mesh,
                                     n_layers=L)
        if name != "2x2":
            continue
        with wide():
            out["2x2 zero1", 2] = train(inp["state"][2], batch, mesh,
                                        profile="tp")
            out["2x2 again", 2] = train(inp["state"][2], batch, mesh)
            out["2x2 trainer", 2] = trainer(inp["state"][2], batch, mesh)
        out["2x2 f32", 2] = train(inp["state"][2], batch, mesh, steps=0,
                                  dtype=torch.float32)
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
