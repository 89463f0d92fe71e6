"""One rank of the port's tests of the xLSTM, encoder-decoder and VLM
families and of capacity dispatch under a mesh
(``test_torch_tp_families.py``): joins a gloo group of 4 ranks through a
``FileStore`` (``_torch_gloo``), trains and serves the smoke models on the
rank's blocks under meshes cut from the 4 ranks, and saves what it got to
``<out>/rank<r>.pt``.

    python tests/_torch_families_worker.py STORE 4 RANK OUT_DIR INPUTS

``INPUTS`` (``torch.save``) holds each model's whole f32 parameters, the
batch (tokens, labels, the VLM's patches and the encoder-decoder's frames)
and the prompts.  Meshes as in ``_torch_tp_worker``: 1 x 2 on ranks 0-1
while 2 x 1 runs on ranks 2-3 (capacity dispatch alone), then 2 x 2 and
1 x 1 (rank 0 alone).  Each family records
the loss and gradients of the step's reduced value-and-grad and the
collectives they issued, and the prefill's and 4 greedy decode steps'
whole logits of its rows (``DECODE_RULES``; the encoder-decoder also under
the dry run's decode rules, its memory split by position); granite MoE
with ``moe_dispatch="capacity"`` takes two AdamW steps.  In float64 with
the f32 islands widened (``wide``, the xLSTM's too); on 2 x 2 each family
also in f32 (loss and gradients, the JAX comparison).
"""

import contextlib
import os
import sys

import torch

from _torch_tp_worker import (data_block, make_model, meshes, train)
from _torch_tp_worker import wide as tp_wide

FAMILIES = ("xlstm_350m", "seamless_m4t_medium", "phi3_vision_4_2b")
CAPACITY = "granite_moe_3b_a800m"
PROMPT, STEPS, SEQ = 16, 4, 24
FRONTEND = {"phi3_vision_4_2b": "patches", "seamless_m4t_medium": "frames"}


@contextlib.contextmanager
def wide():
    """``_torch_tp_worker.wide`` and the xLSTM blocks' f32 in float64."""
    from repro_torch.models import xlstm

    with tp_wide():
        xlstm.F32 = torch.float64
        try:
            yield
        finally:
            xlstm.F32 = torch.float32


def rules(name):
    from repro_torch.dist.sharding import DECODE_RULES, DEFAULT_RULES

    return {"a": DECODE_RULES,
            "b": dict(DEFAULT_RULES, kv_seq="model", head_dim=None,
                      qdh=None)}[name]


def grads(arch, state, batch, mesh, dtype=torch.float64):
    """Loss, gradients and collectives of the reduced value-and-grad: the
    rank's blocks under ``mesh`` (None: one process)."""
    from repro_torch.convert import jax_order
    from repro_torch.dist import count_collectives
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.train.step import reduced_value_and_grad

    model = make_model(arch, state, dtype)
    with contextlib.ExitStack() as ctx:
        if mesh is not None:
            ctx.enter_context(use_mesh(mesh))
            model.shard_()
            batch = data_block(batch, mesh)
        named = dict(model.named_parameters())
        params = {n: named[n] for n in jax_order(named)}
        with count_collectives() as rec:
            loss, g = reduced_value_and_grad(model, params, batch)
    return {"loss": loss, "grads": g, "collectives": rec}


def serve(arch, state, prompts, frontend, mesh, layout="a"):
    """Prefill the rank's rows (with the VLM's patches or the
    encoder-decoder's frames), then ``STEPS`` greedy decode steps, under
    ``mesh`` (None: one process) and the rules of ``layout``."""
    from repro_torch.dist.sharding import use_mesh, use_rules
    from repro_torch.models.common import tree_map

    model = make_model(arch, state, torch.float64)
    key = FRONTEND.get(arch)
    with contextlib.ExitStack() as ctx:
        if mesh is not None:
            ctx.enter_context(use_rules(rules(layout)))
            ctx.enter_context(use_mesh(mesh))
            model.shard_()
            prompts = data_block({"t": prompts}, mesh)["t"]
            if key:
                frontend = data_block({"t": frontend}, mesh)["t"]
        extra = {key: frontend.double()} if key else {}
        pos = prompts.shape[1] + (frontend.shape[1] if key == "patches"
                                  else 0)
        # The cache's f32 states widened with the model (``wide``).
        cache = tree_map(lambda t: t.double(), model.init_cache(
            prompts.shape[0], SEQ + pos))
        lg, cache = model.prefill(prompts, cache, **extra)
        logits, stream = [lg], []
        for t in range(STEPS):
            stream.append(lg.argmax(-1))
            lg, cache = model.decode(stream[-1], cache, pos + t)
            logits.append(lg)
    return {"logits": torch.stack(logits), "stream": torch.stack(stream)}


def run(world, rank, inputs):
    inp = torch.load(inputs, weights_only=False)
    state, batch = inp["state"], inp["batch"]
    out = {}
    for name, mesh in meshes(rank, world):
        if name == "1x4" or name == "1x1" and rank:
            continue            # three 1 x 1 copies: idle
        with wide():
            for arch in FAMILIES if name != "2x1" else ():
                b = {k: v.double() if v.is_floating_point() else v
                     for k, v in batch[arch].items()}
                out[name, "grads", arch] = grads(arch, state[arch], b, mesh)
                out[name, "a", arch] = serve(
                    arch, state[arch], inp["prompts"],
                    inp["frontend"].get(arch), mesh)
            if name != "2x1":
                out[name, "b", FAMILIES[1]] = serve(
                    FAMILIES[1], state[FAMILIES[1]], inp["prompts"],
                    inp["frontend"][FAMILIES[1]], mesh, "b")
            out[name, "capacity", CAPACITY] = train(
                CAPACITY, state[CAPACITY], batch[CAPACITY], mesh,
                moe_dispatch="capacity")
        if name == "2x2":
            for arch in FAMILIES:
                out[name, "f32", arch] = grads(arch, state[arch],
                                               batch[arch], mesh,
                                               torch.float32)
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
