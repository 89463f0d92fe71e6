"""One rank of the port's mesh-decode tests (``test_torch_mesh_decode.py``):
joins a gloo group of 4 ranks through a ``FileStore`` (``_torch_gloo``),
prefills the smoke models on the rank's blocks and decodes 8 greedy steps
under several meshes cut from the 4 ranks and two cache layouts, and saves
what it got to ``<out>/rank<r>.pt``.

    python tests/_torch_decode_worker.py STORE 4 RANK OUT_DIR INPUTS

``INPUTS`` (``torch.save``) holds each model's whole f32 parameters, the
prompts and the tokens fed to the f32 runs, made by the test from seeds.
Meshes as in ``_torch_tp_worker``: 1 x 2 on ranks 0-1 (ranks 2-3 skip
their 2 x 1), then 2 x 2, 1 x 4 and 1 x 1 (rank 0 alone).  Layouts: ``a`` (``DECODE_RULES``:
the cache's kv heads over ``model``) and ``b`` (the dry run's decode rules:
its positions over ``model``); on 2 x 2 also ``SP_DECODE_RULES`` for the
dense model, a second run of ``b``, and each model in f32 under ``b`` fed
the given tokens for 4 steps (the JAX comparison); on 1 x 4 the dense
model also with a window of 16 (a ring cache, the prompt past it).  Each
case records the prefill's and every step's whole logits of the rank's
rows, its greedy stream and the collectives of its first decode step, in
float64 with the f32 islands widened (``wide``).
"""

import os
import sys

import torch

from _torch_tp_worker import data_block, make_model, meshes, wide

MODELS = ("llama3_2_1b", "granite_moe_3b_a800m", "zamba2_7b")
RING = {"window": 16}            # the dense model's ring: 16 slots
PROMPT, STEPS, SEQ = 20, 8, 28   # the cache holds positions 0..27
FED_STEPS = 4


def rules(name):
    from repro_torch.dist.sharding import (DECODE_RULES, DEFAULT_RULES,
                                           SP_DECODE_RULES)

    return {"a": DECODE_RULES, "sp": SP_DECODE_RULES,
            "b": dict(DEFAULT_RULES, kv_seq="model", head_dim=None,
                      qdh=None)}[name]


def serve(arch, state, prompts, mesh, layout, dtype=torch.float64,
          steps=STEPS, feed=None, **kw):
    """Prefill the rank's rows of ``prompts``, then ``steps`` decode steps
    (greedy, or the rank's rows of ``feed``) under ``mesh`` and the rules
    of ``layout`` (``mesh`` None: one process on every row)."""
    import contextlib

    from repro_torch.dist import count_collectives
    from repro_torch.dist.sharding import use_mesh, use_rules

    model = make_model(arch, state, dtype, **kw)
    with contextlib.ExitStack() as ctx:
        if mesh is not None:
            ctx.enter_context(use_rules(rules(layout)))
            ctx.enter_context(use_mesh(mesh))
            model.shard_()
            prompts = data_block({"t": prompts}, mesh)["t"]
            if feed is not None:
                feed = data_block({"t": feed}, mesh)["t"]
        cache = model.init_cache(prompts.shape[0], SEQ)
        lg, cache = model.prefill(prompts, cache)
        logits, stream, rec = [lg], [], None
        for t in range(steps):
            nxt = lg.argmax(-1) if feed is None else feed[:, t]
            stream.append(nxt)
            with count_collectives() as c:
                lg, cache = model.decode(nxt, cache, PROMPT + t)
            rec = c if rec is None else rec
            logits.append(lg)
    return {"logits": torch.stack(logits), "stream": torch.stack(stream),
            "collectives": rec}


def run(world, rank, inputs):
    inp = torch.load(inputs, weights_only=False)
    state, prompts = inp["state"], inp["prompts"]
    out = {}
    for name, mesh in meshes(rank, world):
        if name == "2x1" or name == "1x1" and rank:
            continue                # 2 x 1 and three 1 x 1 copies: idle
        with wide():
            for layout in ("a", "b"):
                for arch in MODELS:
                    out[name, layout, arch] = serve(arch, state[arch],
                                                    prompts, mesh, layout)
                if name == "1x4":
                    out[name, layout, "ring"] = serve(
                        MODELS[0], state[MODELS[0]], prompts, mesh, layout,
                        **RING)
        if name != "2x2":
            continue
        with wide():
            out[name, "sp", MODELS[0]] = serve(MODELS[0], state[MODELS[0]],
                                               prompts, mesh, "sp")
            out[name, "b again", MODELS[0]] = serve(
                MODELS[0], state[MODELS[0]], prompts, mesh, "b")
        for arch in MODELS:
            out[name, "b f32", arch] = serve(
                arch, state[arch], prompts, mesh, "b", torch.float32,
                steps=FED_STEPS, feed=inp["feed"])
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
