"""``ShardedLoader`` and elastic rescaling on the CPU.  Two gloo groups
(``_torch_dist_worker.py``): 4 ranks on a 2 x 2 mesh save a checkpoint of
the smoke llama placed on the mesh (its init, and its state after one
training step); then 2 ranks load ``ShardedLoader`` blocks on a (2, 1)
mesh and restore both checkpoints onto the 1 x 2 mesh that
``plan_rescale`` picks.

- ``ShardedLoader``'s blocks concatenate to ``batch_np(step)`` bit for
  bit, in step order; without a mesh a rank gets the whole batch;
  ``close()`` returns within 5 s with the queue full.
- ``plan_rescale`` equals the JAX package's on a grid of shapes.
- Restore onto the smaller mesh is bitwise a fresh deterministic init's
  blocks, placed by the rules (the reference's
  ``test_checkpoint_restores_onto_smaller_mesh``), as ``reshard_state``
  places them.
- The loss after restore and one step is within 1e-4 of the
  uninterrupted run's (``test_restored_state_trains_identically``).
- The zero1 moments (``layers -> data``) restored onto a (2, 1) mesh:
  each rank gets exactly its own layers, as plain tensors bitwise equal
  to the checkpoint's, and the other leaves as DTensors of its blocks.
"""

import functools
import itertools
import os
import time

import pytest
import torch

from _torch_dist_worker import (LOADER, llama_model, train_batch,
                                trainer_parts)
from _torch_gloo import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.data import ShardedLoader, SyntheticLM


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def groups(tmp_path_factory, ckpt):
    """(the saving ranks' results, the restoring ranks' results)."""
    saved = run_ranks("_torch_dist_worker.py", 4,
                      str(tmp_path_factory.mktemp("save4")), "save", ckpt)
    restored = run_ranks("_torch_dist_worker.py", 2,
                         str(tmp_path_factory.mktemp("restore2")),
                         "restore", ckpt)
    return saved, restored


@functools.lru_cache(maxsize=None)
def uninterrupted():
    """The losses of two training steps in one process."""
    model = llama_model()
    params, _, state, step = trainer_parts(model)
    params, state, m0 = step(params, state, train_batch(model.cfg.vocab, 0))
    _, _, m1 = step(params, state, train_batch(model.cfg.vocab, 1))
    return float(m0["loss"]), float(m1["loss"])


def test_loader_blocks_concatenate_to_batch_np(groups):
    _, ranks = groups
    vocab, seq, batch, seed = LOADER
    src = SyntheticLM(vocab, seq, batch, seed=seed)
    for step in range(3):
        want = src.batch_np(step)
        for key, arr in want.items():
            got = torch.cat([r["loader"][step][key] for r in ranks])
            assert torch.equal(got, torch.from_numpy(arr)), (step, key)
            assert ranks[0]["loader"][step][key].shape[0] == batch // 2


def test_loader_without_mesh_gives_whole_batches():
    src = SyntheticLM(512, 16, 4, seed=3)
    loader = ShardedLoader(src, prefetch=2, device="cpu")
    got = list(itertools.islice(iter(loader), 3))
    loader.close()
    for step, b in enumerate(got):
        for key, arr in src.batch_np(step).items():
            assert torch.equal(b[key], torch.from_numpy(arr))


def test_loader_close_returns_with_queue_full():
    loader = ShardedLoader(SyntheticLM(512, 16, 4, seed=3), prefetch=2,
                           device="cpu")
    it = iter(loader)
    next(it)
    deadline = time.monotonic() + 5
    while not loader._q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert loader._q.full()
    t0 = time.monotonic()
    loader.close()
    assert time.monotonic() - t0 < 5.0
    assert loader._thread is None


def test_plan_rescale_matches_reference():
    from repro.ft import plan_rescale as ref_plan
    from repro_torch.ft import plan_rescale

    for old in ((2, 4), (4, 4), (16, 16), (1, 8), (3, 5), (2, 16, 16)):
        for n in (1, 2, 3, 4, 7, 8, 15, 16, 31, 64, 255, 256, 511):
            a, b = plan_rescale(n, old), ref_plan(n, old)
            assert (a.new_shape, a.accum_factor, a.new_device_count) == (
                b.new_shape, b.accum_factor, b.new_device_count), (n, old)


def test_checkpoint_restores_onto_smaller_mesh(groups):
    """Each restoring rank's blocks are those of a fresh init on the
    (1, 2) mesh, bit for bit, and the MLP weights are split over the
    model axis."""
    from repro_torch.dist import abstract_mesh
    from repro_torch.dist.sharding import local_block
    from repro_torch.models.common import param_shardings

    _, ranks = groups
    model = llama_model()
    mesh = abstract_mesh((1, 2), ("data", "model"))
    sh = param_shardings(model.param_defs(), mesh)
    fresh = dict(model.named_parameters())
    for r, res in enumerate(ranks):
        assert res["plan"] == (1, 2) and res["init_step"] == 7
        assert set(res["init_local"]) == set(fresh)
        for name, t in fresh.items():
            want = local_block(t.detach(), sh[name].spec, mesh, rank=r)
            assert torch.equal(res["init_local"][name], want), (r, name)
            assert torch.equal(res["reshard_local"][name], want), (r, name)
        assert res["init_placements"]["layers.0.mlp.w_gate"] == ("R",
                                                                 "S(1)")


def test_restored_state_trains_identically(groups):
    saved, restored = groups
    loss0, loss1 = uninterrupted()
    for res in saved:
        assert abs(res["loss0"] - loss0) < 1e-4
    for res in restored:
        assert abs(res["loss1"] - loss1) < 1e-4, (res["loss1"], loss1)


def test_zero1_moments_restore_as_each_ranks_layers(groups, ckpt):
    """``layers -> data`` splits the stacks over the two data ranks: a
    rank holds its own layer of each stack (a plain tensor, since no
    DTensor placement says "held by some ranks only") and every other
    leaf as a DTensor of its block."""
    from repro_torch.ckpt import restore
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import abstract_mesh
    from repro_torch.dist.sharding import MOMENTS_RULES, local_block
    from repro_torch.models.common import param_shardings

    _, ranks = groups
    tree, _ = restore(os.path.join(ckpt, "trained"))
    full = params_from_numpy(tree["m"], device="cpu")
    mesh = abstract_mesh((2, 1), ("data", "model"))
    sh = param_shardings(llama_model().param_defs(), mesh,
                         {**MOMENTS_RULES, "layers": "data"})
    for r, res in enumerate(ranks):
        got = res["zero1"]
        held = {n for n in full if sh[n].holds(r)}
        assert set(got) == held and len(held) < len(full), r
        for name, (kind, t) in got.items():
            split = name.startswith("layers.")
            assert kind == ("Tensor" if split else "DTensor"), (r, name)
            want = local_block(full[name], sh[name].spec, mesh, rank=r)
            assert torch.equal(t, want), (r, name)
