"""The port's dry run through its CLI (``python -m
repro_torch.launch.dryrun``), as ``test_system.py``'s
``test_dryrun_cell_via_cli`` drives the JAX package's: one cell on the
single-pod mesh writes a JSON record with ``status: ok``, the 256 devices,
a ``global_cost``, and per-device ``argument_bytes`` equal to what the JAX
package's specs give the same arguments on its abstract mesh (parameters,
cache, tokens and position).  The decode cell's per-device walk (one
decode step on the rank's cache block, its positions split over the model
axis) records a positive ``temp_bytes`` and per layer the gathers of the
q heads and of the partial attentions over the model group.  The
per-device walk: ``llama3_2_1b`` at ``--quick-layers 2`` records the
tensor-parallel and data-parallel all-reduces and a positive
``temp_bytes`` at ``train_4k`` and ``prefill_32k``; the global walk's
product flops at full depth are the reference's (866106998784 at
``decode_32k``, 1.233652046364672e16 at ``train_4k``).  The fsdp
profile's cell walks with its data-group all-gathers and reduce-scatters;
a wrong layout in the per-device walk fails the cell."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import dist as rdist
from repro.configs import get as ref_get
from repro.launch.dryrun import build_cell as ref_build_cell
from repro.models import SHAPES, build_model
from repro.models.common import ArrayDef, param_pspecs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_device(defs, specs, mesh):
    """Bytes one device holds of ``defs`` (ArrayDefs or shape structs)
    under ``specs``."""
    is_leaf = lambda x: isinstance(x, (ArrayDef, jax.ShapeDtypeStruct))  # noqa: E731
    total = 0
    for d, spec in zip(jax.tree.leaves(defs, is_leaf=is_leaf),
                       jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                           x, jax.sharding.PartitionSpec))):
        ways = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                ways *= mesh.shape[a]
        total += int(np.prod(d.shape)) * np.dtype(d.dtype).itemsize // ways
    return total


def test_dryrun_cell_via_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3_2_1b", "--shape", "decode_32k", "--mesh", "single",
         "--outdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "all cells traced" in proc.stdout
    rec = json.load(open(tmp_path / "pod256" /
                         "llama3_2_1b__decode_32k.json"))
    assert rec["status"] == "ok"
    assert rec["devices"] == 256
    assert rec["global_cost"]["flops"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert "temp_bytes_reason" not in rec["memory"]
    # Per layer: the q heads and the partials over the model group (the
    # 8 kv heads do not split 16 ways: wk and wv are whole), and the
    # logits' gather; the embedding's, attention's and the MLP's reduces.
    L = ref_get("llama3_2_1b").n_layers
    coll = rec["collectives"]
    assert coll["all_gather"]["count"] == 2 * L + 1
    assert coll["all_gather"]["max_group"] == 16
    assert coll["all_reduce"]["count"] == 1 + 2 * L

    mesh = rdist.abstract_mesh((16, 16), ("data", "model"))
    rules = ref_build_cell("llama3_2_1b", "decode_32k", mesh,
                           quick_layers=1)[-1]
    model = build_model(ref_get("llama3_2_1b"))
    shape = SHAPES["decode_32k"]
    cache = model.cache_defs(shape.global_batch, shape.seq_len)
    params = per_device(model.param_defs(),
                        param_pspecs(model.param_defs(), mesh, rules), mesh)
    cache = per_device(cache, param_pspecs(cache, mesh, rules), mesh)
    tokens = shape.global_batch * 4 // 16       # (B, 1) int32 over data
    mem = rec["memory"]
    assert mem["params_bytes"] == params
    assert mem["cache_bytes"] == cache
    assert mem["input_bytes"] == tokens + 4      # and the int32 position
    assert mem["argument_bytes"] == params + cache + tokens + 4


def test_dryrun_per_device_collectives_and_temp_bytes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3_2_1b", "--shape", "train_4k,prefill_32k", "--mesh",
         "single", "--quick-layers", "2", "--outdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for shape in ("train_4k", "prefill_32k"):
        rec = json.load(open(tmp_path / "pod256" /
                             f"llama3_2_1b__{shape}.json"))
        assert rec["status"] == "ok"
        mem = rec["memory"]
        assert mem["temp_bytes"] > 0 and "temp_bytes_reason" not in mem
        ar = rec["collectives"]["all_reduce"]
        assert ar["count"] > 0 and ar["bytes"] > 0
        assert ar["max_group"] == 16
    # Prefill: per layer one reduce of the rank's (B/16, S, d) bf16 rows
    # for attention and one for the MLP, and the embedding's; the last
    # position's logits gathered over the vocab blocks.
    rec = json.load(open(tmp_path / "pod256" /
                         "llama3_2_1b__prefill_32k.json"))
    act = 32 // 16 * 32768 * 2048 * 2
    assert rec["collectives"]["all_reduce"]["count"] == 1 + 2 * 2
    assert rec["collectives"]["all_reduce"]["bytes"] == act * (1 + 2 * 2)
    assert rec["collectives"]["all_gather"]["bytes"] == 2 * 128256 * 4


def test_global_flops_are_the_references_at_full_depth(tmp_path):
    from repro_torch.dist import abstract_mesh
    from repro_torch.launch.dryrun import run_cell

    mesh = abstract_mesh((16, 16), ("data", "model"))
    want = {"decode_32k": 866106998784, "train_4k": 1.233652046364672e16}
    for shape, flops in want.items():
        rec = run_cell("llama3_2_1b", shape, mesh, "pod256", str(tmp_path),
                       trace_only=True)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["global_cost"]["matmul_flops"] == flops


def _whole_blocks(self, mesh, tensors, rules=None, rank=None):
    """A wrong ``Model.local_params``: every rank keeps the whole tensors
    while the layout says they are split."""
    return dict(tensors)


@pytest.mark.parametrize("case", ["not_ported", "wrong_layout"])
def test_per_device_walk_refusal_and_fault(tmp_path, monkeypatch, case):
    """The fsdp profile's training cell (``not_ported``: the case that the
    dry run refused until the profile was ported) walks: the cell is
    ``ok`` with a positive ``temp_bytes``, an all-gather over the data
    group of 2 of each leaf in the forward and of each layer leaf again in
    remat's recompute, and a reduce-scatter of each leaf's gradient; a
    wrong layout in the per-device walk is a fault: the cell fails with
    the ``constrain`` error and its traceback."""
    from repro_torch.dist import abstract_mesh
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import Model

    mesh = abstract_mesh((2, 8), ("data", "model"))     # kv_heads split
    profile = "fsdp" if case == "not_ported" else "tp"
    if case == "wrong_layout":
        monkeypatch.setattr(Model, "local_params", _whole_blocks)
    shape = "train_4k" if case == "not_ported" else "prefill_32k"
    rec = run_cell("llama3_2_1b", shape, mesh, "2x8", str(tmp_path),
                   quick_layers=1, profile=profile)
    if case == "not_ported":
        assert rec["status"] == "ok", rec.get("error")
        assert rec["memory"]["temp_bytes"] > 0
        ag = rec["collectives"]["all_gather"]
        rs = rec["collectives"]["reduce_scatter"]
        # 1 layer of 9 leaves, the embedding, final norm and head, each
        # with an embed dim (zero1 moments: 1 layer does not split 2 ways).
        assert ag["count"] == 2 * 9 + 3 and ag["max_group"] == 2
        assert rs["count"] == 9 + 3 and rs["max_group"] == 2
    else:
        assert rec["status"] == "fail"
        assert rec["error"].startswith("ValueError: constrain"), rec["error"]
        assert "Traceback" in rec["traceback"]
