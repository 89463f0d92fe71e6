"""The port's dry run through its CLI (``python -m
repro_torch.launch.dryrun``), as ``test_system.py``'s
``test_dryrun_cell_via_cli`` drives the JAX package's: one cell on the
single-pod mesh writes a JSON record with ``status: ok``, the 256 devices,
a ``global_cost``, and per-device ``argument_bytes`` equal to what the JAX
package's specs give the same arguments on its abstract mesh (parameters,
cache, tokens and position)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np

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
    assert rec["memory"]["temp_bytes"] is None
    assert "A20" in rec["memory"]["temp_bytes_reason"]

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
