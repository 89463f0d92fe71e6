"""Checkpoint/restart with atomic manifests and async save, in the JAX
package's on-disk layout (``repro/ckpt/checkpoint.py``), so a checkpoint
written by either package restores in the other.

Layout:  <dir>/step_<N>/manifest.json + one .npy per leaf, named by a hash
of the leaf's path.  Writes go to ``step_<N>.tmp`` and are renamed into
place only after the manifest is fsync'd, so a torn save is never taken
for a checkpoint, and restart picks the newest complete step.

Trees are nested dicts; their leaves are numpy arrays, tensors (copied to
the host) or scalars, flattened with keys sorted at every level as JAX
flattens a dict.  bfloat16 has no numpy dtype without ml_dtypes (the
card's machine has none): it is written as the 2-byte void ``|V2`` with
the manifest's dtype ``"bfloat16"`` (as JAX writes it), and read back as
``|V2``, which ``convert.params_from_numpy`` turns into bfloat16 tensors.

``AsyncCheckpointer`` copies the tree to the host at once and writes it
on a background thread; ``wait()`` joins before the next save.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..convert import params_from_numpy, to_numpy

Tree = Any
_BF16_VOID = np.dtype("V2")


def _leaf_name(path_str: str) -> str:
    return hashlib.sha1(path_str.encode()).hexdigest()[:16] + ".npy"


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return to_numpy(leaf)
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return "bfloat16"
    return str(arr.dtype)


def _load_leaf(base: str, entry: Dict) -> np.ndarray:
    arr = np.load(os.path.join(base, entry["file"]))
    if arr.dtype.kind == "V":
        if entry["dtype"] != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"checkpoint leaf {entry['path']!r}: no reader "
                             f"for {entry['dtype']} stored as {arr.dtype}")
        arr = arr.view(_BF16_VOID)
    return arr


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        name = f"{prefix}/{key}" if prefix else str(key)
        out.extend(_flatten(tree[key], name))
    return out


def save(directory: str, step: int, tree: Tree,
         extra_meta: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "meta": extra_meta or {}}
    for name, leaf in _flatten(tree):
        arr = _host(leaf)
        fname = _leaf_name(name)
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": name, "file": fname, "shape": list(arr.shape),
             "dtype": _dtype_name(arr)})
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            man = os.path.join(directory, name, "manifest.json")
            if os.path.exists(man):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def restore(directory: str, step: Optional[int] = None,
            shardings: Optional[Mapping[str, Any]] = None
            ) -> Tuple[Dict[str, Any], Dict]:
    """(tree of numpy leaves, meta) of ``step`` (default the newest).  0-d
    leaves come back as numpy scalars, as the JAX package's restore gives
    them.

    ``shardings`` maps a subtree's key (``"params"``) to the
    ``models.common.param_shardings`` of its tensors: that subtree comes
    back as a state dict (port tensor names, the stacked leaves split per
    layer by ``convert.params_from_numpy``) of ``DTensor``s of each
    rank's block, on the mesh's device; tensors outside this rank's layer
    range are left out, and those of a stack split over ranks
    (``layers -> data``) come back as plain tensors of the block
    (``LeafSharding.place``).  The checkpoint on disk stays unsharded."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    step = step if step is not None else steps[-1]
    base = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for e in manifest["leaves"]:
        parts = e["path"].split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        arr = _load_leaf(base, e)
        cur[parts[-1]] = arr[()] if arr.shape == () else arr
    for key, shards in (shardings or {}).items():
        state = params_from_numpy(tree[key], device="cpu")
        placed = {}
        for name, t in state.items():
            if name not in shards:
                raise KeyError(f"checkpoint leaf {key}/{name}: no sharding")
            dt = shards[name].place(t)
            if dt is not None:
                placed[name] = dt
        tree[key] = placed
    return tree, {"step": manifest["step"], **manifest.get("meta", {})}


class AsyncCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: List[int] = []

    def save_async(self, step: int, tree: Tree,
                   extra_meta: Optional[Dict] = None):
        self.wait()
        # Snapshot to the host now (the copies block), write in the
        # background.
        host_tree = _map(tree, _host)

        def _work():
            save(self.directory, step, host_tree, extra_meta)
            self.saved.append(step)
            self._gc()

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = available_steps(self.directory)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _map(tree: Tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)
