"""Carry the JAX package's configs and weights across to the port.

The JAX side hands over plain data — a config object read by attribute and
a parameter tree of numpy arrays (``jax.tree.map(np.asarray, params)``) —
so this module imports neither JAX nor ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy-compatible dtype (``jnp.bfloat16``,
    ``np.float32``, ...), matched by name."""
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"no torch dtype for {name!r}")
    return _DTYPES[name]


def config_from_reference(cfg: Any) -> ModelConfig:
    """A port ``ModelConfig`` from a ``repro`` ``ModelConfig``, field by
    field; the dtype maps by ``np.dtype(...).name``."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        value = getattr(cfg, f.name)
        kw[f.name] = torch_dtype(value) if f.name == "dtype" else value
    return ModelConfig(**kw)


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a numpy array (bfloat16 as ml_dtypes
    gives it, or as the 2-byte void ``|V2`` that a checkpoint holds when
    ml_dtypes is absent) or from a tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; bfloat16 (which numpy lacks) becomes the
    2-byte void dtype ``|V2`` with the same bits, which ``np.save`` writes
    as the JAX package writes bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view(np.dtype("V2"))
    return t.numpy().copy()


def _stacked(key: str) -> bool:
    """Is a top-level key of the JAX tree a layer stack (``layers``,
    ``ssm_layers``, ...), whose leaves carry a leading layer axis?"""
    return key == "layers" or key.endswith("_layers")


def jax_path(name: str) -> Tuple[str, Optional[int]]:
    """The JAX tree path and layer index of a port state-dict name:
    ``layers.3.attn.wq`` -> (``layers/attn/wq``, 3),
    ``ssm_layers.80.ssm.w_z`` -> (``ssm_layers/ssm/w_z``, 80), ``embed.tok``
    -> (``embed/tok``, None)."""
    parts = name.split(".")
    if _stacked(parts[0]):
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def jax_order(names) -> List[str]:
    """Port state-dict names in JAX's leaf order (dict keys sorted at every
    level), the layers of a stacked leaf in index order."""
    def key(name):
        path, layer = jax_path(name)
        return path.split("/"), -1 if layer is None else layer

    return sorted(names, key=key)


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{name}.")
        else:
            yield name, value


def params_from_numpy(tree: Mapping, device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the JAX package's param tree (numpy
    leaves).  Layer-stacked leaves (``layers/<...>``, ``ssm_layers/<...>``)
    of shape ``(L, ...)`` split into ``<stack>.<i>.<...>``; unstacked
    subtrees (``shared_attn``, ``embed``, ...) pass through; every layout is
    kept.  Load with ``Model.load_state_dict``."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree):
        t = _to_tensor(leaf, dev)
        stack, _, rest = name.partition(".")
        if _stacked(stack):
            for i in range(t.shape[0]):
                out[f"{stack}.{i}.{rest}"] = t[i].clone()
        else:
            out[name] = t
    return out


def params_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the JAX package's nested tree
    of numpy leaves from a port state dict, ``<stack>.<i>.<...>`` stacked
    into ``<stack>/<...>`` of shape ``(L, ...)``.  bfloat16 leaves come out
    as ``|V2`` (``to_numpy``)."""
    stacked: Dict[str, Dict[int, torch.Tensor]] = {}
    flat: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        path, layer = jax_path(name)
        if layer is None:
            flat[path] = t
        else:
            stacked.setdefault(path, {})[layer] = t
    for path, layers in stacked.items():
        flat[path] = torch.stack([layers[i].detach().cpu()
                                  for i in range(len(layers))])
    tree: Dict[str, Any] = {}
    for path in sorted(flat, key=lambda p: p.split("/")):
        cur = tree
        parts = path.split("/")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = to_numpy(flat[path])
    return tree
