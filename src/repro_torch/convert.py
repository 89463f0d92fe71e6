"""Carry the JAX package's configs and weights across to the port.

The JAX side hands over plain data — a config object read by attribute and
a parameter tree of numpy arrays (``jax.tree.map(np.asarray, params)``) —
so this module imports neither JAX nor ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

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


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":        # numpy has no native bf16
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{name}.")
        else:
            yield name, value


def params_from_numpy(tree: Mapping, device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the JAX package's dense param tree
    (numpy leaves).  Layer-stacked leaves ``layers/<...>`` of shape
    ``(L, ...)`` split into ``layers.<i>.<...>``; every layout is kept.
    Load with ``Model.load_state_dict``."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree):
        t = _to_tensor(leaf, dev)
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(t.shape[0]):
                out[f"layers.{i}.{rest}"] = t[i].clone()
        else:
            out[name] = t
    return out
