"""The dense decoder of the port (``repro/models/transformer.py``, dense
family).

Parameters keep the JAX package's layouts, so the reference's weights load
unchanged (``repro_torch.convert``): ``wq (d,H,dh)``, ``wk``/``wv``
``(d,K,dh)``, ``wo (H,dh,d)``, ``w_gate``/``w_up (d,f)``, ``w_down (f,d)``,
``embed.tok (vocab,d)``, ``head.w (d,vocab)``.  The serving engine
(``serve/engine.py``) drives the layers itself, so the module holds
parameters and their initialisation and leaves the forward pass to it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from .config import ModelConfig

_NOT_PORTED = {
    "moe": "ROADMAP.md queue A item 6 (MoE)",
    "hybrid": "ROADMAP.md queue A item 10 (other families)",
    "xlstm": "ROADMAP.md queue A item 10 (other families)",
    "encdec": "ROADMAP.md queue A item 10 (other families)",
    "vlm": "ROADMAP.md queue A item 10 (other families)",
}


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device, dtype):
        super().__init__()
        self.scale = _param((d,), device, dtype)


class Attention(nn.Module):
    def __init__(self, d: int, H: int, K: int, dh: int, device, dtype):
        super().__init__()
        self.wq = _param((d, H, dh), device, dtype)
        self.wk = _param((d, K, dh), device, dtype)
        self.wv = _param((d, K, dh), device, dtype)
        self.wo = _param((H, dh, d), device, dtype)


class MLP(nn.Module):
    def __init__(self, d: int, f: int, device, dtype):
        super().__init__()
        self.w_gate = _param((d, f), device, dtype)
        self.w_up = _param((d, f), device, dtype)
        self.w_down = _param((f, d), device, dtype)


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        self.ln1 = RMSNorm(d, device, dtype)
        self.attn = Attention(d, cfg.n_heads, cfg.kv_heads, dh, device,
                              dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        self.mlp = MLP(d, cfg.d_ff, device, dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, device, dtype):
        super().__init__()
        self.tok = _param((vocab, d), device, dtype)


class Head(nn.Module):
    def __init__(self, d: int, vocab: int, device, dtype):
        super().__init__()
        self.w = _param((d, vocab), device, dtype)


class Model(nn.Module):
    """Dense decoder-only LM: embed -> n_layers x (rmsnorm, GQA attention,
    rmsnorm, SwiGLU) -> rmsnorm -> head.  Parameters are created on
    ``device`` (the card unless the caller asks for the CPU) in
    ``cfg.dtype``, uninitialised until ``init`` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        cfg.validate()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: "
                f"{_NOT_PORTED.get(cfg.family, 'ROADMAP.md queue A')} "
                f"brings it")
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, cfg.dtype
        self.embed = Embed(cfg.vocab, cfg.d_model, dev, dt)
        self.layers = nn.ModuleList(
            DenseLayer(cfg, dev, dt) for _ in range(cfg.n_layers))
        self.final_ln = RMSNorm(cfg.d_model, dev, dt)
        self.head = Head(cfg.d_model, cfg.vocab, dev, dt)

    @property
    def head_dim(self) -> int:
        return self.cfg.resolved_head_dim

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """Random weights with the reference's statistics
        (``repro/models/common.py`` ``_leaf_init``): norm scales are ones,
        the embedding is N(0, 0.02), every other matrix N(0, 1/fan_in) with
        fan_in = shape[-2] (for the JAX package's layer-stacked leaves that
        is the per-layer shape's [-2] too).  Drawn in f32 from
        ``generator``, then cast; the bits differ from JAX's."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
                continue
            if name == "embed.tok":
                std = 0.02
            else:
                fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
                std = 1.0 / math.sqrt(max(fan_in, 1))
            w = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
            p.copy_((w * std).to(p.dtype))
        return self
