"""The decoder of the port (``repro/models/transformer.py``, dense and MoE
families).

Parameters keep the JAX package's layouts, so the reference's weights load
unchanged (``repro_torch.convert``): ``wq (d,H,dh)``, ``wk``/``wv``
``(d,K,dh)``, ``wo (H,dh,d)``, ``w_gate``/``w_up (d,f)``, ``w_down (f,d)``,
``embed.tok (vocab,d)``, ``head.w (d,vocab)``; an MoE layer holds
``moe.router (d,E)`` in f32 whatever ``cfg.dtype`` is, ``moe.w_gate``/
``moe.w_up (E,d,f)`` and ``moe.w_down (E,f,d)`` in place of ``mlp``.  The
serving engine (``serve/engine.py``) drives the layers itself under
``torch.no_grad``.  ``forward`` and ``loss`` are the training pass of the
dense family (``repro/models/transformer.py`` ``_dense_body``, ``_trunk``,
``loss``): whole-tensor layers, every attention through the flash kernels,
each layer under ``torch.utils.checkpoint`` when ``cfg.remat``.

Parameters are made with ``requires_grad=False``, so serving builds no
autograd graph.  Training hands ``loss`` its own leaves (``params``: the
state-dict names mapped to tensors that require grad, as
``train.step.value_and_grad`` makes them), so the module's own tensors
never need to be trainable.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import attention, chunked_lm_loss, norm, rope_freqs, swiglu
from .moe import CAPACITY_NOT_PORTED, MoEConfig

MOE_TRAINING_NOT_PORTED = (
    "training the MoE family is not ported yet: its gradient needs a "
    "grouped-FFN backward kernel (ROADMAP.md queue B item 6, with MoE "
    "training)")

_NOT_PORTED = {
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


class MoE(nn.Module):
    """Expert weights and the router, which stays f32 (``moe_defs``)."""

    def __init__(self, mc: MoEConfig, device, dtype):
        super().__init__()
        E, d, f = mc.padded_experts, mc.d_model, mc.d_ff
        self.router = _param((d, E), device, torch.float32)
        self.w_gate = _param((E, d, f), device, dtype)
        self.w_up = _param((E, d, f), device, dtype)
        self.w_down = _param((E, f, d), device, dtype)


class DecoderLayer(nn.Module):
    """rmsnorm, GQA attention, rmsnorm, then a SwiGLU ``mlp`` (dense) or
    ``moe`` (given ``moe_cfg``)."""

    def __init__(self, cfg: ModelConfig, device, dtype,
                 moe_cfg: Optional[MoEConfig] = None):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        self.ln1 = RMSNorm(d, device, dtype)
        self.attn = Attention(d, cfg.n_heads, cfg.kv_heads, dh, device,
                              dtype)
        self.ln2 = RMSNorm(d, device, dtype)
        if moe_cfg is None:
            self.mlp = MLP(d, cfg.d_ff, device, dtype)
        else:
            self.moe = MoE(moe_cfg, device, dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, device, dtype):
        super().__init__()
        self.tok = _param((vocab, d), device, dtype)


class Head(nn.Module):
    def __init__(self, d: int, vocab: int, device, dtype):
        super().__init__()
        self.w = _param((d, vocab), device, dtype)


class Model(nn.Module):
    """Decoder-only LM: embed -> n_layers x (rmsnorm, GQA attention,
    rmsnorm, SwiGLU or MoE) -> rmsnorm -> head.  Parameters are created on
    ``device`` (the card unless the caller asks for the CPU) in
    ``cfg.dtype`` (the MoE router in f32), uninitialised until ``init`` or
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        cfg.validate()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: "
                f"{_NOT_PORTED.get(cfg.family, 'ROADMAP.md queue A')} "
                f"brings it")
        self.moe_cfg: Optional[MoEConfig] = None
        if cfg.family == "moe":
            if cfg.moe_dispatch != "dropless":
                raise NotImplementedError(CAPACITY_NOT_PORTED)
            self.moe_cfg = MoEConfig(
                d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                dispatch=cfg.moe_dispatch, parallelism=cfg.moe_parallelism,
                ep_axis_size=cfg.moe_ep_axis_size)
        self.cfg = cfg
        self.device = resolve_device(device)
        dev, dt = self.device, cfg.dtype
        self.embed = Embed(cfg.vocab, cfg.d_model, dev, dt)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dev, dt, self.moe_cfg)
            for _ in range(cfg.n_layers))
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
        is the per-layer shape's [-2] too: d for the router, ``w_gate`` and
        ``w_up``, f for ``w_down``).  Drawn in f32 from ``generator``, then
        cast to each parameter's own dtype (the router stays f32); the bits
        differ from JAX's."""
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

    # ============================================================ training
    def _freqs(self, device) -> torch.Tensor:
        """The rope frequencies on ``device``, made once: a copy from host
        memory in every forward pass would wait for the card."""
        cache = self.__dict__.setdefault("_freqs_cache", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = rope_freqs(self.head_dim, self.cfg.rope_theta,
                                    device)
        return cache[key]

    def _layer_params(self, params: Mapping[str, torch.Tensor],
                      i: int) -> Dict:
        """Layer i's tensors of a state-dict-named mapping, nested as the
        JAX layer tree is."""
        pre = f"layers.{i}."
        return {
            "ln1": params[pre + "ln1.scale"],
            "attn": {w: params[f"{pre}attn.{w}"]
                     for w in ("wq", "wk", "wv", "wo")},
            "ln2": params[pre + "ln2.scale"],
            "mlp": {w: params[f"{pre}mlp.{w}"]
                    for w in ("w_gate", "w_up", "w_down")},
        }

    def _dense_body(self, lp: Mapping, x: torch.Tensor,
                    positions: torch.Tensor,
                    freqs: torch.Tensor) -> torch.Tensor:
        h = x + attention(lp["attn"], norm(lp["ln1"], x), positions, freqs,
                          window=self.cfg.window)
        return h + swiglu(lp["mlp"], norm(lp["ln2"], h))

    def forward(self, tokens: torch.Tensor,
                params: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The trunk: tokens (B, S) -> hidden (B, S, d) after the layer
        stack (before the final norm).  ``params`` maps state-dict names to
        the tensors to use (default: the module's own)."""
        if self.moe_cfg is not None:
            raise NotImplementedError(MOE_TRAINING_NOT_PORTED)
        P = dict(self.named_parameters()) if params is None else params
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        freqs = self._freqs(tokens.device)
        x = F.embedding(tokens.long(), P["embed.tok"])
        for i in range(self.cfg.n_layers):
            lp = self._layer_params(P, i)
            if self.cfg.remat:
                x = checkpoint(self._dense_body, lp, x, positions, freqs,
                               use_reentrant=False)
            else:
                x = self._dense_body(lp, x, positions, freqs)
        return x

    def loss(self, batch: Mapping[str, torch.Tensor],
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels`` (B, S),
        label -1 ignored) as an f32 scalar."""
        P = dict(self.named_parameters()) if params is None else params
        x = self.forward(batch["tokens"], P)
        x = norm(P["final_ln.scale"], x)
        return chunked_lm_loss(P["head.w"], x, batch["labels"])
