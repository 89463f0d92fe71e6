"""Core transformer layers of the port: RMSNorm, rotary embeddings, SwiGLU
MLP, embeddings and the LM head (``repro/models/layers.py``), with the same
f32 islands: rmsnorm computes in f32 and casts back, silu runs in f32, rope
angles are f32, and logits are cast to f32 after the head product.

Row invariance.  ``linear`` and ``rmsnorm`` run every call as tiles of
exactly ``ROW_TILE`` rows (``repro_torch.tiles``), so a row rounds the same
in a 4-row decode batch and a 512-row prefill.  Elementwise ops need no
such care.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..tiles import ROW_TILE, linear, row_tiles

F32 = torch.float32


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (R, d): f32 mean of squares per row (in ROW_TILE-row tiles), scale,
    cast back to x's dtype."""
    xp, R = row_tiles(x)
    xf = xp.to(F32)
    var = xf.new_empty((xf.shape[0], 1))
    for s in range(0, xf.shape[0], ROW_TILE):
        t = xf[s:s + ROW_TILE]
        torch.mean(t * t, dim=-1, keepdim=True, out=var[s:s + ROW_TILE])
    y = xf[:R] * torch.rsqrt(var[:R] + eps)
    return (y * scale.to(F32)).to(x.dtype)


def rope_freqs(dh: int, theta: float, device) -> torch.Tensor:
    """(dh/2,) f32 rotary frequencies, computed in numpy as the JAX package
    computes them, on ``device``.  Callers make them once: a copy from host
    memory inside the forward pass would wait for the device."""
    half = dh // 2
    freqs = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(freqs).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         freqs: torch.Tensor) -> torch.Tensor:
    """x: (R, H, dh); positions: (R,); freqs: ``rope_freqs(dh, ...)``."""
    half = x.shape[-1] // 2
    angles = positions.to(F32)[:, None] * freqs            # (R, half)
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x Wg) * (x Wu)) Wd with silu in f32.  x: (R, d)."""
    g = linear(x, w_gate)
    u = linear(x, w_up)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return linear(h, w_down)


def embed(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return tok[tokens.long()]


def lm_head(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (R, d) -> f32 logits (R, vocab)."""
    return linear(x, w).to(F32)
