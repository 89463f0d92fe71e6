"""Core transformer layers of the port: RMSNorm, rotary embeddings, SwiGLU
MLP, embeddings and the LM head (``repro/models/layers.py``), with the same
f32 islands: rmsnorm computes in f32 and casts back, silu runs in f32, rope
angles are f32, and logits are cast to f32 after the head product.

Row invariance.  ``linear`` and ``rmsnorm`` run every call as tiles of
exactly ``ROW_TILE`` rows (``repro_torch.tiles``), so a row rounds the same
in a 4-row decode batch and a 512-row prefill.  Elementwise ops need no
such care.  ``rmsnorm`` writes through ``out=``, which autograd refuses:
row invariance is a serving invariant that training does not need.
``linear`` has a gradient, for the MoE router, which routes through it
in training as in serving.

Training forms.  ``norm``, ``project``, ``attention``, ``swiglu``,
``cross_entropy`` and ``chunked_lm_loss`` (``repro/models/layers.py``
``rmsnorm``, the einsums, ``attention``, ``mlp``, ``cross_entropy``,
``chunked_lm_loss``) run on whole tensors and are differentiable;
attention goes through ``kernels.ops.flash_attention`` (the hand-written
forward and backward kernels on the card).  Contiguous-cache serving
uses them too, with ``attention_decode`` for one token against a
contiguous KV cache, ``attention_decode_ring`` against a sliding-window
arch's ring of ``window`` slots and ``cross_attention_decode`` against an
encoder's memory.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..tiles import ROW_TILE, linear, row_tiles

F32 = torch.float32
NEG_INF = -1e30


def param(shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter that needs no gradient: serving builds
    no autograd graph, and training makes its own leaves."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


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


# ------------------------------------------------------------ training forms
def norm(scale: torch.Tensor, x: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of a whole tensor, differentiable: f32
    mean of squares, scale, cast back to x's dtype."""
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


def project(x: torch.Tensor, w: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Contract x's last ``k`` axes with w's first ``k`` axes (the JAX
    package's einsums ``bsd,dhk->bshk`` with k=1 and ``bshk,hkd->bsd`` with
    k=2) as one whole matrix product."""
    din = int(np.prod(w.shape[:k]))
    y = torch.matmul(x.reshape(*x.shape[:x.dim() - k], din),
                     w.reshape(din, -1))
    return y.reshape(*x.shape[:x.dim() - k], *w.shape[k:])


def attention(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              positions: torch.Tensor, freqs: torch.Tensor,
              window: Optional[int] = None,
              kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention for training and prefill (``repro/models/layers.py``
    ``attention``): x (B, S, d); p holds ``wq`` (d,H,dh), ``wk``/``wv``
    (d,K,dh) and ``wo`` (H,dh,d); positions (S,).  Self-attention (no
    ``kv_x``): QKV, rope, ``ops.flash_attention`` causal with the window,
    then ``wo``.  It is causal whatever the caller's config says, as the
    reference's ``_mask`` is, the encoder's included.  Cross attention
    (``kv_x`` (B, Sk, d), the encoder's output): q from x and k, v from
    ``kv_x``, no rope, ``ops.flash_attention`` unmasked over all Sk keys
    (Sk need not be S)."""
    if kv_x is not None:
        q = project(x, p["wq"])
        k = project(kv_x, p["wk"])
        v = project(kv_x, p["wv"])
        out = ops.flash_attention(q, k, v, causal=False)
        return project(out, p["wo"], k=2)
    q = rope(project(x, p["wq"]), positions, freqs)
    k = rope(project(x, p["wk"]), positions, freqs)
    v = project(x, p["wv"])
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    return project(out, p["wo"], k=2)


def attention_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     freqs: torch.Tensor, window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """One-token decode against a contiguous KV cache
    (``repro/models/layers.py`` ``attention_decode``): x (B, 1, d);
    cache_k/v (B, S_max, K, dh), written in place at ``pos`` with this
    token's roped k and v.  Scores over the keys at positions <= pos (and
    inside the window, if any) in f32, softmax, the product with V in f32,
    a cast to x's dtype, then ``wo``.  With ``ring``, the cache is a ring
    (``attention_decode_ring``).  Plain torch: the JAX package has no
    kernel here.  Returns y (B, 1, d)."""
    B, S_max, K, dh = cache_k.shape
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(project(x, p["wq"]), positions, freqs)          # (B,1,H,dh)
    k1 = rope(project(x, p["wk"]), positions, freqs)
    v1 = project(x, p["wv"])
    slot = pos % S_max if ring else pos
    cache_k[:, slot] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v1[:, 0].to(cache_v.dtype)
    H = q.shape[2]
    qg = q.reshape(B, K, H // K, dh).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.to(F32))
    s = s * (1.0 / np.sqrt(dh))
    k_pos = torch.arange(S_max, device=x.device)
    allowed = k_pos <= pos
    if window is not None and not ring:
        allowed &= (pos - k_pos) < window
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, cache_v.to(F32)).to(x.dtype)
    return project(o.reshape(B, 1, H, dh), p["wo"], k=2)


def attention_decode_ring(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, freqs: torch.Tensor) -> torch.Tensor:
    """One-token decode against the ring KV cache of a sliding-window arch
    (``repro/models/layers.py`` ``attention_decode_ring``): cache_k/v (B,
    W, K, dh), this token's roped k and v written at slot pos % W.  Keys
    are stored roped at their absolute positions, so the ring needs no
    rotation; until the ring fills (pos < W - 1) only slots <= pos hold
    data, after that every slot is inside the window.  Returns y (B, 1,
    d)."""
    return attention_decode(p, x, cache_k, cache_v, pos, freqs, ring=True)


def cross_attention_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                           mem_k: torch.Tensor,
                           mem_v: torch.Tensor) -> torch.Tensor:
    """Decode-time cross attention over the encoder memory
    (``repro/models/layers.py`` ``cross_attention_decode``): x (B, 1, d);
    mem_k/mem_v (B, Se, K, dh), every row attended.  Scores in f32, no
    rope, softmax, the product with V in f32, a cast to x's dtype, then
    ``wo``.  Plain torch: the JAX package has no kernel here.  Returns y
    (B, 1, d)."""
    B = x.shape[0]
    K, dh = mem_k.shape[2], mem_k.shape[3]
    q = project(x, p["wq"])                                  # (B,1,H,dh)
    H = q.shape[2]
    qg = q.reshape(B, K, H // K, dh).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, mem_k.to(F32)) / np.sqrt(dh)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, mem_v.to(F32)).to(x.dtype)
    return project(o.reshape(B, 1, H, dh), p["wo"], k=2)


def swiglu(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU for training, silu in f32: x (B, S, d)."""
    g = project(x, p["w_gate"])
    u = project(x, p["w_up"])
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return project(h, p["w_down"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1) -> torch.Tensor:
    """Mean CE over non-ignored positions.  logits f32 (B, S, V)."""
    nll, count = _nll_sum(logits, labels, ignore)
    return nll / torch.clamp(count, min=1)


def _nll_sum(logits, labels, ignore: int):
    mask = labels != ignore
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_lm_loss(head_w: torch.Tensor, x: torch.Tensor,
                    labels: torch.Tensor, ignore: int = -1,
                    chunk: int = 512) -> torch.Tensor:
    """LM head + CE without materialising (B, S, V) f32 logits: the
    sequence runs in chunks of ``chunk`` positions (one chunk when S is
    not a multiple), each under ``torch.utils.checkpoint``, so a chunk's
    logits are recomputed in the backward instead of stored.  Returns the
    mean NLL over non-ignored positions."""
    B, S, _ = x.shape
    n = max(1, S // chunk) if S % chunk == 0 else 1
    c = S // n

    def one(xc, lc):
        # The head product in x's dtype, then f32, as the JAX head does.
        return _nll_sum(project(xc, head_w).to(F32), lc, ignore)

    nll, count = 0.0, 0
    for i in range(n):
        part, cnt = checkpoint(one, x[:, i * c:(i + 1) * c],
                               labels[:, i * c:(i + 1) * c],
                               use_reentrant=False)
        nll, count = nll + part, count + cnt
    return nll / torch.clamp(count, min=1)

