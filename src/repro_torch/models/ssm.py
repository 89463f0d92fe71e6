"""The Mamba2 (state-space duality) block of the port
(``repro/models/ssm.py``).

Prefill runs the chunked SSD algorithm: quadratic within chunks, linear
across them.  Every chunk's intra-chunk block comes from ONE
``kernels.ops.ssd_scan`` call over all chunks at once (the hand-written
kernel on the card, ``ref.ssd_reference`` on the CPU); the cross-chunk
recurrence runs here in torch, in chunk order.  Decode is the O(1)-per-token
recurrence.

Head and state conventions follow Mamba2: head dim P, state dim N, one B/C
group shared by all heads.  The f32 islands are the JAX package's:
``dt_bias``, ``a_log`` and ``D`` are f32 whatever the model's dtype is; dt
is a softplus clipped to ``[dt_min, dt_max * 100]``; silu runs in f32; the
grouped RMSNorm over d_inner uses eps 1e-6; the SSM state is f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .layers import param, project

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int          # expand * d_model
    head_dim: int = 64    # P
    state_dim: int = 64   # N
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


class SSM(nn.Module):
    """The parameters of one Mamba2 block (``ssm_defs``): projections in
    the model's dtype, ``dt_bias``, ``a_log`` and ``D`` in f32."""

    def __init__(self, cfg: SSMConfig, device, dtype):
        super().__init__()
        d, di, H, N = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.state_dim
        self.w_z = param((d, di), device, dtype)
        self.w_x = param((d, di), device, dtype)
        self.w_B = param((d, N), device, dtype)
        self.w_C = param((d, N), device, dtype)
        self.w_dt = param((d, H), device, dtype)
        self.dt_bias = param((H,), device, F32)
        self.a_log = param((H,), device, F32)
        self.D = param((H,), device, F32)
        self.conv_x = param((cfg.conv_width, di), device, dtype)
        self.norm = param((di,), device, dtype)
        self.w_out = param((di, d), device, dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds, in x's dtype.  x: (B,S,C);
    w: (W,C)."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[W - 1 - i]
    return out


def _inputs(p: SSM, u: torch.Tensor, cfg: SSMConfig):
    """The common projections of u (B,S,d): z, x, B, C in u's dtype and dt
    (B,S,H) in f32."""
    z = project(u, p.w_z)
    x = project(u, p.w_x)
    Bm = project(u, p.w_B)
    Cm = project(u, p.w_C)
    dt = project(u, p.w_dt).to(F32)
    dt = F.softplus(dt + p.dt_bias)
    dt = torch.clamp(dt, cfg.dt_min, cfg.dt_max * 100)
    return z, x, Bm, Cm, dt


def ssd_chunked(x, dt, A, Bm, Cm, cfg: SSMConfig,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B,S,H,P) already conv'd and activated; dt: (B,S,H) f32; A: (H,) f32
    negative; Bm/Cm: (B,S,N).  Returns y (B,S,H,P) f32 and the final state
    (B,H,N,P) f32.  The chunk is ``min(cfg.chunk, S)``; S must be a multiple
    of it."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(cfg.chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {Q}")
    nc = S // Q
    # Every chunk's intra-chunk block in one call: (B*nc, Q, ...) rows.
    y_diag = ops.ssd_scan(x.reshape(Bsz * nc, Q, H, P),
                          dt.reshape(Bsz * nc, Q, H), A,
                          Bm.reshape(Bsz * nc, Q, N),
                          Cm.reshape(Bsz * nc, Q, N))
    y_diag = y_diag.reshape(Bsz, nc, Q, H, P)

    # The carried state, in chunk order (the JAX package's ``step``).
    a = dt.reshape(Bsz, nc, Q, H) * A                    # log decay, < 0
    a_cum = torch.cumsum(a, dim=2)                       # (B,nc,Q,H)
    a_tot = a_cum[:, :, -1]                              # (B,nc,H)
    xdt = x.reshape(Bsz, nc, Q, H, P).to(F32) * dt.reshape(
        Bsz, nc, Q, H)[..., None]
    Bs = Bm.reshape(Bsz, nc, Q, N).to(F32)
    Cs = Cm.reshape(Bsz, nc, Q, N).to(F32)
    # Each chunk's own contribution to the state at its end:
    # s_chunk[h,n,p] = sum_j B_j[n] exp(a_tot - a_cum[j,h]) dt_j x_j[h,p].
    decay_to_end = torch.exp(a_tot[:, :, None, :] - a_cum)   # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", Bs,
                           decay_to_end[..., None] * xdt)
    s = (torch.zeros((Bsz, H, N, P), dtype=F32, device=x.device)
         if init_state is None else init_state.to(F32))
    starts = []
    for c in range(nc):
        starts.append(s)
        s = s_chunk[:, c] + torch.exp(a_tot[:, c])[..., None, None] * s
    s_prev = torch.stack(starts, dim=1)                  # (B,nc,H,N,P)
    y_off = torch.einsum("bcin,bchnp->bcihp", Cs, s_prev) * torch.exp(
        a_cum)[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y, s


def _gated_norm(y: torch.Tensor, z: torch.Tensor, p: SSM,
                dtype: torch.dtype) -> torch.Tensor:
    """y * silu(z), then the grouped RMSNorm over d_inner (eps 1e-6), then
    the output projection."""
    y = y * F.silu(z.to(F32)).to(dtype)
    var = torch.mean(torch.square(y.to(F32)), dim=-1, keepdim=True)
    y = (y.to(F32) * torch.rsqrt(var + 1e-6) * p.norm).to(dtype)
    return project(y, p.w_out)


def ssm_forward(p: SSM, u: torch.Tensor, cfg: SSMConfig,
                return_state: bool = False):
    """The whole Mamba2 block for prefill.  u: (B,S,d).

    With ``return_state`` also returns (conv_state (B, W-1, d_inner) in u's
    dtype, ssm_state (B,H,N,P) f32), so a decode loop continues exactly
    where the prefill left off.  The conv state holds the last W-1
    pre-conv inputs, zero rows in front when S < W-1."""
    B, S, _ = u.shape
    H, P = cfg.n_heads, cfg.head_dim
    z, x, Bm, Cm, dt = _inputs(p, u, cfg)
    x_pre = x                                   # pre-conv projections
    x = _causal_conv(x, p.conv_x)
    x = F.silu(x.to(F32)).to(u.dtype)
    xh = x.reshape(B, S, H, P)
    A = -torch.exp(p.a_log)
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg)
    y = y + xh.to(F32) * p.D[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner).to(u.dtype)
    out = _gated_norm(y, z, p, u.dtype)
    if return_state:
        W = cfg.conv_width
        conv_state = F.pad(x_pre, (0, 0, W - 1, 0))[:, S:]
        return out, conv_state, final_state
    return out


def ssm_decode(p: SSM, u: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor, cfg: SSMConfig):
    """One-token decode.  u: (B,1,d); conv_state: (B, W-1, d_inner);
    ssm_state: (B,H,N,P) f32.  Returns (y, conv_state, ssm_state), the
    states new tensors."""
    B = u.shape[0]
    H, P = cfg.n_heads, cfg.head_dim
    z, x, Bm, Cm, dt = _inputs(p, u, cfg)           # all (B,1,*)
    window = torch.cat([conv_state, x], dim=1)      # (B,W,d_inner)
    xc = torch.einsum("bwc,wc->bc", window, p.conv_x)
    new_conv = window[:, 1:]
    xc = F.silu(xc.to(F32)).to(u.dtype)
    xh = xc.reshape(B, H, P).to(F32)

    A = -torch.exp(p.a_log)                         # (H,)
    dt1 = dt[:, 0]                                  # (B,H)
    decay = torch.exp(dt1 * A)                      # (B,H)
    Bn = Bm[:, 0].to(F32)                           # (B,N)
    Cn = Cm[:, 0].to(F32)
    upd = torch.einsum("bn,bhp->bhnp", Bn, xh * dt1[..., None])
    new_state = decay[..., None, None] * ssm_state + upd
    y = torch.einsum("bn,bhnp->bhp", Cn, new_state)  # (B,H,P)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(B, 1, cfg.d_inner).to(u.dtype)
    return _gated_norm(y, z, p, u.dtype), new_conv, new_state
