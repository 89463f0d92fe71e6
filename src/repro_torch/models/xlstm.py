"""xLSTM blocks of the port (``repro/models/xlstm.py``, arXiv:2405.04517):
mLSTM (matrix memory, parallelisable) and sLSTM (scalar memory, strictly
recurrent), plain torch: the JAX package has no Pallas kernel here.

mLSTM runs a chunkwise-parallel form for training and prefill
(decay-weighted attention within chunks of ``chunk`` positions, the
recurrent (C, n) state across them; each chunk under
``torch.utils.checkpoint`` when a gradient is taken, where JAX has
``jax.checkpoint``) and an O(1) recurrence for decode.  sLSTM is a time
loop with exponential gating and the max-stabiliser state.

The f32 islands are the JAX package's: the gate weights and biases
(``w_i``, ``w_f``, ``b_i``, ``b_f`` of the mLSTM; every ``w_*``, ``r_*``,
``b_*`` of the sLSTM) are f32 whatever the model's dtype is, the gates and
the states compute in f32, the input gate's exponent is clipped to
``ICLIP``, both normalisers are clamped by ``max(|n|, 1)``, and the sLSTM's
stabiliser m starts at 0, so that prefill and decode agree on it exactly
(the clamp makes the trajectory depend on the stabiliser).  The sLSTM's
four recurrent products run as one batched product over the gates
(``_slstm_cell``): each output entry is the same dot product JAX takes.

Tensor parallelism (``tp``, a model's ``TPLayout`` whose ``model`` axis
splits ``d_inner``): the mLSTM's ``w_up`` and ``w_z`` are the rank's
columns of ``d_inner``, and ``w_q``, ``w_k``, ``w_v``, ``w_i`` and ``w_f``
(``("d_inner", None)``) its rows, whose partial products are reduced over
the group: the recurrence runs on the whole q, k, v and gates on every
rank.  Its output enters the rank's columns again (``split_to_group``),
the norm's sum of squares over ``d_inner`` is reduced, and ``w_down`` is
row-parallel.  A decode state block splits the key dim of C and n where
the cache's ``d_inner`` entry does: the rank's rows of the products over
it are reduced.  The sLSTM's gates stay whole; its FFN ``w_ff1`` /
``w_ff2`` is column- / row-parallel over ``mlp``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.collectives import (copy_to_group, reduce_from_group,
                                split_to_group)
from ..dist.sharding import NO_TP, TPLayout
from .layers import param, project

F32 = torch.float32
ICLIP = 5.0                 # input-gate exponent clip
GATES = ("i", "f", "z", "o")

SLSTMState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0          # mLSTM up-projection
    slstm_ff_factor: float = 4.0 / 3.0
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


class MLSTM(nn.Module):
    """The parameters of one mLSTM block (``mlstm_defs``): projections and
    ``norm`` in the model's dtype, the gates' ``w_i``, ``w_f``, ``b_i`` and
    ``b_f`` in f32 (``b_f`` initialised to ones by ``Model.init``)."""

    def __init__(self, cfg: XLSTMConfig, device, dtype):
        super().__init__()
        d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
        self.w_up = param((d, di), device, dtype)
        self.w_z = param((d, di), device, dtype)
        self.w_q = param((di, di), device, dtype)
        self.w_k = param((di, di), device, dtype)
        self.w_v = param((di, di), device, dtype)
        self.w_i = param((di, H), device, F32)
        self.w_f = param((di, H), device, F32)
        self.b_i = param((H,), device, F32)
        self.b_f = param((H,), device, F32)
        self.norm = param((di,), device, dtype)
        self.w_down = param((di, d), device, dtype)


class SLSTM(nn.Module):
    """The parameters of one sLSTM block (``slstm_defs``): per gate g in
    i, f, z, o the input weights ``w_g`` (d, H, dh), the recurrent
    ``r_g`` (H, dh, dh) and the bias ``b_g`` (H, dh), all f32; ``norm``
    (declared by the reference and never read, so its gradient is zero) and
    the gated FFN ``w_ff1`` (d, ff), ``w_ff2`` (ff, d) in the model's
    dtype."""

    def __init__(self, cfg: XLSTMConfig, device, dtype):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        dh = d // H
        ff = int(d * cfg.slstm_ff_factor)
        for g in GATES:
            setattr(self, f"w_{g}", param((d, H, dh), device, F32))
            setattr(self, f"r_{g}", param((H, dh, dh), device, F32))
            setattr(self, f"b_{g}", param((H, dh), device, F32))
        self.norm = param((d,), device, dtype)
        self.w_ff1 = param((d, ff), device, dtype)
        self.w_ff2 = param((ff, d), device, dtype)


def _scaled_norm(y: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype, group=None,
                 width: int = 0) -> torch.Tensor:
    """The mLSTM's output norm: f32 mean of squares over the last axis,
    eps 1e-6, times ``scale``, cast to ``dtype``.  Under tensor
    parallelism y holds the rank's columns of the whole ``width``: the
    sum of squares is reduced over ``group`` (its gradient too)."""
    yf = y.to(F32)
    if group is None:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    else:
        ss = torch.sum(torch.square(yf), dim=-1, keepdim=True)
        var = copy_to_group(reduce_from_group(ss, group), group) / width
    return (yf * torch.rsqrt(var + 1e-6) * scale).to(dtype)


def _mlstm_inputs(p, x: torch.Tensor, cfg: XLSTMConfig, group=None):
    """z (B, S, d_inner: the rank's columns under tensor parallelism) and
    q, k, v (B, S, H, dh), whole, in x's dtype, the clipped input gate and
    the forget gate's log-sigmoid (B, S, H) in f32.  Under tensor
    parallelism x enters ``group`` and the row-parallel products are
    reduced over it."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    x = copy_to_group(x, group)
    up = project(x, p.w_up)
    z = project(x, p.w_z)
    q = reduce_from_group(project(up, p.w_q), group).reshape(B, S, H, dh)
    k = reduce_from_group(project(up, p.w_k), group).reshape(B, S, H, dh)
    v = reduce_from_group(project(up, p.w_v), group).reshape(B, S, H, dh)
    upf = up.to(F32)
    ig = torch.clamp(reduce_from_group(project(upf, p.w_i), group) + p.b_i,
                     -ICLIP, ICLIP)
    flog = F.logsigmoid(reduce_from_group(project(upf, p.w_f), group)
                        + p.b_f)
    return z, q, k, v, ig, flog


def _mlstm_out(p, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
               cfg: XLSTMConfig, group, rank: int) -> torch.Tensor:
    """The mLSTM's output from its whole recurrence output y (B, S,
    d_inner): gated by silu(z), normed, ``w_down``; under tensor
    parallelism on the rank's columns, ``w_down`` row-parallel."""
    y = split_to_group(y, group, rank)
    y = y.to(x.dtype) * F.silu(z.to(F32)).to(x.dtype)
    y = _scaled_norm(y, p.norm, x.dtype, group, cfg.d_inner)
    return reduce_from_group(project(y, p.w_down), group)


def _mlstm_chunk(qc, kc, vc, ic, fc, C, n, scale: float):
    """One chunk of the chunkwise-parallel mLSTM (the reference's scan
    ``step``): qc/kc/vc (B, Q, H, dh), ic/fc (B, Q, H) f32, the carried
    state C (B, H, dh, dh) and n (B, H, dh) f32.  Returns (y (B, Q, H, dh)
    f32, C, n)."""
    Q = qc.shape[1]
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=qc.device).tril()
    fcum = torch.cumsum(fc, dim=1)                          # (B,Q,H)
    ftot = fcum[:, -1]
    # D[i,j] = exp(fcum_i - fcum_j + i_j), j <= i: the exponent is masked,
    # not the result, so no inf reaches the gradient.
    dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ic[:, None, :, :]
    dmat = torch.where(causal[None, :, :, None], dmat,
                       torch.full_like(dmat, -1e30))
    D = torch.exp(dmat)
    qf, kf, vf = qc.to(F32), kc.to(F32), vc.to(F32)
    s = torch.einsum("bihd,bjhd->bijh", qf, kf)
    s = s * scale * D                                       # (B,Q,Q,H)
    y_intra = torch.einsum("bijh,bjhd->bihd", s, vf)
    decay_i = torch.exp(fcum)
    qs = qf * scale
    y_off = torch.einsum("bihd,bhde,bih->bihe", qs, C, decay_i)
    n_off = torch.einsum("bihd,bhd,bih->bih", qs, n, decay_i)[..., None]
    y = y_intra + y_off
    nvec = torch.einsum("bijh->bih", s)[..., None] + n_off
    y = y / torch.clamp(torch.abs(nvec), min=1.0)
    dte = torch.exp(ftot[:, None, :] - fcum + ic)           # (B,Q,H)
    etot = torch.exp(ftot)
    C_new = etot[..., None, None] * C + torch.einsum(
        "bjhd,bjh,bjhe->bhde", kf, dte, vf)
    n_new = etot[..., None] * n + torch.einsum("bjhd,bjh->bhd", kf, dte)
    return y, C_new, n_new


def mlstm_parallel(p, x: torch.Tensor, cfg: XLSTMConfig,
                   return_state: bool = False, tp: TPLayout = NO_TP):
    """Chunkwise-parallel mLSTM (``mlstm_parallel``).  x: (B, S, d) ->
    (B, S, d); with ``return_state`` also the final C (B, H, dh, dh) and n
    (B, H, dh) in f32, for decode to continue (whole on every rank under
    tensor parallelism).  S must be at most the chunk or a multiple of
    it, as the reference asserts."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    Q = min(cfg.chunk, S)
    if S % Q:
        raise ValueError(f"mLSTM prefill of {S} positions: S must be at "
                         f"most the chunk ({cfg.chunk}) or a multiple of it")
    group = tp.over("d_inner", cfg.d_inner)
    z, q, k, v, ig, flog = _mlstm_inputs(p, x, cfg, group)
    scale = 1.0 / math.sqrt(dh)
    C = torch.zeros((B, H, dh, dh), dtype=F32, device=x.device)
    n = torch.zeros((B, H, dh), dtype=F32, device=x.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        args = (q[:, sl], k[:, sl], v[:, sl], ig[:, sl], flog[:, sl], C, n)
        if torch.is_grad_enabled():
            y, C, n = checkpoint(_mlstm_chunk, *args, scale,
                                 use_reentrant=False)
        else:
            y, C, n = _mlstm_chunk(*args, scale)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, cfg.d_inner)
    out = _mlstm_out(p, y, z, x, cfg, group, tp.rank)
    if return_state:
        return out, C, n
    return out


def mlstm_decode(p, x: torch.Tensor, C: torch.Tensor, n: torch.Tensor,
                 cfg: XLSTMConfig, tp: TPLayout = NO_TP):
    """One-token mLSTM step (``mlstm_decode``).  x: (B, 1, d); C (B, H,
    dh, dh) and n (B, H, dh) f32.  Returns (out (B, 1, d), C, n).  Under
    tensor parallelism C and n may be the rank's rows of their key dim
    (the cache's ``d_inner`` entry): the products over it are reduced."""
    B = x.shape[0]
    dh = cfg.head_dim
    group = tp.over("d_inner", cfg.d_inner)
    z, q, k, v, ig, flog = _mlstm_inputs(p, x, cfg, group)
    q1 = q[:, 0].to(F32) / math.sqrt(dh)
    k1, v1 = k[:, 0].to(F32), v[:, 0].to(F32)
    rows = tp.over("d_inner", dh)
    if rows is not None:                    # the rank's rows of C and n
        lo = tp.rank * C.shape[2]
        q1, k1 = (t[..., lo:lo + C.shape[2]] for t in (q1, k1))
    f1, i1 = torch.exp(flog[:, 0]), torch.exp(ig[:, 0])     # (B,H)
    C_new = f1[..., None, None] * C + i1[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k1, v1)
    n_new = f1[..., None] * n + i1[..., None] * k1
    y = reduce_from_group(torch.einsum("bhd,bhde->bhe", q1, C_new), rows)
    denom = torch.abs(reduce_from_group(
        torch.einsum("bhd,bhd->bh", q1, n_new), rows))[..., None]
    y = y / torch.clamp(denom, min=1.0)
    y = y.reshape(B, 1, cfg.d_inner)
    return _mlstm_out(p, y, z, x, cfg, group, tp.rank), C_new, n_new


def _slstm_cell(pre_t: torch.Tensor, R: torch.Tensor, bias: torch.Tensor,
                state: SLSTMState) -> SLSTMState:
    """One sLSTM step (``_slstm_cell``).  pre_t (B, 4, H, dh): the input
    preactivations of the gates i, f, z, o; R (H, dh, 4 dh): the four
    recurrent matrices side by side; bias (4, H, dh); state (c, n, h, m),
    each (B, H, dh) f32."""
    c, n, h, m = state
    B, _, H, dh = pre_t.shape
    rh = torch.bmm(h.transpose(0, 1), R)                    # (H,B,4dh)
    rh = rh.reshape(H, B, 4, dh).permute(1, 2, 0, 3)        # (B,4,H,dh)
    pre = pre_t + rh + bias
    ilog = torch.clamp(pre[:, 0], -ICLIP, ICLIP)
    flog = F.logsigmoid(pre[:, 1])
    m_new = torch.maximum(flog + m, ilog)
    i_s = torch.exp(ilog - m_new)
    f_s = torch.exp(flog + m - m_new)
    z_t = torch.tanh(pre[:, 2])
    o_t = torch.sigmoid(pre[:, 3])
    c_new = f_s * c + i_s * z_t
    n_new = f_s * n + i_s
    h_new = o_t * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_forward(p, x: torch.Tensor, cfg: XLSTMConfig,
                  state: Optional[SLSTMState] = None,
                  tp: TPLayout = NO_TP):
    """The sLSTM over the sequence (``slstm_forward``), then its gated FFN
    (tanh-approximated gelu in f32, as ``jax.nn.gelu``).  x: (B, S, d).
    ``state`` (c, n, h, m) defaults to zeros, m included.  Returns (out
    (B, S, d), final state).  Under tensor parallelism the FFN runs on the
    rank's columns of ``mlp`` and its row-parallel product is reduced."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    xf = x.to(F32)
    pre = torch.stack([project(xf, getattr(p, f"w_{g}")) for g in GATES],
                      dim=2)                                # (B,S,4,H,dh)
    R = torch.cat([getattr(p, f"r_{g}") for g in GATES], dim=-1)
    bias = torch.stack([getattr(p, f"b_{g}") for g in GATES])
    if state is None:
        zero = torch.zeros((B, H, dh), dtype=F32, device=x.device)
        state = (zero, zero, zero, zero)
    hs = []
    for t in range(S):
        state = _slstm_cell(pre[:, t], R, bias, state)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    group = tp.over("mlp", int(d * cfg.slstm_ff_factor))
    hff = project(copy_to_group(y, group), p.w_ff1)
    hff = F.gelu(hff.to(F32), approximate="tanh").to(x.dtype)
    return reduce_from_group(project(hff, p.w_ff2), group), state


def slstm_decode(p, x: torch.Tensor, state: SLSTMState, cfg: XLSTMConfig,
                 tp: TPLayout = NO_TP):
    """One-token sLSTM step (``slstm_decode``): ``slstm_forward`` over one
    position from ``state``."""
    return slstm_forward(p, x, cfg, state=state, tp=tp)
