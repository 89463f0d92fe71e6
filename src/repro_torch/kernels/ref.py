"""Plain PyTorch versions of the port's kernels — the oracles the CPU tests
assert against, the path a CPU tensor takes through ``kernels.ops``, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.

Layouts are the JAX package's (``repro/kernels/ref.py``).  Attention
(``mha_reference``): q ``(B, Sq, H, dh)``, k/v ``(B, Sk, K, dh)`` with GQA,
scores and softmax in f32; its gradient is plain autograd through it.
Paged attention:
q ``(B, H, dh)``, pools ``(N, P, K, dh)``, page table ``(B, MP)`` int32
with -1 for an unused slot, lengths ``(B,)``; scores, softmax and the
weighted sum run in f32.  Grouped-expert FFN: x ``(T, d)`` sorted by group,
weights ``(E, d, f)`` / ``(E, f, d)``, everything after the inputs in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..tiles import linear, row_tiles

F32 = torch.float32
NEG_INF = -1e30


def mha_reference(q, k, v, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Exact softmax attention.  q: (B,Sq,H,dh); k/v: (B,Sk,K,dh), GQA.

    Causal masking puts query row i at position ``i + Sk - Sq``; a window
    applies only under causal.  Masked scores are ``NEG_INF`` (-1e30), not
    -inf, so a causal row that sees no key (only when Sq > Sk) gets the
    mean of V over all Sk keys, as the JAX oracle gives it."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Sq, K, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32), k.to(F32)) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(F32))
    return o.reshape(B, Sq, H, dh).to(q.dtype)


def paged_attention_reference(q, k_pool, v_pool, page_table, lengths,
                              window: Optional[int] = None) -> torch.Tensor:
    """Decode-time attention over paged KV.

    q: (B, H, dh) — one new token per sequence.
    k_pool/v_pool: (N_pages, P, K, dh) — one layer's HBM page pool.
    page_table: (B, MP) int32 — pool slot per logical page, -1 = unused.
    lengths: (B,) int32 — tokens so far (including the new one).
    """
    B, H, dh = q.shape
    N, P, K, _ = k_pool.shape
    MP = page_table.shape[1]
    G = H // K
    scale = 1.0 / math.sqrt(dh)

    table = page_table.long()
    safe = table.clamp(min=0)
    k = k_pool[safe].reshape(B, MP * P, K, dh)     # (B, MP*P, K, dh)
    v = v_pool[safe].reshape(B, MP * P, K, dh)
    pos = torch.arange(MP * P, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = (pos < lens) & torch.repeat_interleave(table >= 0, P, dim=1)
    if window is not None:
        valid &= (lens - 1 - pos) < window

    qg = q.reshape(B, K, G, dh).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(F32)) * scale
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, v.to(F32))
    # A row with no visible position (a padded prefill row, length 0) is
    # zeros, as the kernels write it, not the mean of V a softmax over
    # all-masked scores gives.
    o = torch.where(valid.any(-1)[:, None, None, None], o, 0.0)
    return o.reshape(B, H, dh).to(q.dtype)


def paged_prefill_reference(q, k_pool, v_pool, page_table, lengths,
                            window: Optional[int] = None) -> torch.Tensor:
    """One-shot prompt attention over paged KV: the S prompt tokens of ONE
    sequence as S query rows over the same page table, row t's causal
    visibility carried by ``lengths[t]`` (t+1 for real tokens, 0 for
    padded rows).  Delegates to the decode oracle with the table broadcast
    across rows, so it computes the same function as stepping the tokens
    through decode one at a time.

    q: (S, H, dh); k_pool/v_pool: (N, P, K, dh); page_table: (MP,) int32
    (-1 = unused); lengths: (S,) int32.  Returns (S, H, dh).
    """
    S = q.shape[0]
    table = page_table[None, :].expand(S, page_table.shape[0])
    return paged_attention_reference(q, k_pool, v_pool, table, lengths,
                                     window=window)


def moe_grouped_ffn_reference(x, w_gate, w_up, w_down, group_sizes,
                              group_experts=None) -> torch.Tensor:
    """Grouped-expert SwiGLU over sorted ragged segments.

    x: (T, d) rows sorted by group, segment g holding ``group_sizes[g]``
    consecutive rows (empty groups allowed); w_gate/w_up: (E, d, f);
    w_down: (E, f, d); group_experts: optional (G,) int32 map from group
    to the weight row it multiplies (None means G == E, group g uses
    expert g).  Row r of segment g is
    ``(silu(x_r Wg[e]) * (x_r Wu[e])) Wd[e]`` with e the group's expert,
    x and the weights read as f32, h kept in f32, the down product in f32
    and the result cast to x's dtype.  Rows past ``sum(group_sizes)`` are
    zeros.

    Each segment runs through ``tiles.linear`` (fixed ROW_TILE-row
    products), so a row's result depends on that row and its expert alone,
    not on T or on the other groups — unlike the JAX oracle's dense
    all-experts einsum, whose rounding depends on T.  silu runs over whole
    zero-padded tiles too: a CPU elementwise loop computes its last few
    elements on a scalar path whose exp rounds differently, and a tile of
    ROW_TILE * f elements (f even) has no such tail.  Reads the group sizes
    on the host: the plain version, not a path for CUDA tensors.
    """
    T, d = x.shape
    G = group_sizes.shape[0]
    if group_experts is None:
        if G != w_gate.shape[0]:
            raise ValueError(f"{G} groups over {w_gate.shape[0]} experts "
                             f"need a group_experts map")
        experts = list(range(G))
    else:
        experts = [int(e) for e in group_experts.tolist()]
    out = torch.zeros((T, d), dtype=F32, device=x.device)
    start = 0
    for g, n in enumerate(int(n) for n in group_sizes.tolist()):
        if n <= 0:
            continue
        e = experts[g]
        rows, _ = row_tiles(x[start:start + n].to(F32))
        h = F.silu(linear(rows, w_gate[e].to(F32))) * linear(
            rows, w_up[e].to(F32))
        out[start:start + n] = linear(h, w_down[e].to(F32))[:n]
        start += n
    return out.to(x.dtype)
