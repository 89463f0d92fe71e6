"""Plain PyTorch versions of the port's kernels — the oracles the CPU tests
assert against, the path a CPU tensor takes through ``kernels.ops``, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.

Layouts are the JAX package's (``repro/kernels/ref.py``): q ``(B, H, dh)``,
pools ``(N, P, K, dh)``, page table ``(B, MP)`` int32 with -1 for an unused
slot, lengths ``(B,)``.  Scores, softmax and the weighted sum run in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

F32 = torch.float32
NEG_INF = -1e30


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
