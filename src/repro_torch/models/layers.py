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
``chunked_lm_loss``) are differentiable; attention goes through
``kernels.ops.flash_attention`` (the hand-written forward and backward
kernels on the card).

Tensor parallelism.  Given a model's ``TPLayout`` (``tp``; a mesh whose
``model`` axis has more than one rank, ``dist.sharding.tp_layout``) these
forms take each rank's local parameter blocks, as ``DEFAULT_RULES``
resolve them, and compute on local tensors (Megatron-LM's layout, which is where GSPMD puts the reference's
``constrain`` annotations): ``attention`` enters x into the group
(``copy_to_group``), projects QKV on the rank's heads, runs the flash
kernels on them and reduces ``wo``'s row-parallel product
(``reduce_from_group``); ``swiglu`` does the same over ``mlp``;
``embed_tokens`` looks up the rank's vocab rows and reduces;
``chunked_lm_loss`` takes a vocab-parallel cross-entropy, its maximum and
sum of exponentials reduced over the group and the gold logit from the rank
that holds it.  When ``kv_heads`` does not split (the GQA fallback) ``wk``
and ``wv`` are whole on every rank: each rank projects all K heads, its q
heads read the one their group maps to, and the two weights enter the
group so their gradient sums over it.  A dim the rules leave whole (a
count that does not divide) runs the meshless code; so does everything on
a model axis of one rank.  Cross attention projects its k and v from
the encoder's output on the rank's kv heads the same way
(``cross_attention_qkv``).  Contiguous-cache serving uses them too, with
``attention_decode`` for one token against a contiguous KV cache,
``attention_decode_ring`` against a sliding-window arch's ring of
``window`` slots and ``cross_attention_decode`` against an encoder's
memory; under a mesh against the rank's cache block, which holds its kv
heads, or, where the rules split ``kv_seq`` (``SeqSplit``), its positions:
each rank attends its keys and the partial attentions (``o``, ``m``,
``l``) are merged in rank order (``partial_attention``,
``dist.collectives.merge_partials``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.collectives import (all_gather_dim, all_reduce_max,
                                copy_to_group, gather_partials, group_size,
                                merge_partials, reduce_from_group)
from ..dist.sharding import NO_TP, TPLayout, constrain
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


def _kv_heads_read(Hl: int, tp: TPLayout):
    """The slice of kv heads that this rank's ``Hl`` q heads read when
    ``kv_heads`` stays whole (the GQA fallback): all of them fall in one
    group of H / K q heads."""
    G = tp.sizes["heads"] // tp.sizes["kv_heads"]
    if G % Hl:
        raise ValueError(f"{Hl} q heads a rank straddle the groups of {G} "
                         f"that share a kv head: no layout for kv_heads="
                         f"{tp.sizes['kv_heads']} on this model axis")
    lo = tp.rank * Hl // G
    return slice(lo, lo + 1)


def self_attention_qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                       positions: torch.Tensor, freqs: torch.Tensor,
                       tp: TPLayout = NO_TP):
    """(group, q, k, v, read) of causal self-attention over x (B, S, d):
    q (B, S, H, dh) roped, k roped and v (B, S, K, dh) on the kv heads
    this rank holds, and ``read`` the slice of them its q heads attend to
    (None: all).  Under tensor parallelism (``group`` not None) x enters
    the group, q is on the rank's heads and k, v on its kv heads, or, in
    the GQA fallback, on all K from the whole ``wk``/``wv``."""
    group = tp.over("heads")
    wk, wv, read = p["wk"], p["wv"], None
    if group is not None:
        x = copy_to_group(x, group)
        if tp.over("kv_heads") is None:
            wk, wv = copy_to_group(wk, group), copy_to_group(wv, group)
            read = _kv_heads_read(p["wq"].shape[1], tp)
    q = rope(project(x, p["wq"]), positions, freqs)
    k = rope(project(x, wk), positions, freqs)
    v = project(x, wv)
    constrain(q, ("batch", "seq", "heads", None), tp.sizes)
    return group, q, k, v, read


def cross_attention_qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                        kv_x: torch.Tensor, tp: TPLayout = NO_TP):
    """(group, q, k, v, read) of cross attention, as ``self_attention_qkv``
    gives them but without rope: q (B, S, H, dh) from x, k and v (B, Sk,
    K, dh) from the encoder's output ``kv_x``.  Under tensor parallelism
    both enter the group, q is on the rank's heads and k, v on its kv heads
    (or, in the GQA fallback, on all K from the whole ``wk``/``wv``, of
    which its heads read ``read``)."""
    group = tp.over("heads")
    wk, wv, read = p["wk"], p["wv"], None
    if group is not None:
        x, kv_x = copy_to_group(x, group), copy_to_group(kv_x, group)
        if tp.over("kv_heads") is None:
            wk, wv = copy_to_group(wk, group), copy_to_group(wv, group)
            read = _kv_heads_read(p["wq"].shape[1], tp)
    return group, project(x, p["wq"]), project(kv_x, wk), project(kv_x, wv), \
        read


def attention_out(p: Mapping[str, torch.Tensor], out: torch.Tensor,
                  group) -> torch.Tensor:
    """``wo`` over attention's output (B, S, H, dh): row-parallel under
    tensor parallelism, the group's partial products summed."""
    return reduce_from_group(project(out, p["wo"], k=2), group)


def attention(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              positions: torch.Tensor, freqs: torch.Tensor,
              window: Optional[int] = None,
              kv_x: Optional[torch.Tensor] = None,
              tp: TPLayout = NO_TP) -> torch.Tensor:
    """Attention for training and prefill (``repro/models/layers.py``
    ``attention``): x (B, S, d); p holds ``wq`` (d,H,dh), ``wk``/``wv``
    (d,K,dh) and ``wo`` (H,dh,d); positions (S,).  Self-attention (no
    ``kv_x``): QKV, rope, ``ops.flash_attention`` causal with the window,
    then ``wo`` (under tensor parallelism on the rank's heads,
    ``self_attention_qkv``).  It is causal whatever the caller's config
    says, as the reference's ``_mask`` is, the encoder's included.  Cross
    attention (``kv_x`` (B, Sk, d), the encoder's output): q from x and k,
    v from ``kv_x``, no rope, ``ops.flash_attention`` unmasked over all Sk
    keys (Sk need not be S)."""
    if kv_x is not None:
        group, q, k, v, read = cross_attention_qkv(p, x, kv_x, tp)
        if read is not None:
            k, v = k[:, :, read], v[:, :, read]
        out = ops.flash_attention(q, k, v, causal=False)
        return attention_out(p, out, group)
    group, q, k, v, read = self_attention_qkv(p, x, positions, freqs, tp)
    if read is not None:
        k, v = k[:, :, read], v[:, :, read]
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    return attention_out(p, out, group)


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """How a decode cache's positions lie over the ranks (``Model``
    resolves it from the cache's spec under the ambient rules): each rank
    of ``group`` holds the positions [rank * n, (rank + 1) * n) of the n
    its block holds; ``group`` None: every position.  ``model``: the group
    is the model axis, whose ranks then each hold every kv head, so a
    step gathers the group's q heads and new k and v first (the dry run's
    decode rules and ``SP_DECODE_RULES``)."""

    group: Any = None
    rank: int = 0
    model: bool = False


NO_SPLIT = SeqSplit()


def kv_for_cache(k: torch.Tensor, v: torch.Tensor, tp: TPLayout,
                 seq: SeqSplit):
    """k, v (B, S, K', dh) on the kv heads the rank projects, as its cache
    block holds heads: gathered over the model group (one all-gather of
    the pair) when the cache's positions split over it and the
    parameters' kv heads do too."""
    if seq.model and tp.over("kv_heads") is not None:
        kv = all_gather_dim(torch.stack([k, v]), 3, tp.group)
        return kv[0], kv[1]
    return k, v


def write_positions(cache: torch.Tensor, rows: torch.Tensor,
                    slots: Sequence[int], seq: SeqSplit = NO_SPLIT) -> None:
    """Write ``rows`` (B, n, K, dh), the entries of the global cache slots
    ``slots`` (n ints; a ``range`` is one copy), into the rank's block
    ``cache`` (B, S_blk, K, dh), which holds slots [seq.rank * S_blk,
    (seq.rank + 1) * S_blk): only the slots it holds."""
    S_blk = cache.shape[1]
    lo = seq.rank * S_blk
    if isinstance(slots, range) and slots.step == 1:
        a, b = max(slots.start, lo), min(slots.stop, lo + S_blk)
        if a < b:
            cache[:, a - lo:b - lo] = rows[:, a - slots.start:
                                           b - slots.start].to(cache.dtype)
        return
    mine = [(s - lo, j) for j, s in enumerate(slots) if lo <= s < lo + S_blk]
    if mine:
        dst, src = (torch.tensor(t, device=cache.device) for t in zip(*mine))
        cache[:, dst] = rows[:, src].to(cache.dtype)


def partial_attention(s: torch.Tensor, v: torch.Tensor):
    """One block's partial attention of masked, scaled f32 scores s (B, K,
    G, S_blk) over its values v (B, S_blk, K, dh): (o (B, K, G, dh) f32
    normalised by l, the row maximum m and the sum of exponentials l after
    it, both (B, K, G)), for ``merge_partials``."""
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    return torch.einsum("bkgs,bskd->bkgd", e, v.to(F32)) / l[..., None], m, l


def _attend_rows(s: torch.Tensor, v: torch.Tensor,
                 seq: SeqSplit) -> torch.Tensor:
    """f32 o (B, K, G, dh) of masked, scaled f32 scores s (B, K, G, S_blk)
    over the rank's values v (B, S_blk, K, dh): the softmax over every key
    when the block holds them all; else the block's partial attention,
    gathered over the group and merged in rank order."""
    if seq.group is None:
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bkgs,bskd->bkgd", w, v.to(F32))
    return merge_partials(*gather_partials(*partial_attention(s, v),
                                           seq.group))


def attention_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     freqs: torch.Tensor, window: Optional[int] = None,
                     ring: bool = False, tp: TPLayout = NO_TP,
                     seq: SeqSplit = NO_SPLIT) -> torch.Tensor:
    """One-token decode against a contiguous KV cache
    (``repro/models/layers.py`` ``attention_decode``): x (B, 1, d);
    cache_k/v (B, S_max, K, dh), written in place at ``pos`` with this
    token's roped k and v.  Scores over the keys at positions <= pos (and
    inside the window, if any) in f32, softmax, the product with V in f32,
    a cast to x's dtype, then ``wo``.  With ``ring``, the cache is a ring
    (``attention_decode_ring``).  Plain torch: the JAX package has no
    kernel here.  Returns y (B, 1, d).

    Under a mesh the cache is the rank's block.  With its kv heads split
    as the parameters' (``DECODE_RULES``): q on the rank's heads, k and v
    on its kv heads (all K in the GQA fallback, of which its heads read
    their group's), ``wo`` row-parallel and reduced.  With its positions
    split (``seq``): over the model axis the group's q heads and new k and
    v are gathered first; the rank that holds slot ``pos`` (``pos % W`` on
    a ring) writes it; each rank attends its positions, and the partial
    attentions are merged (``merge_partials``); the rank keeps its heads'
    rows for the row-parallel ``wo``."""
    B, S_blk, _, dh = cache_k.shape
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    group, q, k1, v1, read = self_attention_qkv(p, x, positions, freqs, tp)
    Hl = q.shape[2]
    if seq.model:
        q = all_gather_dim(q, 2, group)
        k1, v1 = kv_for_cache(k1, v1, tp, seq)
        read = None
    if k1.shape[2] != cache_k.shape[2]:
        raise ValueError(f"decode: the cache block holds {cache_k.shape[2]} "
                         f"kv heads, the rank projects {k1.shape[2]}")
    ways = 1 if seq.group is None else group_size(seq.group)
    slot = pos % (S_blk * ways) if ring else pos
    write_positions(cache_k, k1, range(slot, slot + 1), seq)
    write_positions(cache_v, v1, range(slot, slot + 1), seq)
    kc, vc = cache_k, cache_v
    if read is not None:
        kc, vc = kc[:, :, read], vc[:, :, read]
    H, K = q.shape[2], kc.shape[2]
    qg = q.reshape(B, K, H // K, dh).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc.to(F32))
    s = s * (1.0 / np.sqrt(dh))
    lo = seq.rank * S_blk
    k_pos = torch.arange(lo, lo + S_blk, device=x.device)
    allowed = k_pos <= pos
    if window is not None and not ring:
        allowed &= (pos - k_pos) < window
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    o = _attend_rows(s, vc, seq).to(x.dtype).reshape(B, 1, H, dh)
    if seq.model and H != Hl:
        o = o[:, :, tp.rank * Hl:(tp.rank + 1) * Hl]
    return attention_out(p, o, group)


def attention_decode_ring(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, freqs: torch.Tensor,
                          tp: TPLayout = NO_TP,
                          seq: SeqSplit = NO_SPLIT) -> torch.Tensor:
    """One-token decode against the ring KV cache of a sliding-window arch
    (``repro/models/layers.py`` ``attention_decode_ring``): cache_k/v (B,
    W, K, dh), this token's roped k and v written at slot pos % W.  Keys
    are stored roped at their absolute positions, so the ring needs no
    rotation; until the ring fills (pos < W - 1) only slots <= pos hold
    data, after that every slot is inside the window.  Returns y (B, 1,
    d)."""
    return attention_decode(p, x, cache_k, cache_v, pos, freqs, ring=True,
                            tp=tp, seq=seq)


def cross_attention_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                           mem_k: torch.Tensor, mem_v: torch.Tensor,
                           tp: TPLayout = NO_TP,
                           seq: SeqSplit = NO_SPLIT) -> torch.Tensor:
    """Decode-time cross attention over the encoder memory
    (``repro/models/layers.py`` ``cross_attention_decode``): x (B, 1, d);
    mem_k/mem_v (B, Se, K, dh), every row attended.  Scores in f32, no
    rope, softmax, the product with V in f32, a cast to x's dtype, then
    ``wo``.  Plain torch: the JAX package has no kernel here.  Returns y
    (B, 1, d).  Under a mesh as ``attention_decode``: the memory is the
    rank's block, of its kv heads or of its positions."""
    B = x.shape[0]
    dh = mem_k.shape[3]
    group = tp.over("heads")
    read = None
    if group is not None:
        x = copy_to_group(x, group)
        if tp.over("kv_heads") is None:
            read = _kv_heads_read(p["wq"].shape[1], tp)
    q = project(x, p["wq"])                                  # (B,1,H,dh)
    Hl = q.shape[2]
    if seq.model:
        q = all_gather_dim(q, 2, group)
        read = None
    if read is not None:
        mem_k, mem_v = mem_k[:, :, read], mem_v[:, :, read]
    H, K = q.shape[2], mem_k.shape[2]
    qg = q.reshape(B, K, H // K, dh).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, mem_k.to(F32)) / np.sqrt(dh)
    o = _attend_rows(s, mem_v, seq).to(x.dtype).reshape(B, 1, H, dh)
    if seq.model and H != Hl:
        o = o[:, :, tp.rank * Hl:(tp.rank + 1) * Hl]
    return attention_out(p, o, group)


def swiglu(p: Mapping[str, torch.Tensor], x: torch.Tensor,
           tp: TPLayout = NO_TP) -> torch.Tensor:
    """SwiGLU for training, silu in f32: x (B, S, d).  Under tensor
    parallelism ``w_gate``/``w_up`` are the rank's columns of ``mlp`` and
    ``w_down`` its rows: x enters the group, the row-parallel product is
    reduced over it."""
    group = tp.over("mlp")
    x = copy_to_group(x, group)
    g = project(x, p["w_gate"])
    u = project(x, p["w_up"])
    h = F.silu(g.to(F32)).to(x.dtype) * u
    constrain(h, ("batch", "seq", "mlp"), tp.sizes)
    return reduce_from_group(project(h, p["w_down"]), group)


def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor,
                 tp: TPLayout = NO_TP) -> torch.Tensor:
    """The embeddings (..., d) of ``tokens`` from ``tok`` (vocab, d),
    differentiable.  Vocab-parallel under tensor parallelism: ``tok`` is
    the rank's block of rows, tokens outside it look up zeros, and the
    group's lookups are summed."""
    group = tp.over("vocab")
    if group is None:
        return F.embedding(tokens.long(), tok)
    ids = tokens.long() - tp.rank * tok.shape[0]
    inside = (ids >= 0) & (ids < tok.shape[0])
    e = F.embedding(torch.where(inside, ids, 0), tok)
    return reduce_from_group(torch.where(inside[..., None], e, 0), group)


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


def _nll_sum_vocab_parallel(logits, labels, ignore: int, group, rank: int):
    """``_nll_sum`` of the rank's vocab block (..., V/m) of the f32
    logits: the maximum and the sum of exponentials reduced over the
    group, the gold logit from the rank whose block holds the label."""
    mask = labels != ignore
    vl = logits.shape[-1]
    m = all_reduce_max(logits.amax(-1), group)
    s = reduce_from_group(torch.exp(logits - m[..., None]).sum(-1), group)
    logz = torch.log(s) + m
    ids = labels.long() - rank * vl
    inside = mask & (ids >= 0) & (ids < vl)
    gold = torch.gather(logits, -1, torch.where(inside, ids, 0)[..., None])
    gold = reduce_from_group(torch.where(inside, gold[..., 0], 0.0), group)
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_lm_loss(head_w: torch.Tensor, x: torch.Tensor,
                    labels: torch.Tensor, ignore: int = -1,
                    chunk: int = 512,
                    count: Optional[torch.Tensor] = None,
                    tp: TPLayout = NO_TP) -> torch.Tensor:
    """LM head + CE without materialising (B, S, V) f32 logits: the
    sequence runs in chunks of ``chunk`` positions (one chunk when S is
    not a multiple), each under ``torch.utils.checkpoint``, so a chunk's
    logits are recomputed in the backward instead of stored.  Returns the
    NLL sum over non-ignored positions over their count, or over
    ``count`` when given (the data ranks' global count: the trainer's
    data-parallel loss).  Vocab-parallel under tensor parallelism: x
    enters the group, each rank's logits are its vocab block's."""
    B, S, _ = x.shape
    n = max(1, S // chunk) if S % chunk == 0 else 1
    c = S // n
    group = tp.over("vocab")

    def one(xc, lc):
        # The head product in x's dtype, then f32, as the JAX head does.
        if group is None:
            return _nll_sum(project(xc, head_w).to(F32), lc, ignore)
        logits = project(copy_to_group(xc, group), head_w).to(F32)
        return _nll_sum_vocab_parallel(logits, lc, ignore, group, tp.rank)

    nll, total = 0.0, 0
    for i in range(n):
        part, cnt = checkpoint(one, x[:, i * c:(i + 1) * c],
                               labels[:, i * c:(i + 1) * c],
                               use_reentrant=False)
        nll, total = nll + part, total + cnt
    return nll / torch.clamp(total if count is None else count, min=1)

