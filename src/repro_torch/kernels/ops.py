"""Kernel entry points with dispatch by tensor device.

A tensor on the CPU takes the plain PyTorch version (``kernels/ref.py``,
``kernels/sampling.py``); a CUDA tensor launches the hand-written kernel or
raises.  There is no global mode and no switch that sends CUDA tensors to
the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .sampling import sample_tokens as _sample_tokens


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Differentiable attention for training.  q: (B,Sq,H,dh); k/v:
    (B,Sk,K,dh) with GQA; causal rows at positions ``i + Sk - Sq``; a
    window applies only under causal.  A CPU tensor takes
    ``ref.mha_reference`` (its gradient by autograd); a CUDA tensor the
    hand-written forward and backward kernels."""
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, window=window)
    from .flash_attention import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def paged_attention(q, k_pool, v_pool, page_table, lengths,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over paged KV.  q: (B,H,dh); k_pool/v_pool:
    (N,P,K,dh); page_table: (B,MP) int32 (-1 = unused); lengths: (B,)."""
    if q.device.type == "cpu":
        return ref.paged_attention_reference(q, k_pool, v_pool, page_table,
                                             lengths, window=window)
    from .paged_attention import paged_attention_cuda

    return paged_attention_cuda(q, k_pool, v_pool, page_table, lengths,
                                window=window)


def paged_prefill(q, k_pool, v_pool, page_table, lengths,
                  window: Optional[int] = None) -> torch.Tensor:
    """One-shot prompt attention over paged KV: the S prompt tokens of one
    sequence attend as S query rows over a shared page table, row t's
    causal visibility carried by ``lengths[t]`` (0 disables a padded row).
    Both versions compute each row as decode does, so a whole-prompt
    prefill is bitwise-equal to stepping its tokens through decode.

    q: (S,H,dh); k_pool/v_pool: (N,P,K,dh); page_table: (MP,) int32;
    lengths: (S,) int32.  Returns (S,H,dh)."""
    if q.device.type == "cpu":
        return ref.paged_prefill_reference(q, k_pool, v_pool, page_table,
                                           lengths, window=window)
    from .paged_attention import paged_prefill_cuda

    return paged_prefill_cuda(q, k_pool, v_pool, page_table, lengths,
                              window=window)


def moe_grouped_ffn(x, w_gate, w_up, w_down, group_sizes,
                    group_experts: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Grouped-expert SwiGLU over sorted ragged segments (dropless MoE
    dispatch).  x: (T, d) sorted by group; w_gate/w_up: (E, d, f); w_down:
    (E, f, d); group_sizes: (G,) int32; group_experts: optional (G,) int32
    group -> weight-row map (None means G == E).  Both versions give each
    row bits that depend on the row and its expert alone."""
    if x.device.type == "cpu":
        return ref.moe_grouped_ffn_reference(x, w_gate, w_up, w_down,
                                             group_sizes, group_experts)
    from .moe_gemm import moe_grouped_ffn_cuda

    return moe_grouped_ffn_cuda(x, w_gate, w_up, w_down, group_sizes,
                                group_experts)


def ssd_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The SSD (Mamba2) intra-chunk block, one chunk per row, no initial
    state.  x: (Bc,Q,H,P); dt: (Bc,Q,H) f32; A: (H,) f32; Bm/Cm: (Bc,Q,N)
    in x's dtype.  Returns y (Bc,Q,H,P) f32.  A CPU tensor takes
    ``ref.ssd_reference``; a CUDA tensor the hand-written kernel."""
    if x.device.type == "cpu":
        return ref.ssd_reference(x, dt, A, Bm, Cm)
    from .ssd_scan import ssd_scan_cuda

    return ssd_scan_cuda(x, dt, A, Bm, Cm)


def sample_tokens(logits, seeds, positions, temperature, top_k,
                  top_p) -> torch.Tensor:
    """Batched token sampling (the decode epilogue): temperature / top-k /
    top-p filtering and Gumbel-max over (B, vocab) logits, with per-row
    keys ``fold_in(PRNGKey(seed), position)``; ``temperature <= 0`` rows
    are bitwise ``argmax(logits)``.  Plain PyTorch on every device: the
    JAX package leaves this epilogue to XLA and has no kernel for it."""
    return _sample_tokens(logits, seeds, positions, temperature, top_k,
                          top_p)
