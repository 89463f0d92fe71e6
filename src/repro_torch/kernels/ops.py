"""Kernel entry points with dispatch by tensor device.

A tensor on the CPU takes the plain PyTorch version (``kernels/ref.py``,
``kernels/sampling.py``); a CUDA tensor launches the hand-written kernel or
raises.  There is no global mode and no switch that sends CUDA tensors to
the plain version.  A ``meta`` tensor (a dry run names that device) gets
an empty result of the output's shape.  While a cost walk is open
(``launch.analysis.cost_of``) each kernel charges its own cost from its
shapes and hides its body's ops (``kernels.cost.charging``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cost, ref
from .cost import nbytes
from .sampling import sample_tokens as _sample_tokens


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Differentiable attention for training.  q: (B,Sq,H,dh); k/v:
    (B,Sk,K,dh) with GQA; causal rows at positions ``i + Sk - Sq``; a
    window applies only under causal.  Goes through
    ``flash_attention.FlashAttention`` on every device: a CPU tensor takes
    ``ref.mha_reference`` (its gradient by autograd), a CUDA tensor the
    hand-written forward and backward kernels."""
    from .flash_attention import FlashAttention

    return FlashAttention.apply(q, k, v, causal, window)


def _paged_cost(q, k_pool, B, rows, slots) -> cost.Cost:
    """Attention of ``B`` sequences of ``rows`` query rows each over
    ``slots`` cached positions a sequence."""
    H, dh = q.shape[-2:]
    kv = 2.0 * B * slots * k_pool.shape[2] * dh * k_pool.element_size()
    return cost.attention(B, rows, slots, H, dh, nbytes(q) + kv,
                          nbytes(q))[0]


def paged_attention(q, k_pool, v_pool, page_table, lengths,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over paged KV.  q: (B,H,dh); k_pool/v_pool:
    (N,P,K,dh); page_table: (B,MP) int32 (-1 = unused); lengths: (B,)."""
    slots = page_table.shape[-1] * k_pool.shape[1]
    with cost.charging("paged_attention",
                       lambda: _paged_cost(q, k_pool, q.shape[0], 1,
                                           slots)):
        if q.device.type == "meta":
            return torch.empty_like(q)
        if q.device.type == "cpu":
            return ref.paged_attention_reference(
                q, k_pool, v_pool, page_table, lengths, window=window)
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
    slots = page_table.shape[-1] * k_pool.shape[1]
    with cost.charging("paged_prefill",
                       lambda: _paged_cost(q, k_pool, 1, q.shape[0],
                                          slots)):
        if q.device.type == "meta":
            return torch.empty_like(q)
        if q.device.type == "cpu":
            return ref.paged_prefill_reference(
                q, k_pool, v_pool, page_table, lengths, window=window)
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
    row bits that depend on the row and its expert alone.  Differentiable
    in x and the weights (``moe_gemm.GroupedFFN``): a CPU tensor takes the
    plain forward and backward, a CUDA tensor the kernels."""
    from .moe_gemm import GroupedFFN

    return GroupedFFN.apply(x, w_gate, w_up, w_down, group_sizes,
                            group_experts)


def ssd_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The SSD (Mamba2) intra-chunk block, one chunk per row, no initial
    state.  x: (Bc,Q,H,P); dt: (Bc,Q,H) f32; A: (H,) f32; Bm/Cm: (Bc,Q,N)
    in x's dtype.  Returns y (Bc,Q,H,P) f32.  Differentiable in every
    input (``ssd_scan.SSDScan``): a CPU tensor takes ``ref.ssd_reference``
    and ``ref.ssd_bwd_reference``, a CUDA tensor the hand-written forward
    and backward kernels; under ``torch.no_grad`` only the forward runs."""
    from .ssd_scan import SSDScan

    return SSDScan.apply(x, dt, A, Bm, Cm)


def sample_tokens(logits, seeds, positions, temperature, top_k,
                  top_p) -> torch.Tensor:
    """Batched token sampling (the decode epilogue): temperature / top-k /
    top-p filtering and Gumbel-max over (B, vocab) logits, with per-row
    keys ``fold_in(PRNGKey(seed), position)``; ``temperature <= 0`` rows
    are bitwise ``argmax(logits)``.  Plain PyTorch on every device: the
    JAX package leaves this epilogue to XLA and has no kernel for it."""
    return _sample_tokens(logits, seeds, positions, temperature, top_k,
                          top_p)
