"""mixtral-8x7b [MoE 8 experts top-2, SWA, arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  Sliding-window
attention (4096) bounds the decode KV cache, which is what makes the
long_500k cell runnable for this arch.  Copied from
``repro/configs/mixtral_8x7b.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="mixtral_8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=32000,
    n_experts=8,
    top_k=2,
    # Dropless sorted-ragged dispatch: prefill and decode route identically,
    # which ring-KV serving correctness depends on (tests/test_ring_kv.py).
    moe_dispatch="dropless",
    window=4096,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, kv_heads=2, d_ff=256,
    vocab=512, n_experts=4, top_k=2, window=64,
)
