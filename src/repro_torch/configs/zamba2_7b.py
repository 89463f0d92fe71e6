"""zamba2-7b [hybrid Mamba2 + shared attention, arXiv:2411.15242].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
The Mamba2 backbone is interleaved with one *shared* attention+MLP block,
applied after every 6 Mamba2 layers (one parameter set reused).  Copied
from ``repro/configs/zamba2_7b.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=7, d_model=128, n_heads=4, kv_heads=4, d_ff=256,
    vocab=512, attn_every=3, ssm_state=16, ssm_head_dim=32,
)
