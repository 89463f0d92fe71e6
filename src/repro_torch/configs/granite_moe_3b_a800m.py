"""granite-moe-3b-a800m [MoE 40 experts top-8; hf:ibm-granite].

32L d_model=1536 24H (GQA kv=8) head_dim=64 d_ff=512 vocab=49155, MoE 40
experts top-8 with dropless dispatch.  Copied from
``repro/configs/granite_moe_3b_a800m.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="granite_moe_3b_a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    moe_dispatch="dropless",
    head_dim=64,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, kv_heads=2, d_ff=64,
    vocab=512, n_experts=8, top_k=2, head_dim=16,
)
