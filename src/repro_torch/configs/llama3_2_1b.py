"""llama3.2-1b [dense, hf:meta-llama/Llama-3.2-1B; unverified].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.  Copied from
``repro/configs/llama3_2_1b.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="llama3_2_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=8, kv_heads=2, d_ff=256,
    vocab=512,
)
