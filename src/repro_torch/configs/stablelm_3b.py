"""stablelm-3b [dense, hf:stabilityai/stablelm-2; unverified].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.  Copied from
``repro/configs/stablelm_3b.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="stablelm_3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    kv_heads=32,
    d_ff=6912,
    vocab=50304,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, kv_heads=4, d_ff=256,
    vocab=512,
)
