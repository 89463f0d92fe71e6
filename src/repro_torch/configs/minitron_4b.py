"""minitron-4b [dense, pruned nemotron, arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.  Copied from
``repro/configs/minitron_4b.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="minitron_4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    kv_heads=8,
    d_ff=9216,
    vocab=256000,
    head_dim=128,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, kv_heads=2, d_ff=192,
    vocab=512, head_dim=16,
)
