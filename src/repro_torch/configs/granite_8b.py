"""granite-8b [dense llama-arch code model, arXiv:2405.04324; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.  Copied from
``repro/configs/granite_8b.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="granite_8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=49152,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, kv_heads=2, d_ff=256,
    vocab=512,
)
