"""seamless-m4t-medium [audio enc-dec, arXiv:2308.11596; hf].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  The speech
frontend (w2v-BERT conformer) is a stub: the batch supplies precomputed
frame embeddings (B, S, d).  12 encoder + 12 decoder blocks of the stated
geometry.  Copied from ``repro/configs/seamless_m4t_medium.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="seamless_m4t_medium",
    family="encdec",
    n_layers=12,            # decoder blocks
    enc_layers=12,          # encoder blocks
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=4096,
    vocab=256206,
    frontend="audio",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, kv_heads=4,
    d_ff=128, vocab=512,
)
