"""xlstm-350m [sLSTM + mLSTM blocks, arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry their
own projections (mLSTM up-factor 2, sLSTM gated FFN 4/3).  One sLSTM block
per 8 layers (xLSTM[7:1] ratio), the rest mLSTM.  Copied from
``repro/configs/xlstm_350m.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="xlstm_350m",
    family="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, kv_heads=2, vocab=512,
    slstm_every=4,
)
