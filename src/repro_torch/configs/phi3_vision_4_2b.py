"""phi-3-vision-4.2b [VLM, hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.  The CLIP vision
tower is a stub: the batch supplies precomputed patch embeddings
(B, frontend_tokens, d) which a learned adapter projects into the LM.
Copied from ``repro/configs/phi3_vision_4_2b.py``."""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch="phi3_vision_4_2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    kv_heads=32,
    d_ff=8192,
    vocab=32064,
    frontend="vision",
    frontend_tokens=576,     # 24x24 patch grid
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, kv_heads=4, d_ff=256,
    vocab=512, frontend_tokens=16,
)
