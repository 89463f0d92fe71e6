"""ModelConfig — the port's copy of ``repro/models/config.py``, with a
torch dtype.  Every field of the JAX config is kept, so a reference config
converts field by field (``repro_torch.convert.config_from_reference``).
The port runs every family of the JAX package: ``dense``, ``moe``,
``hybrid``, ``xlstm``, ``encdec`` and ``vlm``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                 # dense | moe | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_parallelism: str = "tp"           # "tp" | "ep"
    moe_dispatch: str = "dropless"        # "dropless" | "capacity"
    moe_ep_axis_size: int = 16
    capacity_factor: float = 1.0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0
    # xLSTM
    slstm_every: int = 0
    # enc-dec
    enc_layers: int = 0
    # modality frontend stubs
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    dtype: torch.dtype = torch.bfloat16
    # training
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def validate(self) -> "ModelConfig":
        if self.n_heads % max(self.kv_heads, 1):
            raise ValueError(f"{self.n_heads} query heads do not group over "
                             f"{self.kv_heads} KV heads")
        if self.family == "hybrid" and not (self.ssm_state > 0
                                            and self.attn_every > 0):
            raise ValueError(f"a hybrid config needs ssm_state > 0 and "
                             f"attn_every > 0, got {self.ssm_state} and "
                             f"{self.attn_every}")
        if self.family == "encdec" and self.enc_layers <= 0:
            raise ValueError(f"an encdec config needs enc_layers > 0, got "
                             f"{self.enc_layers}")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


# The input-shape set of every LM arch (``repro/models/config.py``).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Smoke-scale shapes for CPU tests.
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 128, 4, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 128, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode"),
    "long_500k": ShapeConfig("long_500k", 256, 1, "decode"),
}
