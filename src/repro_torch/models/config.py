"""ModelConfig — the port's copy of ``repro/models/config.py``, with a
torch dtype.  Every field of the JAX config is kept, so a reference config
converts field by field (``repro_torch.convert.config_from_reference``);
the port serves the ``dense`` family so far and says so where it is asked
for another."""

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

    def validate(self) -> "ModelConfig":
        if self.n_heads % max(self.kv_heads, 1):
            raise ValueError(f"{self.n_heads} query heads do not group over "
                             f"{self.kv_heads} KV heads")
        return self
