"""Models of the port: config, layers, the MoE layer, the Mamba2 block and
the decoder (dense, MoE and hybrid families)."""

from .config import ModelConfig
from .transformer import Model

__all__ = ["Model", "ModelConfig"]
