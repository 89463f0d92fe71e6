"""Models of the port: config, layers, the MoE layer and the decoder
(dense and MoE families)."""

from .config import ModelConfig
from .transformer import Model

__all__ = ["Model", "ModelConfig"]
