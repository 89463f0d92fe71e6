"""Models of the port: config, layers, the MoE layer, the Mamba2 block, the
xLSTM blocks and the model of every family (dense, MoE, hybrid, xLSTM,
encoder-decoder and VLM)."""

from .config import SHAPES, SMOKE_SHAPES, ModelConfig, ShapeConfig
from .transformer import Model

__all__ = ["Model", "ModelConfig", "SHAPES", "SMOKE_SHAPES", "ShapeConfig"]
