"""Models of the port: config, layers and the dense decoder."""

from .config import ModelConfig
from .transformer import Model

__all__ = ["Model", "ModelConfig"]
