"""Checkpoints of the port, in the JAX package's on-disk layout."""

from .checkpoint import AsyncCheckpointer, available_steps, restore, save

__all__ = ["AsyncCheckpointer", "available_steps", "restore", "save"]
