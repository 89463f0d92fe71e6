"""Data of the port: ``SyntheticLM``, numpy only, so its batches are the
JAX package's bit for bit, and ``ShardedLoader``, which places each rank's
block of them on its device with background prefetch."""

from .pipeline import ShardedLoader, SyntheticLM

__all__ = ["ShardedLoader", "SyntheticLM"]
