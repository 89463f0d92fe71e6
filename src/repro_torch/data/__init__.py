"""Data of the port: ``SyntheticLM``, numpy only, so its batches are the
JAX package's bit for bit.  ``ShardedLoader`` comes with distribution
(ROADMAP.md queue A item 11)."""

from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
