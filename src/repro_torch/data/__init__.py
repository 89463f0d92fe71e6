"""Data of the port: ``SyntheticLM``, numpy only, so its batches are the
JAX package's bit for bit.  ``ShardedLoader`` is not ported yet
(ROADMAP.md queue A item 11)."""

from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
