"""Optimizer of the port: AdamW with the JAX package's math."""

from .adamw import AdamW, AdamWState, cosine_schedule

__all__ = ["AdamW", "AdamWState", "cosine_schedule"]
