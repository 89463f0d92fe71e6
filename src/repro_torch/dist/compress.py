"""Gradient compression: block-wise symmetric int8 quantization with
error feedback (``repro/dist/compress.py``: ``quantize``, ``dequantize``,
``quantize_roundtrip``, ``ErrorFeedback``, ``compress_with_feedback``).

``quantize`` flattens a tensor, pads it with zeros to a multiple of
``BLOCK`` elements and keeps one f32 scale per block (absmax / 127);
values round half to even.  The round trip's error is at most
``0.5 * block_absmax / 127`` per element.

``ErrorFeedback`` is the EF-SGD trick: the quantization residual is carried
to the next round and added back before compressing, so the accumulated
compressed signal is unbiased though each single quantization is not.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """int8 payload, per-block scales, the original shape and length."""

    q: torch.Tensor          # (n_blocks, BLOCK) int8
    scale: torch.Tensor      # (n_blocks, 1) f32
    shape: Tuple[int, ...]
    length: int              # valid elements before padding

    @property
    def nbytes_compressed(self) -> int:
        return int(self.q.numel() + self.scale.numel() * 4)


def quantize(x: torch.Tensor, block: int = BLOCK) -> QuantizedTensor:
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale, shape=tuple(x.shape), length=n)


def dequantize(qx: QuantizedTensor) -> torch.Tensor:
    flat = (qx.q.to(torch.float32) * qx.scale).reshape(-1)
    return flat[:qx.length].reshape(qx.shape)


def quantize_roundtrip(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """quantize -> dequantize (f32): the lossy identity the train step
    applies to gradients."""
    return dequantize(quantize(x, block))


@dataclasses.dataclass(frozen=True)
class ErrorFeedback:
    """The carried quantization residual (f32), one per compressed
    tensor."""

    residual: torch.Tensor

    @classmethod
    def init(cls, x: torch.Tensor) -> "ErrorFeedback":
        return cls(residual=torch.zeros_like(x, dtype=torch.float32))


def compress_with_feedback(x: torch.Tensor, ef: ErrorFeedback,
                           block: int = BLOCK
                           ) -> Tuple[QuantizedTensor, ErrorFeedback]:
    """Compress ``x + residual``; the new residual is what the quantizer
    dropped this round."""
    target = x.to(torch.float32) + ef.residual
    qx = quantize(target, block)
    return qx, ErrorFeedback(residual=target - dequantize(qx))
