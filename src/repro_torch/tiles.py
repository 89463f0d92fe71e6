"""Row tiles: the one product shape every projection of the port runs in.

The serving engine's bitwise invariants (one-shot prefill == chunked ==
decode, preemption by recompute) need each row's result to depend on that
row alone, not on how many rows share the call.  A GEMM library picks its
algorithm from the problem's shape, and a reduction kernel its split from
the number of rows, so the same row can round differently in a 4-row
decode batch and a 512-row prefill.  ``linear`` therefore runs every call
as tiles of exactly ``ROW_TILE`` rows (padding the last), so every row of
every call goes through the same shape.

Its gradient (``dx = dy wᵀ``, ``dw = xᵀ dy``) is two plain whole-tensor
products: training needs no row invariance, and the JAX package leaves
these products outside any kernel too.  A call with nothing to
differentiate skips autograd and runs the tiles alone.

A leaf module: ``models.layers`` and the plain kernels of ``kernels.ref``
both import it, and it imports neither.
"""

from __future__ import annotations

import torch

ROW_TILE = 16


def row_tiles(x: torch.Tensor):
    """(padded x, row count): x (R, ...) padded with zero rows to a
    multiple of ROW_TILE."""
    R = x.shape[0]
    pad = -R % ROW_TILE
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, R


def _tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xp, R = row_tiles(x)
    if xp.device.type == "meta":
        # Shapes only (a dry run): one product of the padded rows does the
        # tiles' flops without a Python trip per tile.
        return torch.matmul(xp, w)[:R]
    out = xp.new_empty((xp.shape[0], w.shape[1]))
    for s in range(0, xp.shape[0], ROW_TILE):
        torch.matmul(xp[s:s + ROW_TILE], w, out=out[s:s + ROW_TILE])
    return out[:R]


class _Linear(torch.autograd.Function):
    """The tiled product forward; plain products backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _tiled(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ dy if ctx.needs_input_grad[1] else None
        return dx, dw


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (R, din) @ w (din, dout), one ROW_TILE-row product at a time;
    differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Linear.apply(x, w)
    return _tiled(x, w)
