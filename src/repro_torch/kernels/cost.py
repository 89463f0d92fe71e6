"""What a kernel reports to a cost walk
(``launch.analysis.cost_of``).

The hand-written kernels are ``ctypes`` launches, invisible to a
``TorchDispatchMode``; on the CPU the walk would see their plain versions'
aten ops instead.  So each kernel's autograd Function
(``flash_attention.FlashAttention``, ``moe_gemm.GroupedFFN``,
``ssd_scan.SSDScan``) and each inference entry point of ``kernels.ops``
runs its body inside ``charging``: while a walk is open the call's cost is
charged from its shapes, once a call, and the ops inside (the plain body, a
launcher's allocations) are not counted.  A forward charges when it runs
(again when remat recomputes it), a backward when the gradient runs.  The
count of a step is then the same on the CPU, on ``meta`` (where each
returns empty tensors of its outputs' shapes) and on the card.

The formulas are the work the plain versions do: attention as full
Sq x Sk products (``ref.mha_reference``, and the reference's jnp
``_attend``), the grouped FFN as its three products a row, the SSD block as
its Q x Q products.  PERF.md's kernel bounds count only the causal half of
attention; these do not.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, List, Tuple

# The open walks; each has ``charge(name, Cost)``.
WALKS: List = []
# > 0 while a kernel's body runs: the walks skip its ops.  Not
# thread-local, so the card's autograd thread sees it too.
SUSPENDED = [0]


@dataclasses.dataclass(frozen=True)
class Cost:
    products: float         # the flops of the call's matrix products
    elementwise: float      # its other flops
    bytes: float            # operands read once, outputs written once

    @property
    def flops(self) -> float:
        return self.products + self.elementwise


@contextlib.contextmanager
def charging(name: str, cost: Callable[[], Cost]) -> Iterator[None]:
    """Charge ``cost()`` to every open walk (computed only when one is
    open) and hide the block's ops from them."""
    if WALKS:
        c = cost()
        for walk in WALKS:
            walk.charge(name, c)
    SUSPENDED[0] += 1
    try:
        yield
    finally:
        SUSPENDED[0] -= 1


def nbytes(*ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def attention(B, Sq, Sk, H, dh, ins, out) -> Tuple[Cost, Cost]:
    """(forward, backward) of attention over all Sq x Sk pairs, causal or
    not: the forward's scores and PV products and the scores' scale, as
    ``ref.mha_reference`` computes them; the backward recomputes the
    scores and their scale (as the flash kernel does, and as the
    reference's checkpointed ``_attend`` does) and takes the four gradient
    products."""
    pairs = B * H * Sq * Sk
    return (Cost(4.0 * pairs * dh, pairs, ins + out),
            Cost(10.0 * pairs * dh, 2.0 * pairs, 2.0 * (ins + out)))


def flash(q, k, v) -> Tuple[Cost, Cost]:
    B, Sq, H, dh = q.shape
    return attention(B, Sq, k.shape[1], H, dh, nbytes(q, k, v), nbytes(q))


def grouped_ffn(x, w_gate, w_up, w_down) -> Tuple[Cost, Cost]:
    """Every row through its expert's three products: 2*d*f flops each."""
    T, d = x.shape
    f = w_gate.shape[2]
    ins = nbytes(x, w_gate, w_up, w_down)
    return (Cost(6.0 * T * d * f, 3.0 * T * f, ins + nbytes(x)),
            Cost(16.0 * T * d * f, 10.0 * T * f + T * d,
                 2.0 * ins + 2.0 * nbytes(x)))


def ssd(x, dt, A, Bm, Cm) -> Tuple[Cost, Cost]:
    Bc, Q, H, P = x.shape
    N = Bm.shape[-1]
    qq = Bc * Q * Q
    ins = nbytes(x, dt, A, Bm, Cm)
    out = 4.0 * Bc * Q * H * P
    return (Cost(2.0 * qq * N + 2.0 * qq * H * P,
                 3.0 * qq * H + 2.0 * Bc * Q * H * P, ins + out),
            Cost(6.0 * qq * N + 4.0 * qq * H * P,
                 7.0 * qq * H + 4.0 * Bc * Q * H * P, 2.0 * ins + out))
