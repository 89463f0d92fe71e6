"""The work of the calls the traffic makes, counted from their shapes, and
the card's peaks: what every roofline share and every MFU reads.

A call's least time is the larger of its operations over the peak rate and
its bytes over the memory bandwidth, each input byte read once and each
output byte written once, whatever kernel implements it.  A roofline share
is the least time of the calls over the device time of the kernels that
ran them.  Model FLOPs (MFU) count the algorithm's products once: no
recomputation, no padded or inactive rows.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3 3.35 TB/s,
at the full 700 W power limit."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


# ------------------------------------------------------------- attention
def paged_decode(lengths: Iterable[int], H: int, K: int, dh: int, P: int,
                 item: int) -> Tuple[float, float]:
    """(flops, bytes) of one decode attention call over rows of these
    context lengths (0 = inactive row): QK and PV, 4 H len dh each row;
    q read and the output written, and every page the row reaches read
    once (K and V)."""
    flops = nbytes = 0.0
    for n in lengths:
        if n <= 0:
            continue
        flops += 4.0 * H * n * dh
        pages = -(-n // P)
        nbytes += 2.0 * H * dh * item + pages * 2.0 * P * K * dh * item
    return flops, nbytes


def paged_prefill(n_real: int, start: int, H: int, K: int, dh: int, P: int,
                  item: int) -> Tuple[float, float]:
    """(flops, bytes) of one prompt attention call: rows at positions
    start .. start + n_real - 1, each over its causal prefix; q read, the
    output written, the pages of the whole prefix read once."""
    lens = range(start + 1, start + n_real + 1)
    flops = sum(4.0 * H * n * dh for n in lens)
    pages = -(-(start + n_real) // P)
    nbytes = 2.0 * n_real * H * dh * item + pages * 2.0 * P * K * dh * item
    return flops, nbytes


def flash(B: int, Sq: int, Sk: int, H: int, K: int, dh: int, causal: bool,
          item: int, backward: bool) -> Tuple[float, float]:
    """(flops, bytes) of a flash attention call: 4 B H Sq Sk dh, half of it
    under the causal mask; the backward 2.5 times that.  Forward bytes: q,
    k, v in, the output and the f32 log-sum-exp out; backward: q, k, v,
    out, dout, lse in, dq, dk, dv out."""
    q = B * Sq * H * dh * item
    kv = B * Sk * K * dh * item
    lse = B * H * Sq * 4
    flops = (2.0 if causal else 4.0) * B * H * Sq * Sk * dh
    if backward:
        return 2.5 * flops, 3 * q + 2 * kv + lse + q + 2 * kv
    return flops, q + 2 * kv + q + lse


# ------------------------------------------------------------ grouped FFN
def grouped_ffn(rows: int, used: int, d: int, f: int, item: int
                ) -> Tuple[float, float]:
    """(flops, bytes) of a grouped SwiGLU forward over ``rows`` sorted rows
    and ``used`` experts that got rows: 6 rows d f; x read, y written, the
    three matrices of each used expert read once."""
    return 6.0 * rows * d * f, 2.0 * rows * d * item + used * 3.0 * d * f * item


def grouped_ffn_bwd(rows: int, used: int, n_weights: int, d: int, f: int,
                    item: int) -> Tuple[float, float]:
    """(flops, bytes) of its backward: 16 rows d f (the gate and up
    products again, which the forward does not keep, 4; the down product's
    input gradient 2; dx 4; the three weight gradients 6); x and dy read,
    dx written, the used experts' weights read and every weight gradient
    written."""
    nbytes = 3.0 * rows * d * item + (used + n_weights) * 3.0 * d * f * item
    return 16.0 * rows * d * f, nbytes


# ------------------------------------------------------------ model FLOPs
def sizes(m: Dict):
    d, H = m["hidden_size"], m["num_attention_heads"]
    return (d, H, m["num_key_value_heads"], m.get("head_dim") or d // H,
            m["intermediate_size"], m["vocab_size"], m["num_hidden_layers"],
            m.get("num_local_experts", 0), m.get("num_experts_per_tok", 0))


def active_params(m: Dict) -> float:
    """Parameters in the products one token goes through: per layer the
    attention's four projections, the router and the k picked experts (or
    the dense FFN); and the head.  The embedding is a lookup."""
    d, H, K, dh, f, V, L, E, k = sizes(m)
    attn = d * H * dh * 2 + d * K * dh * 2
    ffn = (k * 3 * d * f + d * E) if E else 3 * d * f
    return L * (attn + ffn) + d * V


def serve_flops(m: Dict, contexts: Iterable[int]) -> float:
    """Model FLOPs of serving tokens at these context lengths (a token's
    position + 1): 2 per active parameter, and QK and PV over the
    context, 4 H dh len a layer."""
    d, H, K, dh, f, V, L, E, k = sizes(m)
    n = total = 0.0
    for c in contexts:
        n += 1
        total += c
    return 2.0 * active_params(m) * n + 4.0 * L * H * dh * total


def train_flops(m: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of ``batch`` sequences of ``seq``
    tokens: 6 per active parameter per token, and the causal attention's
    2 B H S^2 dh a layer forward, three times that with the backward."""
    d, H, K, dh, f, V, L, E, k = sizes(m)
    return (6.0 * active_params(m) * batch * seq
            + 3.0 * L * 2.0 * batch * H * seq * seq * dh)


def share(least: float, device_s: float) -> Optional[float]:
    """A roofline share in percent; None without device time to read."""
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s


def kernel_time(events: Sequence[Tuple[str, float, float]],
                needles: Sequence[str]) -> Tuple[float, list]:
    """(seconds, events) of the device events whose names hold one of
    ``needles``, in start order."""
    hit = sorted((e for e in events if any(n in e[0] for n in needles)),
                 key=lambda e: e[1])
    return sum(b - a for _, a, b in hit), hit
