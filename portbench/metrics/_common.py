"""Arithmetic shared by the metric readers: percentiles, the serving
tails, span and counter ratios, and the work of the profiled calls."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from portbench.metrics import work


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest rank: the smallest value with at least q percent of the
    values at or below it; None for no values."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def ttft_ms(rec, streams=None) -> List[float]:
    """Time to first token of every request or turn due in the window, from
    when it was due; one that never got a token counts at the end of the
    drain that waited for it."""
    w0, w1 = rec.window
    out = []
    for r in rec.records:
        if not (w0 <= r.due < w1) or (streams and r.stream not in streams):
            continue
        first = r.tokens[0] if r.tokens else rec.drain_end
        out.append(1e3 * (first - r.due))
    return out


def itl_ms(rec) -> List[float]:
    """Every gap between consecutive tokens of one request or turn, both
    tokens in the window."""
    out = []
    for r in rec.records:
        t = [x for x in r.tokens if rec.in_window(x)]
        out += [1e3 * (b - a) for a, b in zip(t, t[1:])]
    return out


def tokens_in_window(rec) -> int:
    return sum(1 for t in rec.token_times if rec.in_window(t))


def window_s(rec) -> float:
    return rec.window[1] - rec.window[0]


def lateness_ms(rec) -> List[float]:
    return [1e3 * (rel - due) for due, rel in rec.lateness
            if rec.in_window(due)]


def delta(rec, key: str) -> float:
    return rec.stats1.get(key, 0) - rec.stats0.get(key, 0)


def step_ms(rec) -> List[float]:
    return [1e3 * s for end, s in rec.step_walls if rec.in_window(end)]


def span_ms_per_call(rec, name: str) -> Optional[float]:
    sp = rec.spans
    if sp is None or not sp.calls.get(name):
        return None
    return 1e3 * sp.total[name] / sp.calls[name]


MIGRATION = ("migration.exchange", "migration.swap_in", "migration.swap_out")


# --------------------------------------------------------- profiled calls
def _attn_shape(m: Dict):
    _, H, K, dh = (m["hidden_size"], m["num_attention_heads"],
                   m["num_key_value_heads"],
                   m.get("head_dim") or m["hidden_size"]
                   // m["num_attention_heads"])
    return H, K, dh


def paged_calls(rec):
    """The paged attention launches of the profiled slice in launch order,
    each (kind, flops, bytes): a pass launches one per layer."""
    m = rec.model
    H, K, dh = _attn_shape(m)
    P = rec.cell["serve"].get("page_size", 16)
    L = m["num_hidden_layers"]
    out = []
    for kind, info in rec.device.calls:
        if kind == "decode_pass":
            lens = info["lengths"].tolist()
            mask = info["mask"]
            lens = [n if mask[i] else 0 for i, n in enumerate(lens)]
            fl, nb = work.paged_decode(lens, H, K, dh, P, 2)
            out += [("decode", fl, nb)] * L
        elif kind == "prefill_pass":
            fl, nb = work.paged_prefill(info["n_real"], info["start"], H, K,
                                        dh, P, 2)
            out += [("prefill", fl, nb)] * L
    return out


def paged_roofline(rec, which: str) -> Optional[float]:
    """Least time of the ``which`` (decode or prefill) paged attention
    calls over the device time of their kernels, matched launch by launch
    (decode and prefill run one kernel)."""
    if rec.device is None:
        return None
    calls = paged_calls(rec)
    _, events = work.kernel_time(rec.device.events, ("paged_attention",))
    if not calls or len(calls) != len(events):
        return None
    least = dev = 0.0
    for (kind, fl, nb), (_, a, b) in zip(calls, events):
        if kind == which:
            least += work.least_s(fl, nb)
            dev += b - a
    return work.share(least, dev)


def serve_model_flops(rec) -> Optional[float]:
    """Model FLOPs of the profiled slice: every live decode row and every
    prompt token ingested, at its context length."""
    if rec.device is None:
        return None
    ctx: List[int] = []
    for kind, info in rec.device.calls:
        if kind == "decode_pass":
            mask = info["mask"]
            ctx += [n for i, n in enumerate(info["lengths"].tolist())
                    if mask[i]]
        elif kind == "prefill_pass":
            s = info["start"]
            ctx += list(range(s + 1, s + info["n_real"] + 1))
    return work.serve_flops(rec.model, ctx)


def mfu(flops: Optional[float], rec) -> Optional[float]:
    if flops is None or rec.device is None or rec.device.window_s <= 0:
        return None
    return 100.0 * flops / (rec.device.window_s * work.PEAK_FLOPS_BF16)


def device_idle(rec) -> Optional[float]:
    d = rec.device
    if d is None or d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)


def grouped_ffn_roofline(rec) -> Optional[float]:
    """Least time of every grouped-expert launch (forward, and backward in
    training) over the device time of the grouped-expert kernels."""
    if rec.device is None:
        return None
    least = 0.0
    for kind, info in rec.device.calls:
        if kind not in ("grouped_ffn", "grouped_ffn_bwd") or info is None:
            continue
        sizes = info["sizes"].tolist()
        ex = (list(range(len(sizes))) if info["experts"] is None
              else info["experts"].tolist())
        used = len({ex[g] for g, n in enumerate(sizes) if n > 0})
        rows = sum(sizes)
        if kind == "grouped_ffn":
            fl, nb = work.grouped_ffn(rows, used, info["d"], info["f"],
                                      info["item"])
        else:
            fl, nb = work.grouped_ffn_bwd(rows, used, info["n_weights"],
                                          info["d"], info["f"], info["item"])
        least += work.least_s(fl, nb)
    dev, _ = work.kernel_time(rec.device.events, ("moe_",))
    return work.share(least, dev)


def train_model_flops(rec) -> Optional[float]:
    """Model FLOPs of the training steps in the profiled slice."""
    if rec.device is None:
        return None
    n = sum(1 for kind, _ in rec.device.calls if kind == "train_step")
    return n * work.train_flops(rec.model, rec.batch_rows, rec.seq) or None


def flash_roofline(rec) -> Optional[float]:
    """Least time of every flash attention launch, forward (remat's
    recomputation included: the kernel ran it) and backward, over the
    device time of the flash kernels."""
    if rec.device is None:
        return None
    least = 0.0
    for kind, info in rec.device.calls:
        if kind not in ("flash", "flash_bwd") or info is None:
            continue
        B, Sq, H, dh = info["q"]
        Sk, K = info["k"][1], info["k"][2]
        fl, nb = work.flash(B, Sq, Sk, H, K, dh, info["causal"],
                            info["item"], backward=kind == "flash_bwd")
        least += work.least_s(fl, nb)
    dev, _ = work.kernel_time(rec.device.events, ("flash_",))
    return work.share(least, dev)
