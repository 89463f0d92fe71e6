"""The comparison that decides ``correct``.

Serving: once the window has closed and the program's state is freed, a
sample (drawn from the seed) of the greedy requests it served, the longest
among them, goes through the float32 reference once over its prompt and
served tokens; each served token's gap is how far its reference logit
lies below the reference's best at its position.  The numbers compared
(``gap_numbers``) are the widest gap and, where that does not separate
the program from the control, the share of tokens with a gap.

Training: the first steps of set-up run through the window's own call on
rows that all differ; the reference follows them from the same weights on
the same rows.  Three numbers, each the worst over steps or leaves: each
step's loss against the reference's, relative; each leaf's first
gradient's norm, as the optimizer holds it after one step, and each leaf's
change over the steps, each against the reference's, relative to the
larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's (moved by round-off alone) are left out of the change.

Each number has its limit in the cell file, under ``correct``."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import numpy as np


# ------------------------------------------------------------- serving
def serve_sample(served: Dict[int, List[int]], greedy: Dict[int, bool],
                 seed: int, tokens: int, most: int) -> List[int]:
    """Request ids to check: the greedy request with the most served
    tokens, then others in an order drawn from the seed, until ``tokens``
    served tokens or ``most`` requests are in."""
    ids = sorted(r for r, g in greedy.items() if g and served.get(r))
    if not ids:
        return []
    longest = max(ids, key=lambda r: (len(served[r]), -r))
    rest = [r for r in ids if r != longest]
    rng = np.random.default_rng([seed, 7])
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for r in order:
        if n >= tokens or len(out) >= most:
            break
        out.append(r)
        n += len(served[r])
    return out


def serve_gaps(weights, m: Dict, prompts: Dict[int, List[int]],
               served: Dict[int, List[int]], rids: Sequence[int],
               control=None) -> List[float]:
    """Every compared token's gap under the float32 reference.  With
    ``control`` (a lower precision), the token compared at each position is
    the one the control puts first, over the same prompt and served
    tokens."""
    from portbench.reference import decoder

    gaps: List[float] = []
    for r in rids:
        seq = list(prompts[r]) + list(served[r])
        at = list(range(len(prompts[r]) - 1, len(seq) - 1))
        ref = decoder.logits_at(weights, m, seq[:-1], at)
        chosen = seq[len(prompts[r]):]
        if control is not None:
            low = decoder.logits_at(weights, m, seq[:-1], at, prec=control)
            chosen = low.argmax(dim=-1).tolist()
            del low
        gaps += decoder.gaps(ref, chosen)
        del ref
    return gaps


def gap_numbers(gaps: Sequence[float]) -> Dict[str, float]:
    """The numbers a cell's limits may name, over every compared token:
    the widest gap, the mean gap, and the share of tokens that are not the
    reference's best (gap above 0); not a number without a token."""
    if not gaps:
        nan = float("nan")
        return {"max_logit_gap": nan, "mean_logit_gap": nan,
                "not_best_share": nan}
    return {"max_logit_gap": max(gaps),
            "mean_logit_gap": sum(gaps) / len(gaps),
            "not_best_share": sum(1 for g in gaps if g > 0) / len(gaps)}


# ------------------------------------------------------------ training
def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, relative to the larger of the reference's
    norm of that leaf and of the median leaf."""
    med = statistics.median(ref.values())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The check's numbers of ``prog`` against ``ref`` (each a dict of
    ``losses``, ``grad_norms``, ``change_norms``): the worst step's loss,
    relative; the worst and the median leaf's gap of first gradients;
    the worst and the median leaf's gap of changes, over the leaves the
    reference moves by more than round-off."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = [n for n in g if g[n] >= 1e-3 * med]
    grad = leaf_gaps(prog["grad_norms"], g, list(g))
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "change_gap_median": statistics.median(change.values())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit; no limits, or a number that is not
    a number (no sample), is not correct."""
    return bool(limits) and all(numbers[k] <= limits[k] for k in limits)


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]
