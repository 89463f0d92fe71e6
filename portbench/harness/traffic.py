"""The one traffic generator.  A mix is a data file (``traffic/<mix>.json``)
of parameters; this module turns (seed, parameters) into a schedule.

Two kinds of clients, either or both:

* ``sessions``: chat sessions, each a closed loop.  Its prompt is
  ingested in set-up; each turn resumes it, generates ``turn_tokens`` new
  tokens and pauses it; the next turn is due ``think_s`` after the last
  token of the turn before.
* ``streams``: one-shot requests in an open loop, due at arrival times of
  rate ``rate_per_s`` (Poisson: exponential gaps), each with a ``prompt``
  and an ``output`` length, never resumed.

Every seed gets the same work in the same order: each quantity is a
stratified set of the distribution's quantiles (a choice as its exact
shares, a uniform or exponential at the midpoints of n equal-probability
bins) laid out in one fixed, well-mixed order (by the fractional parts of
i times the golden ratio); the seed draws the token ids, the sampling
seeds and the weights.  (Which long prompt queues behind which makes
most of a tail, so an order drawn from the seed would move the tails from
seed to seed.)
Arrival and length arithmetic: the exponential gap at quantile u is
-mean * ln(1 - u); a uniform integer on [low, high] at u is
low + floor(u * (high - low + 1)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

# Turns drawn per session: more than a window of the longest run can use;
# a session that uses them all starts over at its first.
TURNS_PER_SESSION = 64


def mixed_order(n: int) -> np.ndarray:
    """A fixed permutation of n that spreads neighbours apart."""
    return np.argsort((np.arange(n) * 0.6180339887498949) % 1.0,
                      kind="stable")


def stratified(dist: Dict, n: int) -> np.ndarray:
    """n draws of ``dist``: its stratified set in the fixed mixed order."""
    kind = dist["kind"]
    if kind == "choice":
        w = np.asarray(dist["weights"], float)
        w = w / w.sum()
        exact = w * n
        counts = np.floor(exact).astype(int)
        rest = n - counts.sum()
        for i in np.argsort(-(exact - counts), kind="stable")[:rest]:
            counts[i] += 1
        vals = np.repeat(np.asarray(dist["values"]), counts)
    else:
        u = (np.arange(n) + 0.5) / n
        if kind == "uniform":
            lo, hi = int(dist["low"]), int(dist["high"])
            vals = lo + np.floor(u * (hi - lo + 1)).astype(int)
        elif kind == "exponential":
            vals = -float(dist["mean"]) * np.log1p(-u)
        else:
            raise ValueError(f"unknown distribution kind {kind!r}")
    return vals[mixed_order(n)]


@dataclasses.dataclass
class Session:
    rid: int
    prompt: List[int]
    max_tokens: int
    greedy: bool
    seed: int
    turn_tokens: List[int]
    think_s: List[float]


@dataclasses.dataclass
class OneShot:
    rid: int
    due: float                 # seconds from the start of the window
    prompt: List[int]
    max_tokens: int
    greedy: bool
    seed: int
    stream: str


@dataclasses.dataclass
class Schedule:
    sessions: List[Session]
    arrivals: List[OneShot]    # ordered by due time
    sampling: Dict


def _tokens(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    return rng.integers(0, vocab, size=n).tolist()


def _greedy_flags(share: float, n: int) -> np.ndarray:
    k = int(round(share * n))
    flags = np.zeros(n, bool)
    flags[:k] = True
    return flags[mixed_order(n)]


def make(mix: Dict, seed: int, vocab: int, horizon_s: float,
         first_rid: int = 0) -> Schedule:
    """The schedule of ``mix`` for ``seed``: its sessions and its one-shot
    arrivals over ``horizon_s`` seconds."""
    rng = np.random.default_rng(seed)
    rid = first_rid
    sessions: List[Session] = []
    sp = mix.get("sessions")
    if sp and sp.get("count", 0):
        n = int(sp["count"])
        lens = stratified(sp["prompt"], n)
        greedy = _greedy_flags(sp.get("greedy_share", 0.0), n)
        turns = stratified(sp["turn_tokens"], n * TURNS_PER_SESSION)
        think = stratified(sp["think_s"], n * TURNS_PER_SESSION)
        for i in range(n):
            L = int(lens[i])
            sl = slice(i * TURNS_PER_SESSION, (i + 1) * TURNS_PER_SESSION)
            sessions.append(Session(
                rid=rid, prompt=_tokens(rng, L, vocab),
                max_tokens=int(sp["max_context"]) + 1 - L,
                greedy=bool(greedy[i]),
                seed=int(rng.integers(0, 2 ** 31 - 1)),
                turn_tokens=[int(t) for t in turns[sl]],
                think_s=[float(t) for t in think[sl]]))
            rid += 1
    arrivals: List[OneShot] = []
    for st in mix.get("streams", []):
        rate = float(st["rate_per_s"])
        # floor: the gaps' sum stays under the horizon in every order.
        n = max(1, int(math.floor(rate * horizon_s)))
        gaps = stratified({"kind": "exponential", "mean": 1.0 / rate}, n)
        due = np.cumsum(gaps) - gaps[0] * 0.5
        plens = stratified(st["prompt"], n)
        olens = stratified(st["output"], n)
        greedy = _greedy_flags(st.get("greedy_share", 0.0), n)
        for i in range(n):
            arrivals.append(OneShot(
                rid=0, due=float(due[i]),
                prompt=_tokens(rng, int(plens[i]), vocab),
                max_tokens=int(olens[i]), greedy=bool(greedy[i]),
                seed=int(rng.integers(0, 2 ** 31 - 1)), stream=st["name"]))
    arrivals.sort(key=lambda a: a.due)
    for a in arrivals:
        a.rid = rid
        rid += 1
    return Schedule(sessions, arrivals, dict(mix.get("sampling", {})))


def params_for(greedy: bool, seed: int, max_tokens: int, sampling: Dict):
    """The port's ``SamplingParams`` of one request."""
    from repro_torch.serve.sampling import SamplingParams

    if greedy:
        return SamplingParams(temperature=0.0, seed=seed,
                              max_tokens=max_tokens)
    return SamplingParams(temperature=float(sampling.get("temperature", 0)),
                          top_k=int(sampling.get("top_k", 0)),
                          top_p=float(sampling.get("top_p", 1.0)),
                          seed=seed, max_tokens=max_tokens)


def bucket_lengths(sched: Schedule, page: int) -> List[int]:
    """The one-shot prefill buckets the schedule's prompts fall in (the
    engine pads a prompt's n - 1 ingested tokens to a power of two of at
    least one page)."""
    def bucket(n: int) -> int:
        return max(page, 1 << (max(n - 1, 1) - 1).bit_length())
    lens = [len(s.prompt) for s in sched.sessions]
    lens += [len(a.prompt) for a in sched.arrivals]
    return sorted({bucket(n) for n in lens})

