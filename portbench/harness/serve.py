"""The serving driver: set-up, the measured window and its records, over
the port's front door (``repro_torch.serve.api.LLM``: ``submit``, ``step``,
``pause``, ``resume``).

Times are the host's clock.  A one-shot request is due at its arrival; a
session's turn is due when its think time after the turn before has
passed.  Its time to first token runs from when it was due to the end of
the step that produced the token; a token's time is the end of its step,
whose last act (the sampled tokens read on the host) waits for the
device."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from . import trace, traffic
from .trace import clock

# After the window, the loop goes on (with no new arrivals) until every
# request due in it has its first token, for at most this long.
DRAIN_S = 45.0


@dataclasses.dataclass
class Due:
    """One request or turn: when it was due and when its tokens came."""
    rid: int
    due: float
    stream: str
    tokens: List[float] = dataclasses.field(default_factory=list)
    released: Optional[float] = None


class Driver:
    """Drives one schedule through ``llm``: releases what is due, steps,
    pauses sessions whose turn is done, and records every token."""

    def __init__(self, llm, sched: traffic.Schedule):
        self.llm = llm
        self.sched = sched
        self.sessions = {s.rid: s for s in sched.sessions}
        self.turn_index: Dict[int, int] = {}
        self.turn_left: Dict[int, int] = {}
        self.next_due: Dict[int, float] = {}     # session -> absolute due
        self.arrivals = list(sched.arrivals)
        self.next_arrival = 0
        self.t0 = 0.0
        self.open: Dict[int, Due] = {}            # rid -> current record
        self.records: List[Due] = []
        self.lateness: List[tuple] = []           # (due, released)
        self.step_walls: List[tuple] = []         # (end, seconds)
        self.token_times: List[float] = []        # one per token
        self.served: Dict[int, List[int]] = {}    # rid -> tokens in order
        self.prompts: Dict[int, List[int]] = {}
        self.greedy: Dict[int, bool] = {}
        self.finished: set = set()

    # ------------------------------------------------------------ set-up
    def open_sessions(self) -> None:
        """Ingest every session's prompt (admission prefills it) and park
        it paused; its first turn is due after its first think time."""
        for s in self.sched.sessions:
            p = traffic.params_for(s.greedy, s.seed, s.max_tokens,
                                   self.sched.sampling)
            self.llm.submit(s.prompt, p, request_id=s.rid)
            self.llm.pause(s.rid)
            self.prompts[s.rid] = s.prompt
            self.greedy[s.rid] = s.greedy
            self.served[s.rid] = []
            self.turn_index[s.rid] = 0

    def start(self, t0: float, t_sessions: Optional[float] = None) -> None:
        """Start the one-shot arrivals' clock at ``t0`` and the sessions'
        at ``t_sessions`` (default ``t0``)."""
        self.t0 = t0
        ts = t0 if t_sessions is None else t_sessions
        for rid, s in self.sessions.items():
            self.next_due[rid] = ts + s.think_s[0]

    # --------------------------------------------------------- releasing
    def release_due(self, now: float) -> None:
        for rid, due in list(self.next_due.items()):
            if due <= now:
                del self.next_due[rid]
                s = self.sessions[rid]
                i = self.turn_index[rid] % len(s.turn_tokens)
                self.turn_left[rid] = s.turn_tokens[i]
                self.llm.resume(rid)
                t = clock()
                self._open(rid, due, "turn", t)
        while (self.next_arrival < len(self.arrivals)
               and self.t0 + self.arrivals[self.next_arrival].due <= now):
            a = self.arrivals[self.next_arrival]
            self.next_arrival += 1
            due = self.t0 + a.due
            p = traffic.params_for(a.greedy, a.seed, a.max_tokens,
                                   self.sched.sampling)
            self.prompts[a.rid] = a.prompt
            self.greedy[a.rid] = a.greedy
            self.served[a.rid] = []
            rec = self._open(a.rid, due, a.stream, None)
            self.llm.submit(a.prompt, p, request_id=a.rid)
            rec.released = clock()
            self.lateness.append((due, rec.released))

    def _open(self, rid, due, stream, released) -> Due:
        rec = Due(rid=rid, due=due, stream=stream, released=released)
        if released is not None:
            self.lateness.append((due, released))
        self.open[rid] = rec
        self.records.append(rec)
        return rec

    def next_event(self) -> float:
        nxt = min(self.next_due.values(), default=float("inf"))
        if self.next_arrival < len(self.arrivals):
            nxt = min(nxt, self.t0 + self.arrivals[self.next_arrival].due)
        return nxt

    def busy(self) -> bool:
        return any(r.state in ("active", "waiting", "prefilling")
                   for r in self.llm.engine.requests.values())

    # ----------------------------------------------------------- stepping
    def step(self) -> None:
        t_a = clock()
        out = self.llm.step()
        t = clock()
        self.step_walls.append((t, t - t_a))
        for rid, tok in out.items():
            self.token_times.append(t)
            self.served.setdefault(rid, []).append(int(tok))
            rec = self.open.get(rid)
            if rec is not None:
                rec.tokens.append(t)
            if rid in self.turn_left:
                self.turn_left[rid] -= 1
                if self.turn_left[rid] == 0:
                    del self.turn_left[rid]
                    self.open.pop(rid, None)
                    s = self.sessions[rid]
                    if self.llm.is_live(rid):
                        self.llm.pause(rid)
                        i = self.turn_index[rid]
                        self.turn_index[rid] = i + 1
                        self.next_due[rid] = t + s.think_s[
                            (i + 1) % len(s.think_s)]
        for rid in list(self.open):
            if rid not in self.sessions and not self.llm.is_live(rid):
                self.open.pop(rid)
                self.finished.add(rid)

    def run_until(self, t_end: float, release: bool = True,
                  stop=None) -> None:
        """Release what is due and step until ``t_end`` (or ``stop()`` is
        true); with ``release`` off, only step what was released."""
        while True:
            now = clock()
            if now >= t_end or (stop is not None and stop()):
                return
            if release:
                self.release_due(now)
            if self.busy():
                self.step()
            elif not release:
                return
            else:
                wake = min(self.next_event(), t_end)
                time.sleep(max(0.0, min(wake - clock(), 0.05)))


def warm(llm, mix: Dict, seed: int, vocab: int, page: int,
         first_rid: int) -> None:
    """Run the paths the cell's traffic uses once: a prefill (every
    projection runs in fixed 16-row tiles, so one prompt bucket, the
    mix's smallest, stands for all) and decode steps with greedy and with
    sampled rows.  Requests here use ids above the schedule's."""
    from repro_torch.serve.sampling import SamplingParams

    buckets = traffic.bucket_lengths(traffic.make(mix, seed, vocab, 4.0),
                                     page)
    rng = torch.Generator().manual_seed(seed % (1 << 62))
    rid = first_rid
    samp = mix.get("sampling", {})
    for greedy in (True, False):
        for b in buckets[:1]:
            n = b + 1                         # ingests exactly b tokens
            prompt = torch.randint(0, vocab, (n,), generator=rng).tolist()
            if greedy:
                p = SamplingParams(temperature=0.0, max_tokens=3)
            else:
                p = SamplingParams(
                    temperature=float(samp.get("temperature", 0.7)),
                    top_k=int(samp.get("top_k", 0)),
                    top_p=float(samp.get("top_p", 1.0)),
                    seed=rid, max_tokens=3)
            llm.submit(prompt, p, request_id=rid)
            rid += 1
            while llm.engine.requests:
                llm.step()


def serve_patches(engine, spans: trace.Spans) -> List:
    """Synchronised spans around the layers of the serving path."""
    pool = engine.pool
    out = [(engine, "_decode", spans.wrap("decode")),
           (engine, "_prefill", spans.wrap(
               "prefill", note=lambda *a, **k: {"prefill_tokens": a[4]})),
           (pool, "exchange", spans.wrap("migration.exchange")),
           (pool, "swap_in_many", spans.wrap("migration.swap_in")),
           (pool, "swap_out_many", spans.wrap("migration.swap_out")),
           (engine.eviction, "pick_many", spans.wrap("eviction"))]
    for rt in (engine.runtime, engine.prefix_runtime, engine.expert_runtime):
        if rt is not None:
            out.append((rt, "on_step", spans.wrap("guidance")))
    return out


def profile_patches(engine, calls: trace.Calls, marks) -> List:
    """Call records (by shape, no synchronisation) and host phase marks
    for the profiled slice."""
    import repro_torch.kernels.ops as ops
    import repro_torch.serve.engine as eng

    def decode_info(tokens, page_table, lengths, *a, mask=None, **k):
        return {"lengths": lengths, "mask": mask}

    def prefill_info(tokens, page_table, slots, offs, n_real, start):
        return {"n_real": int(n_real), "start": int(start)}

    def ffn_info(x, w_gate, w_up, w_down, group_sizes, group_experts=None):
        return {"rows": x.shape[0], "d": w_gate.shape[1],
                "f": w_gate.shape[2], "item": x.element_size(),
                "sizes": group_sizes, "experts": group_experts,
                "n_weights": w_gate.shape[0]}

    out = [(engine, "_decode", calls.record("decode_pass", decode_info)),
           (engine, "_prefill", calls.record("prefill_pass", prefill_info)),
           (ops, "moe_grouped_ffn", calls.record("grouped_ffn", ffn_info))]
    for obj, name, phase in (
            (engine, "_decode", "decode"), (engine, "_prefill", "prefill"),
            (engine, "_admit_waiting", "admission"),
            (engine, "_schedule", "scheduler"),
            (engine, "_prepare_batch", "migration"),
            (engine, "_tick_controllers", "guidance"),
            (engine.pool, "exchange", "migration"),
            (engine.pool, "swap_in_many", "migration"),
            (engine.pool, "swap_out_many", "migration"),
            (eng, "paged_attention", "attention launch"),
            (eng, "paged_prefill", "attention launch")):
        out.append((obj, name, trace.marking(marks, phase)))
    return out


def engine_of(llm):
    """The single engine behind the front door."""
    return llm.cluster.replicas[0].engine


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Dict, seed: int, seconds: float, traced: bool,
             device, t_process: float, parts=(0.5, 0.25, 0.25)):
    """Set up, measure, drain; returns (record, driver, weights).

    The record holds what the metric readers read (``harness/record.py``).
    Untraced, the whole window is measured plainly; traced, its parts run
    plainly, under synchronised spans, and under the profiler, in turn."""
    from repro_torch.serve.api import LLM
    from repro_torch.serve.engine import ServeConfig

    from . import record, weights as W

    m = cell["model"]
    model, weights = W.build_model(m, seed, device)
    cfg = ServeConfig(**cell["serve"])
    llm = LLM(model, cfg)
    engine = engine_of(llm)
    vocab = m["vocab_size"]
    # Every open-loop arrival falls in the window, so that each seed's
    # window holds the same set of requests, in another order.
    sched = traffic.make(cell["mix"], seed, vocab, horizon_s=seconds)
    drv = Driver(llm, sched)
    warm(llm, cell["mix"], seed, vocab, cfg.page_size, first_rid=10 ** 9)
    trace.sync(device)
    drv.open_sessions()
    # Sessions run for ``warm_in_s`` before the window, so that it opens
    # on turns in steady state and not on the first turns' burst; the
    # one-shot arrivals start with the window.
    warm_in = float(cell["mix"].get("warm_in_s", 0.0))
    t_sessions = clock()
    drv.start(t_sessions + warm_in, t_sessions)
    drv.run_until(t_sessions + warm_in)
    trace.reset_peak(device)
    w0 = clock()
    setup_s = w0 - t_process
    drv.t0 = w0
    rec = record.Record(kind="serve", cell=cell, model=m, setup_s=setup_s)
    rec.stats0 = engine.stats()
    shares = parts if traced else (1.0,)
    ends = [w0 + seconds * sum(shares[:i + 1]) for i in range(len(shares))]
    drv.run_until(ends[0])
    w1 = clock()
    rec.stats1 = engine.stats()
    rec.window = (w0, w1)
    if traced:
        spans = trace.Spans()
        tb = clock()
        with trace.patched(serve_patches(engine, spans)):
            drv.run_until(ends[1])
        rec.spans, rec.spans_wall = spans, clock() - tb
        calls, marks = trace.Calls(), []
        with trace.patched(profile_patches(engine, calls, marks)):
            rec.device = trace.profiled(
                lambda: drv.run_until(clock() + seconds * shares[2]),
                calls, marks)
    rec.memory_peak_bytes = trace.peak_bytes(device)
    due_in = [r for r in drv.records if w0 <= r.due < w1]
    t_drain = clock() + DRAIN_S
    drv.run_until(t_drain, release=False,
                  stop=lambda: all(r.tokens for r in due_in))
    rec.drain_end = clock()
    rec.records = drv.records
    rec.token_times = drv.token_times
    rec.lateness = drv.lateness
    rec.step_walls = drv.step_walls
    rec.attempted = len(due_in)
    rec.failed = sum(1 for r in due_in if not r.tokens)
    return rec, drv, weights, (llm, model, engine)
