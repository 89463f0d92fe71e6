"""Continuous-batching serving engine with guided KV-page tiering — the
port of ``repro/serve/engine.py`` (dense and MoE decoders).

The engine serves a decoder from a paged two-tier KV cache
(``serve/kvcache.py``): on the card the fast tier is HBM (CUDA tensors)
and the slow tier pinned host memory.  Each *request* is an allocation
site; its pages are the chunks.  The request lifecycle is the reference's:

    waiting --admit--> [prefilling -->] active <--pause/resume--> paused
        ^                                 |                         |
        +------------- preempt ----------/ <----------------------/
    (any live state) ------------------- finish/cancel ---------> finished

* **Admission**, preemption victims, decode packing and the per-step
  prefill/decode split are ``SchedulerPolicy`` decisions
  (``serve/scheduler.py``).  Requests that can never run are rejected at
  ``add_request`` with an error naming the knob.
* **Prefill** is one-shot: one pass writes the whole prompt's K/V into
  page-table slots and attends with per-token causal lengths
  (``kernels.ops.paged_prefill``).  ``prefill="chunked"`` steps the prompt
  through decode one token at a time and stays as the bitwise oracle;
  ``prefill_chunk_tokens > 0`` interleaves budgeted chunks with decode.
* **Decoding** samples inside the step (``kernels.ops.sample_tokens``);
  the per-row key folds the token's absolute stream position, so
  preemption by recompute and one-shot-vs-chunked prefill replay identical
  streams, and ``temperature=0`` rows are bitwise argmax.
* **Page placement** is Algorithm 1 run by ``core.GuidanceRuntime`` over
  ``PagedKVBackend``: profile -> age-fragmented thermos -> ski-rental ->
  batched page migration between the tiers.

Where the JAX engine returns new pools from a jitted scan over layers, this
one loops over layers in Python and writes K/V in place into
``pool.k_hbm[l]``/``pool.v_hbm[l]``.  Masked rows (inactive decode rows,
padded prefill rows) all write zeros to the reserved scratch slot, so the
duplicate indices of that write are harmless; nothing accumulates through
``index_add_`` or a scatter-add, which are not deterministic on CUDA.

The bitwise invariants (one-shot == chunked == interleaved, preemption by
recompute) need every row's result to depend on that row alone.  The
paged-attention kernel reduces each row in an order fixed by the row; the
projections and norms run in fixed-size row tiles (``tiles.ROW_TILE``)
so that a decode batch and a prefill bucket go through the same GEMM and reduction shapes.  An MoE layer routes every
row of the pass, padded and inactive rows too (they are masked after), as
one ``(1, R, d)`` set through ``models.moe.moe_decode``: per-token routing
and the grouped-expert kernel's per-row order keep those invariants.

Not in this slice: the prefix cache, expert tiering and live migration
between replicas.  A ``ServeConfig`` that asks for one raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import GuidanceConfig, GuidanceRuntime, HardwareModel, MoveStats
from ..core import h100
from ..core.fragmentation import ChunkStats
from ..core.profiler import ArenaProfile, IntervalProfile
from ..core.runtime import MigrationPlan
from ..kernels.ops import paged_attention, paged_prefill, sample_tokens
from ..models.layers import (embed, linear, lm_head, mlp, rmsnorm, rope,
                             rope_freqs)
from ..models.moe import moe_decode
from ..models.transformer import Model
from .eviction import make_eviction_policy
from .kvcache import PagedKVPool
from .sampling import DEFAULT_MAX_TOKENS, SamplingParams
from .scheduler import make_scheduler_policy


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4
    page_size: int = 16
    hbm_pages: int = 64
    host_pages: int = 256
    policy: str = "gdt"            # gdt | lru | fifo (eviction registry)
    interval_steps: int = 16
    strategy: str = "thermos"
    num_fragments: int = 4
    max_pages_per_seq: int = 32
    # Algorithm 1's optional ReweightProfile: decay access counters each
    # interval so placement tracks recent behaviour.
    access_decay: float = 0.5
    # "one_shot" = one pass per prompt; "chunked" = step prompt tokens
    # through decode (the bitwise oracle).
    prefill: str = "one_shot"
    # serve/scheduler.py registry: fifo | priority | drr.
    scheduler: str = "fifo"
    # > 0 caps the prompt tokens ingested per engine step (interleaved
    # prefill, one_shot mode only); 0 prefills a whole prompt at admission.
    prefill_chunk_tokens: int = 0
    # Not ported yet (ROADMAP.md queue A item 7): setting one raises.
    enable_prefix_cache: bool = False
    expert_offchip: bool = False
    # Debug: copy every scheduled row's logits to the host into
    # ``engine.last_logits`` (a full (B, vocab) copy per step).
    keep_logits: bool = False


_NOT_PORTED = {
    "enable_prefix_cache": "the prefix cache (ROADMAP.md queue A item 7)",
    "expert_offchip": "expert tiering (ROADMAP.md queue A item 7)",
}


@dataclasses.dataclass
class Request:
    request_id: int
    tokens: List[int]
    max_new: int
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    generated: List[int] = dataclasses.field(default_factory=list)
    # waiting | prefilling | active | paused | preempted | finished
    state: str = "waiting"
    pos: int = 0                   # tokens written to KV so far
    last_scheduled: int = 0
    # Step this request (re-)entered the wait queue.
    queued_step: int = 0
    truncated: bool = False        # finished early for capacity, not EOS
    # stop | length | truncated | cancelled
    finish_reason: Optional[str] = None

    @property
    def context(self) -> List[int]:
        """Prompt + everything generated so far — what a (re-)prefill must
        ingest (minus the final token, which the next decode step feeds)."""
        return self.tokens + self.generated


@dataclasses.dataclass
class RequestTicket:
    """The serializable identity of an in-flight request: ``(prompt,
    params, generated)`` pins the token stream, because the sampling seed
    is explicit or derived from ``request_id`` and the PRNG folds the
    absolute stream position.  The page table is not part of it."""

    request_id: int
    prompt: List[int]
    max_new: int
    params: SamplingParams
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None


class PagedKVBackend:
    """``TierBackend`` over the engine's paged KV pool.

    Arena = one request's page list; chunk = one page.  ``enforce`` is
    capacity-safe: the reserved scratch slot never appears in the free
    list, demotions run first, and promotions that would exceed the free
    HBM slots are refused — and reflected back into ``last_recs`` so the
    eviction policy sees the placement that exists.  Each direction is one
    batched pool migration.
    """

    name = "paged_kv"

    def __init__(self, pool: PagedKVPool, requests: Dict[int, Request],
                 clock):
        self.pool = pool
        self.requests = requests
        self.clock = clock
        self.last_recs: Dict[int, bool] = {}   # page_id -> recommended fast
        self._telemetry: Dict[int, List[ChunkStats]] = {}

    # ------------------------------------------------------------- protocol
    def snapshot(self) -> IntervalProfile:
        rows: List[ArenaProfile] = []
        telemetry: Dict[int, List[ChunkStats]] = {}
        page_bytes = self.pool.page_bytes
        step = self.clock()
        for rid in self.requests:
            pages = self.pool.request_pages(rid)
            if not pages:
                continue
            fast_pages = sum(1 for p in pages if p.hbm_slot is not None)
            rows.append(ArenaProfile(
                arena_id=rid, site_id=rid, label=f"req{rid}",
                accesses=sum(p.accesses for p in pages),
                resident_bytes=len(pages) * page_bytes,
                fast_fraction=fast_pages / len(pages)))
            telemetry[rid] = [
                ChunkStats(chunk_id=p.page_id, nbytes=page_bytes,
                           accesses=p.accesses,
                           age=step - p.birth_step,
                           fast=p.hbm_slot is not None)
                for p in pages]
        self._telemetry = telemetry
        return IntervalProfile(step, rows, 0, 0.0)

    def telemetry(self) -> Mapping[int, Sequence[ChunkStats]]:
        return self._telemetry

    def reweight(self, decay: float) -> None:
        # Float counters: int(1 * 0.5) would zero any page with a single
        # access per interval, erasing the recency ordering.
        for p in self.pool.pages.values():
            p.accesses = p.accesses * decay

    def on_plan(self, plan: MigrationPlan) -> None:
        # Track the plan every interval (even when the break-even rule says
        # "wait") — the guided eviction policy keys off it.
        self.last_recs = dict(plan.chunk_placement)

    def enforce(self, plan: MigrationPlan) -> MoveStats:
        stats = MoveStats()
        pages = self.pool.pages
        page_bytes = self.pool.page_bytes
        # Demotions first (one batched transfer): free slots for promotions.
        demote = [pid for pid, fast in plan.chunk_placement.items()
                  if not fast and pid in pages
                  and pages[pid].hbm_slot is not None]
        self.pool.swap_out_many(demote)
        stats.bytes_demoted = page_bytes * len(demote)
        # Promotions (one batched transfer), bounded by free HBM slots.
        want = [pid for pid, fast in plan.chunk_placement.items()
                if fast and pid in pages and pages[pid].hbm_slot is None]
        room = len(self.pool.free_hbm)
        promote, refused = want[:room], want[room:]
        self.pool.swap_in_many(promote)
        stats.bytes_promoted = page_bytes * len(promote)
        for pid in refused:
            stats.dropped_promotions += 1
            self.last_recs[pid] = False
        return stats

    def forget_pages(self, page_ids: Sequence[int]) -> None:
        """Drop freed pages from the recommendation view."""
        for pid in page_ids:
            self.last_recs.pop(pid, None)

    def fast_bytes(self) -> int:
        return self.pool.hbm_used() * self.pool.page_bytes


class Engine:
    """The serving engine over ``model`` (a ``models.Model`` whose
    parameters are loaded).  Tensors live on ``model.device``; ``hw``
    defaults to the H100 model with this engine's KV page size."""

    def __init__(self, model: Model, cfg: ServeConfig,
                 hw: Optional[HardwareModel] = None):
        if model.cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"paged engine serves decoder LMs (the dense and moe "
                f"families), not {model.cfg.family!r}: the hybrid family "
                f"serves through Model.init_cache/prefill/decode, as in the "
                f"JAX package")
        for knob, what in _NOT_PORTED.items():
            if getattr(cfg, knob):
                raise NotImplementedError(
                    f"ServeConfig.{knob} asks for {what}, which the PyTorch "
                    f"port does not serve yet")
        if cfg.prefill not in ("one_shot", "chunked"):
            raise ValueError(
                f"ServeConfig.prefill must be 'one_shot' or 'chunked', "
                f"got {cfg.prefill!r}")
        if cfg.prefill_chunk_tokens < 0:
            raise ValueError(
                f"ServeConfig.prefill_chunk_tokens must be >= 0, got "
                f"{cfg.prefill_chunk_tokens}")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        mc = model.cfg
        self.pool = PagedKVPool(
            n_layers=mc.n_layers, page_size=cfg.page_size,
            kv_heads=mc.kv_heads, head_dim=model.head_dim,
            hbm_pages=cfg.hbm_pages, host_pages=cfg.host_pages,
            dtype=mc.dtype, device=self.device)
        self.hw = hw if hw is not None else h100(self.pool.page_bytes)
        self._freqs = rope_freqs(model.head_dim, mc.rope_theta, self.device)
        self.requests: Dict[int, Request] = {}
        self.finished: Dict[int, Request] = {}
        self.wait_queue: Deque[int] = deque()
        self.step_count = 0
        self.eviction = make_eviction_policy(cfg.policy)
        # A fresh policy instance per engine: stateful policies (DRR
        # deficits) must not bleed across engines.
        self.scheduler = make_scheduler_policy(cfg.scheduler)
        # Reserve one HBM slot as the write target for masked rows, so the
        # batched K/V write never collides with a real page.
        self.scratch_slot = self.pool.free_hbm.pop(0)
        self.kv_backend: Optional[PagedKVBackend] = None
        self.runtime: Optional[GuidanceRuntime] = None
        if cfg.policy == "gdt":
            self.kv_backend = PagedKVBackend(
                self.pool, self.requests, clock=lambda: self.step_count)
            self.runtime = GuidanceRuntime(
                self.kv_backend, self.hw,
                GuidanceConfig(
                    strategy=cfg.strategy,
                    # The reserved scratch slot is not placeable capacity.
                    fast_capacity_bytes=(cfg.hbm_pages - 1)
                    * self.pool.page_bytes,
                    interval_steps=cfg.interval_steps,
                    decay=cfg.access_decay,
                    num_fragments=cfg.num_fragments,
                    skip_empty_intervals=True),
                clock=lambda: self.step_count)
        self.last_logits: Dict[int, np.ndarray] = {}
        # --------------------------------------------------- counters
        self.prefill_dispatches = 0    # passes spent on prefill
        self.prefill_tokens = 0        # prompt tokens ingested
        self.prefill_chunks = 0        # interleaved chunk passes
        self.decode_dispatches = 0     # batched decode passes
        self.admissions = 0
        self.admission_wait_steps = 0
        self.preemptions = 0           # requests evicted wholesale
        self.starved_steps = 0         # request-steps skipped for capacity
        self.truncations = 0           # requests finished early for capacity
        self.finish_counts: Dict[str, int] = {
            "stop": 0, "length": 0, "truncated": 0, "cancelled": 0}

    # ------------------------------------------------- telemetry shims
    @property
    def last_recs(self) -> Dict[int, bool]:
        """Latest planned placement — what guided eviction consults."""
        return self.kv_backend.last_recs if self.kv_backend else {}

    @property
    def usable_hbm_pages(self) -> int:
        return self.cfg.hbm_pages - 1          # minus the scratch slot

    def free_logical_pages(self) -> int:
        """Unallocated pages across both tiers — what admission/allocation
        budgets against."""
        return len(self.pool.free_hbm) + len(self.pool.free_host)

    # ================================================== the layer body
    def _attn_half(self, lp, x, kp, vp, *, positions, write_slot, write_off,
                   row_mask, attend):
        """Attention through the pre-FFN rmsnorm, over R rows.

        x: (R, d); kp/vp: one layer's HBM pool views (N, P, K, dh), written
        in place at (write_slot, write_off); positions/row_mask: (R,);
        ``attend(q)`` returns (R, H, dh).  Masked rows write zeros to the
        scratch slot and add nothing to the residual."""
        cfg = self.model.cfg
        H, K, dh = cfg.n_heads, cfg.kv_heads, self.model.head_dim
        R, d = x.shape
        a = lp.attn
        h = rmsnorm(lp.ln1.scale, x)
        q = linear(h, a.wq.reshape(d, H * dh)).reshape(R, H, dh)
        k1 = linear(h, a.wk.reshape(d, K * dh)).reshape(R, K, dh)
        v1 = linear(h, a.wv.reshape(d, K * dh)).reshape(R, K, dh)
        q = rope(q, positions, self._freqs)
        k1 = rope(k1, positions, self._freqs)
        m = row_mask[:, None, None]
        kp[write_slot, write_off] = torch.where(m, k1, 0).to(kp.dtype)
        vp[write_slot, write_off] = torch.where(m, v1, 0).to(vp.dtype)
        o = attend(q)                                     # (R, H, dh)
        y = linear(o.reshape(R, H * dh), a.wo.reshape(H * dh, d))
        x = x + torch.where(row_mask[:, None], y, 0)
        return x, rmsnorm(lp.ln2.scale, x)

    def _ffn_half(self, lp, x, h2, row_mask):
        """SwiGLU FFN or MoE + residual, the second half of a layer.  MoE
        routes all R rows as one (1, R, d) set, as the JAX engine does."""
        moe_cfg = self.model.moe_cfg
        if moe_cfg is not None:
            d = moe_decode(lp.moe, h2[None], moe_cfg)[0]
        else:
            d = mlp(lp.mlp.w_gate, lp.mlp.w_up, lp.mlp.w_down, h2)
        return x + torch.where(row_mask[:, None], d, 0)

    def _layers(self, x, positions, write_slot, write_off, row_mask, attend):
        """Every layer over R rows; ``attend(q, kp, vp)``."""
        pool = self.pool
        for l, lp in enumerate(self.model.layers):
            kp, vp = pool.k_hbm[l], pool.v_hbm[l]
            x, h2 = self._attn_half(
                lp, x, kp, vp, positions=positions, write_slot=write_slot,
                write_off=write_off, row_mask=row_mask,
                attend=lambda q: attend(q, kp, vp))
            x = self._ffn_half(lp, x, h2, row_mask)
        return x

    # ============================================================ decode
    @torch.no_grad()
    def _decode(self, tokens, page_table, lengths, write_slot, write_off,
                active, seeds, temperature, top_k, top_p, use_sampler):
        """One batched decode pass.  tokens: (B,); page_table: (B, MP) HBM
        slots or -1; lengths: (B,) incl. the new token; write_slot/off:
        (B,) where the new token's K/V goes; active: (B,) bool — inactive
        rows compute deterministic zeros.  The sampler's PRNG folds
        ``lengths`` (the next token's stream position).  Returns (logits
        (B, V) f32, next tokens (B,) int32)."""
        window = self.model.cfg.window
        x = embed(self.model.embed.tok, tokens)                  # (B, d)
        x = self._layers(
            x, lengths - 1, write_slot, write_off, active,
            lambda q, kp, vp: paged_attention(q, kp, vp, page_table, lengths,
                                              window=window))
        x = rmsnorm(self.model.final_ln.scale, x)
        logits = lm_head(self.model.head.w, x)
        logits = torch.where(active[:, None], logits, 0.0)
        if use_sampler:
            nxt = sample_tokens(logits, seeds, lengths, temperature, top_k,
                                top_p)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, nxt

    # =========================================================== prefill
    @torch.no_grad()
    def _prefill(self, tokens, page_table, slots, offs, n_real: int,
                 start: int) -> None:
        """One-shot ingestion of S (padded) tokens of one sequence.
        tokens/slots/offs: (S,), padded rows target the scratch slot;
        page_table: (MP,) the request's pages; rows attend by ABSOLUTE
        length over the table, so a chunk at ``start`` replays the
        whole-prompt computation bitwise."""
        S = tokens.shape[0]
        local = torch.arange(S, dtype=torch.int32, device=self.device)
        positions = start + local
        valid = local < n_real
        lengths = torch.where(valid, positions + 1, 0).to(torch.int32)
        window = self.model.cfg.window
        x = embed(self.model.embed.tok, tokens)                  # (S, d)
        self._layers(
            x, positions, slots, offs, valid,
            lambda q, kp, vp: paged_prefill(q, kp, vp, page_table, lengths,
                                            window=window))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ========================================================== requests
    def add_request(self, request_id: int, prompt: List[int],
                    max_new: Optional[int] = None,
                    params: Optional[SamplingParams] = None) -> None:
        """Validate and enqueue; admission happens immediately if the pool
        has room, else at a later ``step()``.  The generation budget is
        ``params.max_tokens`` when set, else ``max_new``, else
        ``DEFAULT_MAX_TOKENS``."""
        if request_id in self.requests or request_id in self.finished:
            raise ValueError(f"duplicate request_id {request_id}")
        if params is None:
            params = SamplingParams()
        if params.max_tokens is not None:
            max_new = params.max_tokens
        elif max_new is None:
            max_new = DEFAULT_MAX_TOKENS
        self._validate_budget(request_id, prompt, max_new)
        req = Request(request_id=request_id, tokens=list(prompt),
                      max_new=max_new, params=params,
                      queued_step=self.step_count)
        self.requests[request_id] = req
        self.wait_queue.append(request_id)
        self._admit_waiting()

    def _validate_budget(self, request_id: int, prompt: Sequence[int],
                         max_new: int) -> None:
        """Reject requests that can NEVER run on this engine, naming the
        knob."""
        if not prompt:
            raise ValueError("empty prompt")
        P = self.cfg.page_size
        MP = self.cfg.max_pages_per_seq
        total_tokens = len(prompt) - 1 + max_new   # tokens written to KV
        if total_tokens > MP * P:
            raise ValueError(
                f"request {request_id} needs {total_tokens} KV tokens "
                f"({len(prompt)} prompt + {max_new} new) but "
                f"max_pages_per_seq={MP} * page_size={P} caps a sequence at "
                f"{MP * P}; raise ServeConfig.max_pages_per_seq or shorten "
                f"the request")
        prompt_pages = -(-max(len(prompt) - 1, 1) // P)
        lifetime_pages = -(-total_tokens // P)
        if min(prompt_pages + 1, lifetime_pages) > self.usable_hbm_pages:
            raise ValueError(
                f"request {request_id}'s prompt needs {prompt_pages} pages "
                f"(+1 to decode) but only {self.usable_hbm_pages} usable "
                f"HBM pages exist (hbm_pages={self.cfg.hbm_pages} minus the "
                f"scratch slot); raise ServeConfig.hbm_pages")

    def export_request(self, request_id: int) -> RequestTicket:
        """Snapshot a live request's serializable identity."""
        req = self.requests.get(request_id)
        if req is None:
            raise ValueError(
                f"cannot export request {request_id}: unknown or finished "
                f"id")
        return RequestTicket(
            request_id=req.request_id, prompt=list(req.tokens),
            max_new=req.max_new, params=req.params,
            generated=list(req.generated))

    # The lifecycle contract: transitions outside it raise a named
    # ValueError instead of silently mutating queue state.
    #   pause:  active -> paused; paused -> no-op; anything else raises.
    #   resume: paused -> active; preempted -> waiting (re-enqueue);
    #           active/waiting -> no-op; finished or unknown ids raise.
    def _lookup(self, request_id: int, verb: str) -> Request:
        req = self.requests.get(request_id)
        if req is None:
            if request_id in self.finished:
                raise ValueError(
                    f"cannot {verb} request {request_id}: already finished "
                    f"(drain the result with pop_finished)")
            raise ValueError(
                f"cannot {verb} request {request_id}: unknown id")
        return req

    def pause(self, request_id: int):
        req = self._lookup(request_id, "pause")
        if req.state == "paused":
            return
        if req.state != "active":
            raise ValueError(
                f"cannot pause request {request_id} in state "
                f"{req.state!r}: only active requests pause (a "
                f"{req.state} request holds no schedulable position)")
        req.state = "paused"

    def resume(self, request_id: int):
        req = self._lookup(request_id, "resume")
        if req.state in ("active", "waiting"):
            return
        if req.state == "paused":
            req.state = "active"
        elif req.state == "preempted":
            # Pages were dropped; re-prefill through admission (exact:
            # one-shot prefill == decode bitwise, and sampling folds the
            # absolute stream position).
            req.state = "waiting"
            req.queued_step = self.step_count
            self.wait_queue.append(request_id)
            self._admit_waiting()

    def cancel(self, request_id: int) -> Request:
        """Withdraw a live request in any state; the result parks in
        ``finished`` with ``finish_reason="cancelled"``."""
        req = self._lookup(request_id, "cancel")
        self._finish(req, reason="cancelled")
        return req

    def pop_finished(self, request_id: Optional[int] = None):
        """Drain finished requests (all, or one)."""
        if request_id is not None:
            return self.finished.pop(request_id)
        out, self.finished = self.finished, {}
        return out

    # ------------------------------------------------------- admission
    def _admit_waiting(self):
        """Policy-ordered admission: admit the policy's head while its
        (re-)prefill pages fit the free logical capacity, preempting paused
        requests' pages when that unblocks the head.  Admission never
        skips past a head that does not fit."""
        P = self.cfg.page_size
        while self.wait_queue:
            head = self.requests.get(self.wait_queue[0])
            if head is None or head.state != "waiting":  # cancelled/stale
                self.wait_queue.popleft()
                continue
            waiting = [r for r in (self.requests.get(rid)
                                   for rid in self.wait_queue)
                       if r is not None and r.state == "waiting"]
            req = self.scheduler.admission_order(waiting, self)[0]
            n_ingest = len(req.context) - 1
            n_pages = -(-n_ingest // P) if n_ingest else 0
            remaining = req.max_new - len(req.generated)
            pages_total = -(-(n_ingest + remaining) // P)
            if min(n_pages + 1, pages_total) > self.usable_hbm_pages:
                # A preempted request whose regenerated context outgrew the
                # fast tier can never decode again.
                self.wait_queue.remove(req.request_id)
                self._finish(req, reason="truncated")
                continue
            # One page of growth slack, capped at the lifetime need.
            if min(n_pages + 1, pages_total) > self.free_logical_pages():
                if not self._preempt_one():
                    return              # head waits; order preserved
                continue
            self.wait_queue.remove(req.request_id)
            self.admissions += 1
            self.admission_wait_steps += self.step_count - req.queued_step
            self._admit(req)

    def _admit(self, req: Request) -> None:
        """Straight to ``active`` via eager prefill, or — with interleaving
        on — into ``prefilling``."""
        budget = self.scheduler.step_budget(self)
        if self.cfg.prefill == "one_shot" and budget.prefill_tokens > 0:
            self._begin_prefill(req)
        else:
            self._prefill_request(req)
            req.state = "active"
        req.last_scheduled = self.step_count

    def _begin_prefill(self, req: Request) -> None:
        """Start an interleaved prefill: allocate the whole prompt's pages
        now (admission budgeted them) and park the request in
        ``prefilling``."""
        n_ingest = len(req.context) - 1
        if n_ingest == 0:
            req.pos = 0
            req.state = "active"
            return
        rid = req.request_id
        n_pages = -(-n_ingest // self.cfg.page_size)
        self._ensure_free_hbm(
            n_pages, needed=[p.page_id for p in self.pool.request_pages(rid)])
        for idx in range(n_pages):
            self.pool.allocate(rid, idx, self.step_count)
        req.pos = 0
        req.state = "prefilling"

    def _advance_prefills(self) -> None:
        """Spend this step's prefill token budget across ``prefilling``
        requests in the policy's prefill order."""
        prefilling = [r for r in self.requests.values()
                      if r.state == "prefilling"]
        if not prefilling:
            return
        budget = self.scheduler.step_budget(self).prefill_tokens
        if budget <= 0:                  # budget turned off mid-flight:
            budget = float("inf")        # drain rather than wedge forever
        for req in self.scheduler.prefill_order(prefilling, self):
            if budget <= 0:
                break
            n_ingest = len(req.context) - 1
            n = int(min(budget, n_ingest - req.pos))
            self._prefill_chunk(req, n)
            budget -= n
            self.scheduler.on_tokens(req, n, self)
            if req.pos >= n_ingest:
                req.state = "active"
                req.last_scheduled = self.step_count

    def _prefill_chunk(self, req: Request, n: int) -> None:
        """Ingest ``req.context[req.pos : req.pos+n]`` with one bucketed
        pass at absolute start ``req.pos``."""
        context = req.context
        P = self.cfg.page_size
        rid = req.request_id
        start = req.pos
        my_pages = self.pool.request_pages(rid)
        # The pass's table covers every page, so the whole sequence must be
        # HBM-resident: one atomic batched exchange (evictions and swap-ins
        # staged together).
        missing = [p.page_id for p in my_pages if p.hbm_slot is None]
        if missing:
            shortfall = len(missing) - len(self.pool.free_hbm)
            victims: List[int] = []
            if shortfall > 0:
                exclude = {p.page_id for p in my_pages}
                cands = [p for p in self.pool.pages.values()
                         if p.hbm_slot is not None
                         and p.page_id not in exclude]
                victims = self.eviction.pick_many(cands, self, shortfall)
                if len(victims) < shortfall:
                    raise MemoryError("no evictable page")  # unreachable:
            self.pool.exchange(victims, missing)      # chunk pages <= usable
            self._note_swap_in(len(missing))
            my_pages = self.pool.request_pages(rid)
        by_index = {p.index_in_seq: p for p in my_pages}
        S = max(P, 1 << (n - 1).bit_length())
        tokens = np.zeros((S,), np.int32)
        tokens[:n] = context[start:start + n]
        slots = np.full((S,), self.scratch_slot, np.int32)
        offs = np.zeros((S,), np.int32)
        written = set()
        for t in range(n):
            idx, off = divmod(start + t, P)
            page = by_index[idx]
            slots[t] = page.hbm_slot
            offs[t] = off
            page.tokens_used = max(page.tokens_used, off + 1)
            written.add(idx)
        self._run_prefill(tokens, self._table(my_pages), slots, offs, n,
                          start)
        req.pos = start + n
        for idx in written:
            by_index[idx].accesses += 1   # the chunk's write set
        self.prefill_dispatches += 1
        self.prefill_chunks += 1
        self.prefill_tokens += n

    def _table(self, pages) -> np.ndarray:
        table = np.full((self.cfg.max_pages_per_seq,), -1, np.int32)
        for p in pages:
            table[p.index_in_seq] = p.hbm_slot
        return table

    def _run_prefill(self, tokens, table, slots, offs, n_real: int,
                     start: int) -> None:
        t = self._tensor
        self._prefill(t(tokens), t(table), t(slots).long(), t(offs).long(),
                      n_real, start)

    def _preempt_one(self) -> bool:
        """Drop ALL pages of the policy's chosen paused victim (preempt by
        recompute: resume re-prefills prompt+generated)."""
        victims = [r for r in self.requests.values()
                   if r.state == "paused"
                   and self.pool.request_pages(r.request_id)]
        if not victims:
            return False
        victim = self.scheduler.preempt_paused(victims, self)
        self._release_pages(victim.request_id)
        victim.pos = 0
        victim.state = "preempted"
        self.preemptions += 1
        return True

    def _release_pages(self, request_id: int):
        freed = self.pool.release_request(request_id)
        if self.kv_backend is not None:
            self.kv_backend.forget_pages(freed)

    def _reclaim_logical_pages(self):
        """Nothing schedulable while active requests exist — logical pages
        are exhausted.  Preempt a paused page-holder first, else the
        policy's running victim (it re-enters the wait queue and recomputes
        later).  A request alone against the whole pool is truncated."""
        if self._preempt_one():
            return
        cands = [r for r in self.requests.values()
                 if r.state in ("active", "prefilling")]
        holders = [r for r in cands
                   if self.pool.request_pages(r.request_id)]
        if not holders:
            return
        if len(cands) == 1 and holders == cands:
            self._finish(cands[0], reason="truncated")
            return
        victim = self.scheduler.preempt_active(holders, self)
        self._release_pages(victim.request_id)
        victim.pos = 0
        victim.state = "waiting"
        victim.queued_step = self.step_count
        self.wait_queue.append(victim.request_id)
        self.preemptions += 1

    # -------------------------------------------------------- prefill
    def _prefill_request(self, req: Request):
        """Ingest ``req.context[:-1]`` (the last token is fed by the first
        decode step): one pass in one_shot mode; the chunked oracle steps
        the tokens through decode."""
        context = req.context
        n_ingest = len(context) - 1
        if n_ingest == 0:
            req.pos = 0
            return
        P = self.cfg.page_size
        rid = req.request_id
        if self.cfg.prefill == "chunked":
            req.pos = 0
            for t in context[:-1]:
                self._decode_one(req, t)
            self.prefill_tokens += n_ingest
            return
        n_pages = -(-n_ingest // P)
        self._ensure_free_hbm(
            n_pages, needed=[p.page_id for p in self.pool.request_pages(rid)])
        pages = [self.pool.allocate(rid, idx, self.step_count)
                 for idx in range(n_pages)]
        # Pad the token axis to a power-of-two bucket (>= one page).
        S = max(P, 1 << (n_ingest - 1).bit_length())
        tokens = np.zeros((S,), np.int32)
        tokens[:n_ingest] = context[:n_ingest]
        slots = np.full((S,), self.scratch_slot, np.int32)
        offs = np.zeros((S,), np.int32)
        for t in range(n_ingest):
            slots[t] = pages[t // P].hbm_slot
            offs[t] = t % P
        self._run_prefill(tokens, self._table(pages), slots, offs, n_ingest,
                          0)
        req.pos = n_ingest
        for i, p in enumerate(pages):
            p.accesses += 1         # the pass's access set: every page
            p.tokens_used = min(P, n_ingest - i * P)
        self.prefill_dispatches += 1
        self.prefill_tokens += n_ingest

    # ------------------------------------------------------- page mgmt
    def _note_swap_in(self, n_pages: int):
        """Demand swap-ins are rental payments."""
        if self.runtime is not None and n_pages:
            self.runtime.record_rental(self.pool.page_bytes * n_pages,
                                       source="swap_in")

    def _page_for_write(self, req: Request) -> Tuple[int, int]:
        """(hbm_slot, offset) for the next token; ``_prepare_batch`` has
        made every page resident and allocated the write page."""
        idx, off = divmod(req.pos, self.cfg.page_size)
        page = self.pool.request_pages(req.request_id)[idx]
        page.tokens_used = off + 1
        return page.hbm_slot, off

    def _prepare_batch(self, reqs: List[Request]):
        """Make the whole scheduled batch resident with ONE atomic batched
        exchange, then allocate write pages."""
        P = self.cfg.page_size
        need_ids: List[int] = []
        missing: List[int] = []
        n_alloc = 0
        for r in reqs:
            pages = self.pool.request_pages(r.request_id)
            need_ids.extend(p.page_id for p in pages)
            missing.extend(p.page_id for p in pages if p.hbm_slot is None)
            if r.pos // P >= len(pages):
                n_alloc += 1
        shortfall = len(missing) + n_alloc - len(self.pool.free_hbm)
        victims: List[int] = []
        if shortfall > 0:
            exclude = set(need_ids)
            cands = [p for p in self.pool.pages.values()
                     if p.hbm_slot is not None and p.page_id not in exclude]
            victims = self.eviction.pick_many(cands, self, shortfall)
            if len(victims) < shortfall:
                raise MemoryError("no evictable page")   # unreachable under
        if victims or missing:                           # scheduler budgets
            self.pool.exchange(victims, missing)
            self._note_swap_in(len(missing))
        for r in reqs:
            idx = r.pos // P
            if idx >= len(self.pool.request_pages(r.request_id)):
                self.pool.allocate(r.request_id, idx, self.step_count)

    def _ensure_free_hbm(self, n: int, needed: List[int]):
        shortfall = n - len(self.pool.free_hbm)
        if shortfall <= 0:
            return
        exclude = set(needed)
        cands = [p for p in self.pool.pages.values()
                 if p.hbm_slot is not None and p.page_id not in exclude]
        victims = self.eviction.pick_many(cands, self, shortfall)
        if len(victims) < shortfall:
            raise MemoryError("no evictable page")   # unreachable under
        self.pool.swap_out_many(victims)             # scheduler budgets

    # ============================================================ stepping
    def _decode_one(self, req: Request, token: int) -> int:
        """Single-request decode (the chunked-prefill oracle path)."""
        self._prepare_batch([req])
        self.prefill_dispatches += 1
        return self._run_batch([(req, token)])[0]

    def _schedule(self) -> List[Request]:
        """Pack active requests (policy decode order) under the HBM-slot
        and logical-page budgets."""
        active = [r for r in self.requests.values() if r.state == "active"]
        if not active:
            return []
        budget = self.scheduler.step_budget(self)
        row_cap = min(self.cfg.max_batch, max(budget.decode_requests, 0))
        P = self.cfg.page_size
        sched: List[Request] = []
        hbm_budget = self.usable_hbm_pages
        logical_budget = self.free_logical_pages()
        for r in self.scheduler.decode_order(active, self):
            if len(sched) == row_cap:
                break
            n_pages = len(self.pool.request_pages(r.request_id))
            need = max(n_pages, r.pos // P + 1)
            if need > self.usable_hbm_pages:
                self._finish(r, reason="truncated")
                continue
            grow = need - n_pages
            if need > hbm_budget or grow > logical_budget:
                self.starved_steps += 1
                continue
            sched.append(r)
            hbm_budget -= need
            logical_budget -= grow
        return sched

    def step(self) -> Dict[int, int]:
        """One engine step: admit, advance interleaved prefills, schedule,
        decode, bookkeeping, then the guidance controller."""
        self.step_count += 1
        self.scheduler.on_step(self)
        self._admit_waiting()
        self._advance_prefills()
        sched = self._schedule()
        if not sched and any(r.state == "active"
                             for r in self.requests.values()):
            self._reclaim_logical_pages()
            sched = self._schedule()
        out: Dict[int, int] = {}
        if sched:
            pairs = []
            for r in sched:
                nxt = (r.generated[-1] if r.generated
                       else (r.tokens[-1] if r.tokens else 1))
                pairs.append((r, nxt))
            self._prepare_batch(sched)
            toks = self._run_batch(pairs)
            for r, t in zip(sched, toks):
                r.generated.append(int(t))
                self.scheduler.on_tokens(r, 1, self)
                out[r.request_id] = int(t)
                if int(t) in r.params.stop_token_ids:
                    self._finish(r, reason="stop")
                elif len(r.generated) >= r.max_new:
                    self._finish(r, reason="length")
        self._tick_controllers()
        return out

    def _tick_controllers(self) -> None:
        """MaybeMigrate for every guidance controller, in a fixed order
        (this slice has one: KV pages)."""
        if self.runtime is not None:
            self.runtime.on_step()

    def _finish(self, req: Request, reason: str = "length"):
        """Free pages, prune the live tables, park the result in
        ``finished`` with its ``finish_reason``."""
        if reason not in self.finish_counts:
            raise ValueError(f"unknown finish reason {reason!r}")
        self._release_pages(req.request_id)
        req.state = "finished"
        req.finish_reason = reason
        req.truncated = reason == "truncated"
        if req.truncated:
            self.truncations += 1
        self.finish_counts[reason] += 1
        self.requests.pop(req.request_id, None)
        self.last_logits.pop(req.request_id, None)
        self.finished[req.request_id] = req

    def _run_batch(self, pairs) -> List[int]:
        """Decode one batch (pages resident, write pages allocated).  Each
        row's ``SamplingParams`` ride along as batched tensors and the PRNG
        folds the row's absolute stream position (== ``lengths``)."""
        B = self.cfg.max_batch
        MP = self.cfg.max_pages_per_seq
        tokens = np.zeros((B,), np.int32)
        table = np.full((B, MP), -1, np.int32)
        lengths = np.zeros((B,), np.int32)
        wslot = np.full((B,), self.scratch_slot, np.int32)
        woff = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        seeds = np.zeros((B,), np.int32)
        temperature = np.zeros((B,), np.float32)   # 0 = greedy argmax
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        for i, (req, tok) in enumerate(pairs):
            req.last_scheduled = self.step_count
            slot, off = self._page_for_write(req)
            req.pos += 1
            for p in self.pool.request_pages(req.request_id):
                p.accesses += 1          # exact access model
                table[i, p.index_in_seq] = p.hbm_slot
            tokens[i] = tok
            lengths[i] = req.pos
            wslot[i] = slot
            woff[i] = off
            active[i] = True
            sp = req.params
            # seed=None: derive from the request id, in the int32 sign-bit
            # half of the space, so it never aliases an explicit seed.
            if sp.seed is not None:
                seeds[i] = sp.seed
            else:
                seeds[i] = (0x80000000 | (req.request_id & 0x7FFFFFFF)) \
                    - (1 << 32)
            temperature[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
        greedy = all(req.params.greedy for req, _ in pairs)
        t = self._tensor
        logits, toks = self._decode(
            t(tokens), t(table), t(lengths), t(wslot).long(), t(woff).long(),
            t(active), t(seeds), t(temperature), t(top_k), t(top_p),
            use_sampler=not greedy)
        self.decode_dispatches += 1
        if self.cfg.keep_logits:
            logits_np = logits.cpu().numpy()
            for i, (req, _) in enumerate(pairs):
                self.last_logits[req.request_id] = logits_np[i]
        toks = toks.tolist()
        return [int(toks[i]) for i in range(len(pairs))]

    # --------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, float]:
        return {
            "steps": self.step_count,
            "swap_ins": self.pool.swaps_in,
            "swap_outs": self.pool.swaps_out,
            "bytes_moved": self.pool.bytes_moved,
            "transfer_events": self.pool.transfer_events,
            "exported_pages": self.pool.exported_pages,
            "imported_pages": self.pool.imported_pages,
            "hbm_pages_used": self.pool.hbm_used(),
            "live_requests": len(self.requests),
            "waiting_requests": len(self.wait_queue),
            "queue_depth": sum(1 for r in self.requests.values()
                               if r.state == "waiting"),
            "prefilling_requests": sum(1 for r in self.requests.values()
                                       if r.state == "prefilling"),
            "finished_requests": len(self.finished),
            "prefill_dispatches": self.prefill_dispatches,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunks": self.prefill_chunks,
            "decode_dispatches": self.decode_dispatches,
            "admissions": self.admissions,
            "admission_wait_steps": self.admission_wait_steps,
            "mean_admission_wait_steps": (
                self.admission_wait_steps / max(self.admissions, 1)),
            "preemptions": self.preemptions,
            "starved_steps": self.starved_steps,
            "truncations": self.truncations,
            "finished_stop": self.finish_counts["stop"],
            "finished_length": self.finish_counts["length"],
            "finished_truncated": self.finish_counts["truncated"],
            "finished_cancelled": self.finish_counts["cancelled"],
        }
