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
  With ``enable_prefix_cache`` the radix prefix cache
  (``serve/prefix_cache.py``) is consulted first: matched full-page blocks
  attach by reference and the pass runs only over the uncovered suffix at
  its absolute positions; a full hit dispatches nothing.
* **Decoding** samples inside the step (``kernels.ops.sample_tokens``);
  the per-row key folds the token's absolute stream position, so
  preemption by recompute and one-shot-vs-chunked prefill replay identical
  streams, and ``temperature=0`` rows are bitwise argmax.
* **Placement** is Algorithm 1 run by ``core.GuidanceRuntime`` over up to
  three tier objects, ticked in a fixed order each step: KV pages
  (``PagedKVBackend``), shared prefixes (``PrefixBackend``) and, with
  ``expert_offchip``, MoE expert weight blocks (``ExpertBackend`` over
  ``serve/expert_store.py``): profile -> age-fragmented thermos ->
  ski-rental -> batched migration between the tiers.

Where the JAX engine returns new pools from a jitted scan over layers, this
one loops over layers in Python and writes K/V in place into
``pool.k_hbm[l]``/``pool.v_hbm[l]``.  Masked rows (inactive decode rows,
padded prefill rows) all write zeros to the reserved scratch slot, so the
duplicate indices of that write are harmless; nothing accumulates through
``index_add_`` or a scatter-add, which are not deterministic on CUDA.

The bitwise invariants (one-shot == chunked == interleaved, preemption by
recompute, prefix-cached == uncached, tiered experts == resident) need
every row's result to depend on that row alone.  The paged-attention
kernel reduces each row in an order fixed by the row; the projections and
norms run in fixed-size row tiles (``tiles.ROW_TILE``) so that a decode
batch and a prefill bucket go through the same GEMM and reduction shapes.
An MoE layer routes every row of the pass, padded and inactive rows too
(they are masked after), as one ``(1, R, d)`` set through
``models.moe.moe_decode``: per-token routing and the grouped-expert
kernel's per-row order keep those invariants.

With ``expert_offchip`` the engine moves the model's expert stacks into
the store's host tier (pinned host memory on the card) and serves the FFN
out of a bounded cache on the device.  Each layer is then ``_ffn_half``
split in three: ``route_tokens``, a host read of the picks (the store
makes them resident), and ``apply_dropless_flat`` over the cache with the
slot map as ``group_experts`` — the same ops in the same order, so the
streams equal the resident path's whenever a dispatch's working set fits.

Live migration between replicas (``serve/cluster.py``) goes through
``export_request`` / ``remove_request`` / ``import_request``: cold by
recompute from the ticket, warm by the source pool's exported pages.
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
from ..dist.sharding import active_mesh, mesh_sizes
from ..kernels.ops import paged_attention, paged_prefill, sample_tokens
from ..models.layers import (embed, linear, lm_head, mlp, rmsnorm, rope,
                             rope_freqs)
from ..models.moe import apply_dropless_flat, moe_decode, route_tokens
from ..models.transformer import Model
from .eviction import make_eviction_policy
from .expert_store import ExpertBackend, ExpertStore
from .kvcache import PageExport, PagedKVPool
from .prefix_cache import PrefixBackend, PrefixCache
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
    # Cross-request radix prefix cache (serve/prefix_cache.py): prompts
    # that start with the same full-page token blocks share those pages by
    # reference and prefill only the uncovered suffix.  Off by default:
    # cached pages outlive their requests.
    enable_prefix_cache: bool = False
    # A prefix enters the cache only when it spans at least this many full
    # pages.
    min_prefix_pages: int = 1
    # Debug: copy every scheduled row's logits to the host into
    # ``engine.last_logits`` (a full (B, vocab) copy per step).
    keep_logits: bool = False
    # -------- guided expert-weight tiering (serve/expert_store.py) -------
    # Keep the MoE expert weights in host memory and serve the FFN out of a
    # bounded expert cache on the device.  Each layer reads its router's
    # picks on the host; the streams equal the resident path's whenever
    # each dispatch's working set fits the cache.
    expert_offchip: bool = False
    # Cache capacity in (layer, expert) blocks, shared by the layers; 0
    # holds every block.  It must hold one decode dispatch's working set,
    # min(n_experts, max_batch * top_k).
    expert_cache_size: int = 0
    # Stage the next layer's forecast experts on a side stream while this
    # layer's FFN runs.  Off: every miss is a demand fetch (same results).
    expert_double_buffer: bool = True


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
            # Shared prefix pages are the PrefixBackend's tier objects:
            # profiling them here too would govern one page by two
            # controllers (and count its accesses twice).
            pages = [p for p in self.pool.request_pages(rid)
                     if not p.shared]
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
        # access per interval, erasing the recency ordering.  Shared pages
        # decay under the PrefixBackend instead.
        for p in self.pool.pages.values():
            if not p.shared:
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
                f"families), not {model.cfg.family!r}: the hybrid, xlstm, "
                f"encdec and vlm families serve through "
                f"Model.init_cache/prefill/decode, as in the JAX package")
        if model.cfg.family == "moe" and model.cfg.moe_parallelism == "ep":
            # Fail at construction, not mid-decode: an ep pad target that
            # does not divide over the live mesh's model axis would
            # otherwise surface deep inside the all-to-all.
            sizes = mesh_sizes(active_mesh())
            if "model" in sizes:
                model.moe_cfg.validate_ep_axis(int(sizes["model"]))
        if cfg.prefill not in ("one_shot", "chunked"):
            raise ValueError(
                f"ServeConfig.prefill must be 'one_shot' or 'chunked', "
                f"got {cfg.prefill!r}")
        if cfg.prefill_chunk_tokens < 0:
            raise ValueError(
                f"ServeConfig.prefill_chunk_tokens must be >= 0, got "
                f"{cfg.prefill_chunk_tokens}")
        if cfg.expert_offchip:
            self._check_offchip(model, cfg)
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
        # Prefix-cache chains matched at admission for requests still in
        # ``prefilling``: insertion waits until the whole prompt is in.
        self._pending_chains: Dict[int, list] = {}
        # Reserve one HBM slot as the write target for masked rows, so the
        # batched K/V write never collides with a real page.
        self.scratch_slot = self.pool.free_hbm.pop(0)
        self.prefix_cache: Optional[PrefixCache] = None
        if cfg.enable_prefix_cache:
            self.prefix_cache = PrefixCache(
                self.pool, cfg.page_size, min_pages=cfg.min_prefix_pages)
        # The store exists whenever the experts are off the card (its LRU
        # demand management works under any policy); its controller rides
        # only under gdt, like the KV and prefix controllers.
        self.expert_store: Optional[ExpertStore] = None
        if cfg.expert_offchip:
            self.expert_store = self._offload_experts()
        self.kv_backend: Optional[PagedKVBackend] = None
        self.prefix_backend: Optional[PrefixBackend] = None
        self.expert_backend: Optional[ExpertBackend] = None
        self.runtime: Optional[GuidanceRuntime] = None
        self.prefix_runtime: Optional[GuidanceRuntime] = None
        self.expert_runtime: Optional[GuidanceRuntime] = None
        if cfg.policy == "gdt":
            clock = lambda: self.step_count            # noqa: E731
            # The reserved scratch slot is not placeable capacity.
            kv_bytes = (cfg.hbm_pages - 1) * self.pool.page_bytes
            self.kv_backend = PagedKVBackend(self.pool, self.requests, clock)
            self.runtime = self._runtime(self.kv_backend, kv_bytes)
            if self.prefix_cache is not None:
                self.prefix_backend = PrefixBackend(self.prefix_cache, clock)
                self.prefix_runtime = self._runtime(self.prefix_backend,
                                                    kv_bytes)
            if self.expert_store is not None:
                self.expert_backend = ExpertBackend(self.expert_store, clock)
                self.expert_runtime = self._runtime(
                    self.expert_backend, self.expert_store.cache_bytes)
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
        self.saved_prefill_tokens = 0  # prompt tokens served from the cache
        self.expert_host_syncs = 0     # host reads of the tiered path
        self.finish_counts: Dict[str, int] = {
            "stop": 0, "length": 0, "truncated": 0, "cancelled": 0}

    def _runtime(self, backend, capacity_bytes: int) -> GuidanceRuntime:
        cfg = self.cfg
        return GuidanceRuntime(
            backend, self.hw,
            GuidanceConfig(
                strategy=cfg.strategy, fast_capacity_bytes=capacity_bytes,
                interval_steps=cfg.interval_steps, decay=cfg.access_decay,
                num_fragments=cfg.num_fragments, skip_empty_intervals=True),
            clock=lambda: self.step_count)

    @staticmethod
    def _check_offchip(model: Model, cfg: ServeConfig) -> None:
        """The JAX engine's checks of ``expert_offchip``, same texts, and
        a refusal of the capacity dispatch, which the tiered path does not
        run."""
        mc = model.cfg
        if mc.family != "moe":
            raise ValueError(
                "ServeConfig.expert_offchip requires a MoE model: "
                f"family={mc.family!r} has no expert weights to tier")
        if model.moe_cfg.parallelism == "ep":
            raise ValueError(
                "ServeConfig.expert_offchip drives the flat dropless "
                "dispatch; ep parallelism already shards experts across "
                "the mesh — pick one placement mechanism")
        if model.moe_cfg.dispatch != "dropless":
            # The JAX engine runs the tiered path dropless whatever the
            # config says; the port refuses rather than serve another
            # function than the resident engine.
            raise ValueError(
                "ServeConfig.expert_offchip drives the flat dropless "
                f"dispatch; the model's moe_dispatch is "
                f"{model.moe_cfg.dispatch!r}, which the resident path "
                "would serve instead")
        E = model.moe_cfg.padded_experts
        floor = min(E, cfg.max_batch * model.moe_cfg.top_k)
        size = cfg.expert_cache_size or mc.n_layers * E
        if cfg.expert_cache_size < 0 or 0 < size < floor:
            raise ValueError(
                f"ServeConfig.expert_cache_size={cfg.expert_cache_size} "
                f"cannot hold one dispatch's expert working set: a decode "
                f"batch of max_batch={cfg.max_batch} rows with "
                f"top_k={model.moe_cfg.top_k} picks can route up to "
                f"min(n_experts={E}, max_batch*top_k)={floor} distinct "
                f"experts in one layer; raise expert_cache_size to at "
                f"least {floor} (0 = fully resident cache) or lower "
                f"max_batch")

    def _offload_experts(self) -> ExpertStore:
        """Build the expert store and move the model's expert stacks into
        its host tier: each layer's ``w_gate``/``w_up``/``w_down`` becomes a
        view of the store's flat host arrays, so the card keeps only the
        router and the cache."""
        model, cfg = self.model, self.cfg
        mc = model.cfg
        E = model.moe_cfg.padded_experts
        layers = model.layers
        names = ("w_gate", "w_up", "w_down")
        # Overlap window of the modeled prefetch clock: the attention
        # weight bytes each layer reads before the next FFN needs experts.
        attn_bytes = (4 * mc.d_model * mc.n_heads * model.head_dim
                      * layers[0].moe.w_gate.element_size())
        store = ExpertStore(
            {n: [getattr(lp.moe, n) for lp in layers] for n in names},
            mc.n_layers, E, cfg.expert_cache_size or mc.n_layers * E,
            double_buffer=cfg.expert_double_buffer, hw=self.hw,
            window_bytes=attn_bytes, device=self.device)
        for l, lp in enumerate(layers):
            for n in names:
                getattr(lp.moe, n).data = store.host_weights(n, l)
        return store

    # ------------------------------------------------- telemetry shims
    @property
    def decisions(self):
        """Deprecated: ski-rental decisions live on the runtime's event
        stream (``engine.runtime.events``)."""
        return self.runtime.decisions if self.runtime is not None else []

    @property
    def last_recs(self) -> Dict[int, bool]:
        """Latest planned placement across both KV controllers (request
        pages and shared prefixes) — what guided eviction consults.  Page
        ids are unique in the pool, so the merge cannot collide."""
        recs: Dict[int, bool] = {}
        for backend in (self.kv_backend, self.prefix_backend):
            if backend is not None:
                recs.update(backend.last_recs)
        return recs

    @property
    def usable_hbm_pages(self) -> int:
        return self.cfg.hbm_pages - 1          # minus the scratch slot

    def free_logical_pages(self) -> int:
        """Unallocated pages across both tiers — what admission/allocation
        budgets against."""
        return len(self.pool.free_hbm) + len(self.pool.free_host)

    def queue_delay_estimate(self) -> float:
        """Deterministic estimate (in engine steps) of how long a NEW
        request would wait before decoding: the un-ingested prompt-token
        backlog (waiting + mid-prefill) over the per-step prefill capacity,
        plus current decode occupancy.  The Router's dispatch key."""
        backlog = 0
        n_active = 0
        for r in self.requests.values():
            if r.state == "waiting":
                backlog += max(len(r.context) - 1, 1)
            elif r.state == "prefilling":
                backlog += max(len(r.context) - 1 - r.pos, 0)
            elif r.state == "active":
                n_active += 1
        per_step = self.scheduler.step_budget(self).prefill_tokens
        if per_step <= 0:
            # Eager prefill ingests a whole prompt per admission; the
            # page-sized batch capacity is the natural per-step unit.
            per_step = self.cfg.page_size * self.cfg.max_batch
        return backlog / per_step + n_active / self.cfg.max_batch

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

    def _layers(self, x, positions, write_slot, write_off, row_mask, attend,
                mask, wrap_prefetch):
        """Every layer over R rows; ``attend(q, kp, vp)``.  ``mask`` is
        ``row_mask`` on the host, for the tiered FFN; ``wrap_prefetch``: at
        the last layer, stage layer 0's experts by recency."""
        pool = self.pool
        for l, lp in enumerate(self.model.layers):
            kp, vp = pool.k_hbm[l], pool.v_hbm[l]
            x, h2 = self._attn_half(
                lp, x, kp, vp, positions=positions, write_slot=write_slot,
                write_off=write_off, row_mask=row_mask,
                attend=lambda q: attend(q, kp, vp))
            if self.expert_store is None:
                x = self._ffn_half(lp, x, h2, row_mask)
            else:
                x = self._tiered_ffn(l, lp, x, h2, row_mask, mask,
                                     wrap_prefetch)
        return x

    # ================================================ tiered expert path
    def _tiered_ffn(self, l, lp, x, h2, row_mask, mask, wrap_prefetch):
        """``_ffn_half`` out of the expert cache: route, read the picks on
        the host, make the layer's routed experts resident (commit the
        staged prefetch, demand-fetch the misses, evict LRU), run the FFN
        over the cache with the slot map as ``group_experts``, then stage
        the next layer's forecast experts while this FFN runs.

        ``mask`` (host bool per row) keeps padded prefill rows and inactive
        decode rows out of the working set: ``row_mask`` zeroes their FFN
        output in both paths and every row's result is its own, so their
        picks may hit absent experts (slot -1, NaN rows from the kernel)
        without touching a live row's bits.  Same ops, same order as
        ``_ffn_half``."""
        store = self.expert_store
        cfg = self.model.moe_cfg
        gates, experts = route_tokens(lp.moe.router, h2, cfg)
        picks = experts.cpu().numpy()
        self.expert_host_syncs += 1
        counts = np.bincount(picks[mask].reshape(-1),
                             minlength=cfg.padded_experts)
        slot_map = store.dispatch(l, counts, self.step_count)
        nb = store.take_rental_bytes()
        if nb and self.expert_runtime is not None:
            self.expert_runtime.record_rental(nb, source="expert_miss")
        d = apply_dropless_flat(
            gates, experts, h2[None], store.w_gate_cache, store.w_up_cache,
            store.w_down_cache, cfg, expert_slots=store.upload(slot_map))[0]
        x = x + torch.where(row_mask[:, None], d, 0)
        nl = (l + 1) % self.model.cfg.n_layers
        if nl:
            self._spec_prefetch(nl, x, mask)
        elif wrap_prefetch:
            store.prefetch(0, self.step_count)
        return x

    def _spec_prefetch(self, l, x, mask):
        """Forecast layer ``l``'s routed experts from the residual stream
        ``x`` (speculative gating: layer l's own pre-FFN norm and router one
        attention delta early) and stage the likeliest absent ones.  The
        forecast covers the live rows' top-k picks plus a margin of two by
        router mass; it never touches results (a miss is a demand fetch).
        Reads the (R, E) probabilities on the host once."""
        store = self.expert_store
        cfg = self.model.moe_cfg
        live = int(mask.sum())
        if not live or not store.can_prefetch(l):
            return
        lp = self.model.layers[l]
        h2 = rmsnorm(lp.ln2.scale, x)
        probs = torch.softmax(linear(h2.to(torch.float32), lp.moe.router),
                              dim=-1).cpu().numpy()
        self.expert_host_syncs += 1
        mass = probs[mask].sum(axis=0)
        order = np.argsort(-mass, kind="stable")
        cap = min(cfg.padded_experts, live * cfg.top_k + 2)
        store.prefetch(l, self.step_count,
                       predicted=[int(e) for e in order[:cap]])

    # ============================================================ decode
    @torch.no_grad()
    def _decode(self, tokens, page_table, lengths, write_slot, write_off,
                active, seeds, temperature, top_k, top_p, use_sampler,
                mask):
        """One batched decode pass.  tokens: (B,); page_table: (B, MP) HBM
        slots or -1; lengths: (B,) incl. the new token; write_slot/off:
        (B,) where the new token's K/V goes; active: (B,) bool — inactive
        rows compute deterministic zeros; mask: ``active`` on the host.
        The sampler's PRNG folds ``lengths`` (the next token's stream
        position).  Returns (logits (B, V) f32, next tokens (B,) int32)."""
        window = self.model.cfg.window
        x = embed(self.model.embed.tok, tokens)                  # (B, d)
        x = self._layers(
            x, lengths - 1, write_slot, write_off, active,
            lambda q, kp, vp: paged_attention(q, kp, vp, page_table, lengths,
                                              window=window),
            mask, wrap_prefetch=False)
        x = rmsnorm(self.model.final_ln.scale, x)
        logits = lm_head(self.model.head.w, x)
        logits = torch.where(active[:, None], logits, 0.0)
        if use_sampler:
            nxt = sample_tokens(logits, seeds, lengths, temperature, top_k,
                                top_p)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if self.expert_store is not None and self.expert_store.double_buffer:
            # The sampled token is the next step's layer-0 input, so the
            # wrap-around dispatch gets a forecast too (a forecast, not an
            # oracle: the batch may change between steps).
            self._spec_prefetch(0, embed(self.model.embed.tok, nxt), mask)
        return logits, nxt

    # =========================================================== prefill
    @torch.no_grad()
    def _prefill(self, tokens, page_table, slots, offs, n_real: int,
                 start: int) -> None:
        """One-shot ingestion of S (padded) tokens of one sequence.
        tokens/slots/offs: (S,), padded rows target the scratch slot;
        page_table: (MP,) the request's pages (cache-covered prefix
        included); rows attend by ABSOLUTE length over the table, so a chunk
        or a suffix at ``start`` replays the whole-prompt computation
        bitwise."""
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
                                            window=window),
            np.arange(S) < n_real, wrap_prefetch=True)

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

    def remove_request(self, request_id: int) -> Request:
        """Withdraw a live request wholesale — live migration moved it to
        another engine.  Frees pages and prunes the live tables WITHOUT
        marking the request finished (its stream continues elsewhere);
        stale wait-queue entries self-clean in ``_admit_waiting``."""
        req = self.requests.pop(request_id, None)
        if req is None:
            raise ValueError(
                f"cannot remove request {request_id}: unknown or finished "
                f"id")
        self._release_pages(request_id)
        self._pending_chains.pop(request_id, None)
        self.last_logits.pop(request_id, None)
        return req

    def import_request(self, ticket: RequestTicket,
                       kv: Optional[PageExport] = None) -> Request:
        """Continue another engine's request on THIS engine.

        Cold (``kv=None``): the ticket enters the wait queue with its
        generated tokens preloaded, and admission re-prefills
        prompt+generated as it would a preempted request (bitwise: one-shot
        prefill == decode, and sampling folds absolute positions).  Warm
        (``kv`` from the source pool's ``export_pages``): re-attach the
        leading blocks this engine's prefix cache already holds (equal
        chain hashes mean equal pages), import the remaining pages into
        the local pool, and resume decoding with zero recompute.  A warm
        import that cannot fit raises ``MemoryError`` with all partial
        state rolled back, so the caller can retry cold."""
        rid = ticket.request_id
        if rid in self.requests or rid in self.finished:
            raise ValueError(f"duplicate request_id {rid}")
        self._validate_budget(rid, ticket.prompt, ticket.max_new)
        req = Request(request_id=rid, tokens=list(ticket.prompt),
                      max_new=ticket.max_new, params=ticket.params,
                      generated=list(ticket.generated),
                      queued_step=self.step_count)
        if kv is None:
            self.requests[rid] = req
            self.wait_queue.append(rid)
            self._admit_waiting()
            return req
        context = req.context
        n_ingest = len(context) - 1
        self.requests[rid] = req
        try:
            chain = []
            if self.prefix_cache is not None:
                chain = self.prefix_cache.match(
                    context[:n_ingest], self.step_count, count=False)
                hit_ids = [n.page_id for n in chain]
                missing = [pid for pid in hit_ids
                           if self.pool.pages[pid].hbm_slot is None]
                if missing:
                    self._ensure_free_hbm(len(missing), needed=hit_ids)
                    self.pool.swap_in_many(missing)
                for node in chain:
                    self.pool.attach(rid, node.page_id, self.step_count)
            self.pool.import_pages(kv.select_from(len(chain)), rid,
                                   self.step_count)
        except MemoryError:
            self._release_pages(rid)
            self.requests.pop(rid, None)
            raise
        req.pos = n_ingest
        req.state = "active"
        req.last_scheduled = self.step_count
        # Adopt the migrated prompt's full-page blocks into the local cache
        # under their (identical) chain hashes, so sharing survives the
        # membership change.
        self._insert_prefix(req, context, n_ingest, chain)
        return req

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
            need = min(n_pages + 1, pages_total)
            if need > self.free_logical_pages():
                # Cold cached prefixes yield their logical pages before any
                # live request is preempted.
                if (self.prefix_cache is not None and self.prefix_cache
                        .reclaim(need - self.free_logical_pages())):
                    continue
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
        """Start an interleaved prefill: consult the prefix cache, allocate
        the whole uncovered suffix's pages now (admission budgeted them)
        and park the request in ``prefilling``.  An empty ingest or a full
        cache hit goes straight to ``active``."""
        context = req.context
        n_ingest = len(context) - 1
        if n_ingest == 0:
            req.pos = 0
            req.state = "active"
            return
        P = self.cfg.page_size
        rid = req.request_id
        chain = self._match_prefix(req, context, n_ingest)
        covered = len(chain) * P
        if covered == n_ingest:
            req.pos = n_ingest           # full hit: nothing to dispatch
            req.state = "active"
            return
        n_prefix_pages = covered // P
        n_pages = -(-n_ingest // P) - n_prefix_pages
        self._ensure_free_hbm(
            n_pages, needed=[p.page_id for p in self.pool.request_pages(rid)])
        for idx in range(n_pages):
            self.pool.allocate(rid, n_prefix_pages + idx, self.step_count)
        req.pos = covered
        req.state = "prefilling"
        self._pending_chains[rid] = chain

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
                chain = self._pending_chains.pop(req.request_id, [])
                self._insert_prefix(req, req.context, n_ingest, chain)
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
            if not by_index[idx].shared:
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
        are exhausted.  Reclaim a cold cached prefix first, then preempt a
        paused page-holder, else the policy's running victim (it re-enters
        the wait queue and recomputes later).  A request alone against the
        whole pool is truncated."""
        if self.prefix_cache is not None and self.prefix_cache.reclaim(1):
            return
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
        self._pending_chains.pop(victim.request_id, None)
        self.wait_queue.append(victim.request_id)
        self.preemptions += 1

    # -------------------------------------------------------- prefill
    def _match_prefix(self, req: Request, context: List[int],
                      n_ingest: int) -> list:
        """Consult the prefix cache and attach every matched full-page block
        to the request by reference.  Returns the matched node chain (empty
        without a cache or on a miss).  Matched pages are made HBM-resident
        here: the suffix pass (or the first decode, on a full hit) attends
        over them."""
        if self.prefix_cache is None:
            return []
        chain = self.prefix_cache.match(context[:n_ingest], self.step_count)
        if not chain:
            return []
        hit_ids = [n.page_id for n in chain]
        missing = [pid for pid in hit_ids
                   if self.pool.pages[pid].hbm_slot is None]
        if missing:
            self._ensure_free_hbm(len(missing), needed=hit_ids)
            self.pool.swap_in_many(missing)
            # A hit on a demoted prefix is rent paid on the PREFIX
            # controller's ledger (it made the demotion call).
            if self.prefix_runtime is not None:
                self.prefix_runtime.record_rental(
                    self.pool.page_bytes * len(missing), source="prefix_hit")
        for node in chain:
            self.pool.attach(req.request_id, node.page_id, self.step_count)
        self.saved_prefill_tokens += len(chain) * self.cfg.page_size
        return chain

    def _insert_prefix(self, req: Request, context: List[int],
                       n_ingest: int, chain: list) -> None:
        """Adopt the request's freshly written full-page PROMPT blocks into
        the cache (generated tokens never extend a shareable prefix).
        ``chain`` is what ``_match_prefix`` covered; the radix walk goes on
        from there."""
        if self.prefix_cache is None:
            return
        self.prefix_cache.insert(
            context[:n_ingest], self.pool.request_pages(req.request_id),
            limit=min(n_ingest, len(req.tokens)), step=self.step_count,
            chain=chain)

    def _prefill_request(self, req: Request):
        """Ingest ``req.context[:-1]`` (the last token is fed by the first
        decode step).  The prefix cache is consulted first: matched blocks
        attach by reference and only the uncovered suffix is ingested — one
        pass at absolute start ``covered`` in one_shot mode (a full hit
        dispatches nothing); the chunked oracle steps the suffix tokens
        through decode."""
        context = req.context
        n_ingest = len(context) - 1
        if n_ingest == 0:
            req.pos = 0
            return
        P = self.cfg.page_size
        rid = req.request_id
        chain = self._match_prefix(req, context, n_ingest)
        covered = len(chain) * P
        n_suffix = n_ingest - covered
        if n_suffix == 0:
            req.pos = n_ingest     # full hit: every ingested token is shared
            return
        if self.cfg.prefill == "chunked":
            req.pos = covered
            for t in context[covered:-1]:
                self._decode_one(req, t)
            self.prefill_tokens += n_suffix
            self._insert_prefix(req, context, n_ingest, chain)
            return
        n_prefix_pages = covered // P
        n_pages = -(-n_ingest // P) - n_prefix_pages
        self._ensure_free_hbm(
            n_pages, needed=[p.page_id for p in self.pool.request_pages(rid)])
        pages = [self.pool.allocate(rid, n_prefix_pages + idx,
                                    self.step_count)
                 for idx in range(n_pages)]
        # Pad the token axis to a power-of-two bucket (>= one page).
        S = max(P, 1 << (n_suffix - 1).bit_length())
        tokens = np.zeros((S,), np.int32)
        tokens[:n_suffix] = context[covered:n_ingest]
        slots = np.full((S,), self.scratch_slot, np.int32)
        offs = np.zeros((S,), np.int32)
        # ``covered`` is page-aligned: suffix token t lands at page t // P,
        # offset t % P of the private tail.
        for t in range(n_suffix):
            slots[t] = pages[t // P].hbm_slot
            offs[t] = t % P
        self._run_prefill(tokens, self._table(self.pool.request_pages(rid)),
                          slots, offs, n_suffix, covered)
        req.pos = n_ingest
        for i, p in enumerate(pages):
            p.accesses += 1         # the pass's access set: every new page
            p.tokens_used = min(P, n_suffix - i * P)
        self.prefill_dispatches += 1
        self.prefill_tokens += n_suffix
        self._insert_prefix(req, context, n_ingest, chain)

    # ------------------------------------------------------- page mgmt
    def _note_swap_in(self, n_pages: int):
        """Demand swap-ins are rental payments."""
        if self.runtime is not None and n_pages:
            self.runtime.record_rental(self.pool.page_bytes * n_pages,
                                       source="swap_in")

    def _page_for_write(self, req: Request) -> Tuple[int, int]:
        """(hbm_slot, offset) for the next token; ``_prepare_batch`` has
        made every page resident and allocated the write page.  Sharing is
        full-page granular, so the write target is never shared on the
        normal path; if it is, the request gets a private copy
        (copy-on-write) rather than changing every holder's K/V."""
        idx, off = divmod(req.pos, self.cfg.page_size)
        page = self.pool.request_pages(req.request_id)[idx]
        if page.refcount > 1 or page.shared:
            page = self.pool.copy_page(page.page_id, req.request_id,
                                       self.step_count)
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
        """MaybeMigrate for every guidance controller, in a FIXED order:
        KV pages -> shared prefixes -> expert weights.  The order is part
        of the replay contract (it decides which controller sees the
        interval's free HBM first); new controllers go at the end."""
        for rt in (self.runtime, self.prefix_runtime, self.expert_runtime):
            if rt is not None:
                rt.on_step()

    def _finish(self, req: Request, reason: str = "length"):
        """Free pages, prune the live tables, park the result in
        ``finished`` with its ``finish_reason``."""
        if reason not in self.finish_counts:
            raise ValueError(f"unknown finish reason {reason!r}")
        self._pending_chains.pop(req.request_id, None)
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
            use_sampler=not greedy, mask=active)
        self.decode_dispatches += 1
        if self.cfg.keep_logits:
            logits_np = logits.cpu().numpy()
            for i, (req, _) in enumerate(pairs):
                self.last_logits[req.request_id] = logits_np[i]
        toks = toks.tolist()
        return [int(toks[i]) for i in range(len(pairs))]

    # --------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, float]:
        pc = self.prefix_cache
        prefix = {
            "prefix_lookups": pc.lookups,
            "prefix_hit_requests": pc.hit_requests,
            "prefix_hit_pages": pc.hit_pages,
            "prefix_hit_rate": pc.hit_rate,
            "prefix_cached_pages": len(pc),
            "prefix_inserted_pages": pc.inserted_pages,
            "prefix_evicted_pages": pc.evicted_pages,
        } if pc is not None else {}
        es = self.expert_store
        expert = {
            "expert_cache_slots": es.cache_slots,
            "expert_resident_blocks": sum(
                1 for b in es.blocks.values() if b.slot is not None),
            "expert_demand_fetches": es.demand_fetches,
            "expert_prefetch_fetches": es.prefetch_fetches,
            "expert_prefetch_hits": es.prefetch_hits,
            "expert_dropped_prefetches": es.dropped_prefetches,
            "expert_evictions": es.evictions,
            "expert_bytes_fetched": es.bytes_fetched,
            "expert_transfer_events": es.transfer_events,
            # Host reads of the device on the tiered path: the picks of
            # every layer, and each forecast's router probabilities.
            "expert_host_syncs": self.expert_host_syncs,
        } if es is not None else {}
        return {
            **prefix,
            **expert,
            "saved_prefill_tokens": self.saved_prefill_tokens,
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
