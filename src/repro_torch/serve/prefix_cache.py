"""Cross-request radix prefix cache with guided tier placement — the port
of ``repro/serve/prefix_cache.py``.

Many requests share system prompts and few-shot prefixes, yet a paged
engine that keys KV pages by request pays full prefill for every arrival.
This module makes the shared prefix a first-class object:

* **Radix tree over full-page token blocks.**  A node is one FULL page of
  tokens (``page_size`` of them) holding a refcounted page in
  ``PagedKVPool``; the path from a root to a node spells the token prefix it
  caches.  Keys are chain hashes — ``h_i = blake2b(h_{i-1} || block_i)`` —
  so a block's identity commits to its entire left context, and children are
  bucketed by their literal token block (exact match, no collisions decide
  placement).  Only full pages are cached: sharing is page-granular, which
  is what makes shared pages immutable (a request's first private write
  always lands on a fresh page past the covered prefix, so the
  copy-on-write rule ``refcount > 1 == read-only`` is never hit on the
  normal path).

* **Determinism.**  K/V for a token depend only on the token sequence and
  absolute positions — not on batching, chunking or sampling — and the
  engine's one-shot prefill == chunked prefill == decode bitwise (the
  paged kernel reduces each row in an order fixed by the row).  A cached
  block is therefore bitwise equal to what a fresh prefill of the same
  tokens would write, and a suffix-only prefill over a matched prefix
  replays the uncached computation exactly.

* **Guided placement (the paper's loop, applied to the KV cache itself).**
  ``PrefixBackend`` exposes the cache to ``GuidanceRuntime``: arena = one
  root subtree (one distinct leading block ~ one system prompt), chunk =
  one cached page, and the access profile is the per-interval HIT count —
  observed previous usage, no separate profiling run.  Ski-rental decides
  promote/demote and enforcement routes through the pool's batched
  ``exchange``, so hot shared prefixes stay in HBM while cold ones demote
  to pinned host memory (or are reclaimed entirely under logical-page
  pressure).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.fragmentation import ChunkStats
from ..core.profiler import ArenaProfile, IntervalProfile
from ..core.runtime import MigrationPlan, MoveStats
from .kvcache import Page, PagedKVPool

Block = Tuple[int, ...]


def block_hash(parent_key: bytes, tokens: Sequence[int]) -> bytes:
    """Chain hash of one full-page token block: commits to the whole prefix
    through ``parent_key``, so equal keys mean equal token chains."""
    h = hashlib.blake2b(parent_key, digest_size=16)
    h.update(("|".join(str(int(t)) for t in tokens)).encode())
    return h.digest()


@dataclasses.dataclass(eq=False)       # identity semantics: tree nodes are
class PrefixNode:                      # unique objects, and dict-keyable
    """One cached full-page block: a radix-tree edge + its physical page."""

    key: bytes                    # chain hash of the prefix through here
    tokens: Block                 # this page's token block (len == page_size)
    page_id: int
    depth: int                    # == Page.index_in_seq
    parent: Optional["PrefixNode"]
    birth_step: int
    children: Dict[Block, "PrefixNode"] = dataclasses.field(
        default_factory=dict)
    # Per-interval hit counts are the access profile guidance consumes
    # (float: ReweightProfile decays them, same rationale as Page.accesses).
    hits: float = 0.0
    last_hit_step: int = 0

    def root(self) -> "PrefixNode":
        node = self
        while node.parent is not None:
            node = node.parent
        return node


class PrefixCache:
    """Radix tree mapping prompt prefixes to refcounted ``PagedKVPool``
    pages.  The cache holds ONE reference per cached page (taken at
    ``insert``, dropped at ``release``/``reclaim``); attached requests hold
    their own references through the pool's sequence table."""

    def __init__(self, pool: PagedKVPool, page_size: int,
                 min_pages: int = 1):
        if min_pages < 1:
            raise ValueError(
                f"min_prefix_pages must be >= 1, got {min_pages}")
        self.pool = pool
        self.page_size = page_size
        self.min_pages = min_pages
        self.roots: Dict[Block, PrefixNode] = {}
        self.by_page: Dict[int, PrefixNode] = {}
        # ------------------------------------------------------ counters
        self.lookups = 0          # match() calls (one per prefill)
        self.hit_requests = 0     # lookups that matched >= 1 page
        self.hit_pages = 0        # total pages served from the cache
        self.inserted_pages = 0   # pages adopted into the tree
        self.evicted_pages = 0    # pages reclaimed out of the tree

    def __len__(self) -> int:
        return len(self.by_page)

    def nodes(self) -> List[PrefixNode]:
        return list(self.by_page.values())

    @property
    def hit_rate(self) -> float:
        return self.hit_requests / self.lookups if self.lookups else 0.0

    # ------------------------------------------------------------- match
    def match(self, tokens: Sequence[int], step: int,
              count: bool = True) -> List[PrefixNode]:
        """Longest chain of cached full-page blocks covering a prefix of
        ``tokens``.  Charges one hit per matched node (the access profile)
        and one access on the physical page (the eviction clock).
        ``count=False`` walks the chain without charging anything — the
        re-attach path of live request migration, which is replica
        plumbing, not application access, and must not skew the guidance
        profile or the hit-rate telemetry."""
        if count:
            self.lookups += 1
        P = self.page_size
        chain: List[PrefixNode] = []
        level = self.roots
        for i in range(len(tokens) // P):
            node = level.get(tuple(int(t) for t in tokens[i * P:(i + 1) * P]))
            if node is None:
                break
            chain.append(node)
            level = node.children
        if not count:
            return chain
        for node in chain:
            node.hits += 1.0
            node.last_hit_step = step
            page = self.pool.pages[node.page_id]
            page.accesses += 1.0
            page.last_used = step
        if chain:
            self.hit_requests += 1
            self.hit_pages += len(chain)
        return chain

    # ------------------------------------------------------------ insert
    def insert(self, tokens: Sequence[int], pages: Sequence[Page],
               limit: int, step: int,
               chain: Sequence[PrefixNode] = ()) -> int:
        """Adopt a request's full-page prefix blocks into the tree.

        ``pages`` is the request's ordered page list (``chain`` pages first,
        then the private suffix pages); blocks beyond ``limit`` tokens —
        the caller's shareability horizon, e.g. the prompt length — stay
        private.  The cache takes one pool reference per adopted page, so
        cached blocks survive the inserting request.  Returns the number of
        pages adopted."""
        P = self.page_size
        n_full = min(limit, len(tokens)) // P
        if n_full < self.min_pages:
            return 0
        parent = chain[-1] if chain else None
        level = parent.children if parent is not None else self.roots
        added = 0
        for i in range(len(chain), n_full):
            block = tuple(int(t) for t in tokens[i * P:(i + 1) * P])
            node = level.get(block)
            if node is None:
                page = pages[i]
                assert page.tokens_used == P, \
                    "only FULL pages are shareable (partial pages mutate)"
                node = PrefixNode(
                    key=block_hash(parent.key if parent else b"", block),
                    tokens=block, page_id=page.page_id, depth=i,
                    parent=parent, birth_step=step, last_hit_step=step)
                level[block] = node
                self.by_page[page.page_id] = node
                self.pool.acquire(page.page_id, shared=True)
                added += 1
            parent, level = node, node.children
        self.inserted_pages += added
        return added

    # ----------------------------------------------------------- reclaim
    def evictable(self) -> List[PrefixNode]:
        """Leaves only the cache still references (refcount == 1): dropping
        one cannot orphan a descendant or a live request's prefix."""
        return [n for n in self.by_page.values()
                if not n.children
                and self.pool.pages[n.page_id].refcount == 1]

    def release(self, node: PrefixNode) -> None:
        """Drop one evictable leaf: detach from the tree and return the
        cache's pool reference (freeing the physical page)."""
        if node.children:
            raise ValueError(
                f"cannot release prefix node for page {node.page_id}: "
                f"it has {len(node.children)} cached children")
        siblings = (node.parent.children if node.parent is not None
                    else self.roots)
        siblings.pop(node.tokens)
        self.by_page.pop(node.page_id)
        self.pool.free(node.page_id)
        self.evicted_pages += 1

    def reclaim(self, n_pages: int) -> int:
        """Free up to ``n_pages`` logical pages by dropping the coldest
        evictable leaves (LRU by last hit, deepest first among equals —
        releasing a leaf can expose its parent for the next round).  Called
        by the engine under logical-page pressure, BEFORE preempting live
        requests."""
        freed = 0
        while freed < n_pages:
            cands = self.evictable()
            if not cands:
                break
            victim = min(cands, key=lambda n: (n.last_hit_step, -n.depth,
                                               n.page_id))
            self.release(victim)
            freed += 1
        return freed


class PrefixBackend:
    """``TierBackend`` making shared prefixes first-class tier objects.

    Arena = one root subtree of the radix tree (one distinct leading block —
    typically one system prompt); chunk = one cached page.  ``snapshot``'s
    access column is the per-interval hit count, ``reweight`` decays it, and
    ``enforce`` realizes the plan as ONE atomic batched ``exchange`` —
    demotions of cache-only pages fund promotions of planned-hot ones, and
    promotions past the free HBM slots are refused and reflected back into
    ``last_recs`` (same contract as ``PagedKVBackend``).  Pages a live
    request currently references never demote (they would swap straight
    back on the next scheduled step)."""

    name = "prefix"

    def __init__(self, cache: PrefixCache, clock: Callable[[], int]):
        self.cache = cache
        self.pool = cache.pool
        self.clock = clock
        self.last_recs: Dict[int, bool] = {}   # page_id -> recommended fast
        self._telemetry: Dict[int, List[ChunkStats]] = {}

    def _subtrees(self) -> Dict[PrefixNode, List[PrefixNode]]:
        out: Dict[PrefixNode, List[PrefixNode]] = {}
        for root in self.cache.roots.values():
            nodes, stack = [], [root]
            while stack:
                node = stack.pop()
                nodes.append(node)
                stack.extend(node.children.values())
            out[root] = nodes
        return out

    # ------------------------------------------------------------ protocol
    def snapshot(self) -> IntervalProfile:
        rows: List[ArenaProfile] = []
        telemetry: Dict[int, List[ChunkStats]] = {}
        page_bytes = self.pool.page_bytes
        step = self.clock()
        for root, nodes in self._subtrees().items():
            arena_id = root.page_id      # stable and unique per subtree
            fast = sum(1 for n in nodes
                       if self.pool.pages[n.page_id].hbm_slot is not None)
            rows.append(ArenaProfile(
                arena_id=arena_id, site_id=arena_id,
                label=f"prefix{root.page_id}",
                accesses=sum(n.hits for n in nodes),
                resident_bytes=len(nodes) * page_bytes,
                fast_fraction=fast / len(nodes)))
            telemetry[arena_id] = [
                ChunkStats(chunk_id=n.page_id, nbytes=page_bytes,
                           accesses=n.hits, age=step - n.birth_step,
                           fast=self.pool.pages[n.page_id].hbm_slot
                           is not None)
                for n in nodes]
        self._telemetry = telemetry
        return IntervalProfile(step, rows, 0, 0.0)

    def telemetry(self) -> Mapping[int, Sequence[ChunkStats]]:
        return self._telemetry

    def reweight(self, decay: float) -> None:
        for node in self.cache.by_page.values():
            node.hits *= decay
            self.pool.pages[node.page_id].accesses *= decay

    def on_plan(self, plan: MigrationPlan) -> None:
        self.last_recs = dict(plan.chunk_placement)

    def enforce(self, plan: MigrationPlan) -> MoveStats:
        stats = MoveStats()
        pages = self.pool.pages
        page_bytes = self.pool.page_bytes
        cached = self.cache.by_page
        demote = [pid for pid, fast in plan.chunk_placement.items()
                  if not fast and pid in cached
                  and pages[pid].hbm_slot is not None
                  and pages[pid].refcount == 1]
        want = [pid for pid, fast in plan.chunk_placement.items()
                if fast and pid in cached and pages[pid].hbm_slot is None]
        # Feasibility bounds mirror exchange(): demotions fund promotions
        # and vice versa; excess promotions are refused, not crashed.
        demote = demote[:len(want) + len(self.pool.free_host)]
        room = len(demote) + len(self.pool.free_hbm)
        promote, refused = want[:room], want[room:]
        self.pool.exchange(demote, promote)
        stats.bytes_demoted = page_bytes * len(demote)
        stats.bytes_promoted = page_bytes * len(promote)
        for pid in refused:
            stats.dropped_promotions += 1
            self.last_recs[pid] = False
        return stats

    def fast_bytes(self) -> int:
        return self.pool.page_bytes * sum(
            1 for pid in self.cache.by_page
            if self.pool.pages[pid].hbm_slot is not None)
