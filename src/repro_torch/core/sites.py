"""Allocation sites.

In the paper a *site* is an allocation instruction plus up to three levels of
call-path context, annotated by a compiler pass.  In this framework the
analogue is the *module-tree path* of a tensor group: every parameter,
optimizer-state leaf, KV page pool, or activation group is registered under a
path like ``("layers", "block", "attn", "wq")``.  Paths are truncated to a
configurable context depth (default 3, matching the paper's clone depth) so
that, exactly as in the paper, distinct deep contexts can intentionally share
a site.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, Iterator, Optional, Tuple


class SiteKind(enum.Enum):
    PARAM = "param"
    OPT_STATE = "opt_state"
    KV_CACHE = "kv_cache"
    ACTIVATION = "activation"
    BUFFER = "buffer"
    OTHER = "other"


@dataclasses.dataclass(frozen=True)
class Site:
    """An allocation context.  Immutable; identity is the (truncated) path."""

    site_id: int
    path: Tuple[str, ...]
    kind: SiteKind = SiteKind.OTHER

    @property
    def label(self) -> str:
        return "/".join(self.path)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"Site({self.site_id}, {self.label}, {self.kind.value})"


class SiteRegistry:
    """Interns sites by truncated path, like the paper's annotation pass.

    ``context_depth`` mirrors the paper's "up to three layers of call path
    context": only the last ``context_depth`` path components participate in
    site identity.  Deeper paths therefore coalesce, keeping the number of
    sites bounded the way the paper's cloning bound does.
    """

    def __init__(self, context_depth: int = 3):
        if context_depth < 1:
            raise ValueError("context_depth must be >= 1")
        self.context_depth = context_depth
        self._by_key: Dict[Tuple[Tuple[str, ...], SiteKind], Site] = {}
        self._by_id: Dict[int, Site] = {}

    def _truncate(self, path: Iterable[str]) -> Tuple[str, ...]:
        tup = tuple(str(p) for p in path)
        if not tup:
            raise ValueError("site path must be non-empty")
        return tup[-self.context_depth:]

    def register(self, path: Iterable[str], kind: SiteKind = SiteKind.OTHER) -> Site:
        key = (self._truncate(path), kind)
        site = self._by_key.get(key)
        if site is None:
            site = Site(site_id=len(self._by_id), path=key[0], kind=kind)
            self._by_key[key] = site
            self._by_id[site.site_id] = site
        return site

    def get(self, site_id: int) -> Site:
        return self._by_id[site_id]

    def find(self, path: Iterable[str], kind: SiteKind = SiteKind.OTHER) -> Optional[Site]:
        return self._by_key.get((self._truncate(path), kind))

    def __len__(self) -> int:
        return len(self._by_id)

    def __iter__(self) -> Iterator[Site]:
        return iter(self._by_id.values())
