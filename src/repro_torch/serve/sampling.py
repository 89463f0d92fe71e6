"""Per-request sampling parameters for the generation API.

``SamplingParams`` is the user-facing half of the sampling-determinism
contract (DESIGN.md §10): everything that influences the sampled stream is
carried here per request, and the engine threads it into the decode
dispatch as batched tensors — sampling itself runs on the device
(``kernels.ops.sample_tokens``), never as host-side post-processing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Generation budget when neither ``SamplingParams.max_tokens`` nor the
# engine caller's ``max_new`` says otherwise — owned here, resolved in ONE
# place (``Engine.add_request``).
DEFAULT_MAX_TOKENS = 16


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request decodes.

    temperature: 0.0 (the default) is greedy argmax, bitwise-equal to the
      pre-sampling engine; > 0 samples via seeded Gumbel-max.
    top_k: keep only the k most probable tokens (0 disables).
    top_p: nucleus filter — keep the smallest probability-sorted prefix
      covering ``top_p`` mass (1.0 disables; the argmax token always
      survives).
    seed: per-request PRNG seed; the per-token key is
      ``fold_in(PRNGKey(seed), position)``, so replay-by-recompute and
      one-shot-vs-chunked prefill resample identically.  ``None`` (the
      default) derives the seed from the request id — identical prompts
      submitted as different requests sample independent streams, while
      each request's own stream stays exactly replayable.
    stop_token_ids: finish with ``finish_reason="stop"`` when a sampled
      token is in this set (an EOS id is just a stop token).  The stop
      token is included in the generated stream.
    max_tokens: generation budget; ``None`` defers to the engine caller's
      ``max_new``.  Exhausting it finishes with ``finish_reason="length"``.

    The last three fields are SCHEDULING metadata, not sampling knobs:
    they never enter the decode dispatch (streams are bitwise-identical
    whatever they say — scheduling moves WHEN tokens appear, never WHICH),
    but they ride inside ``RequestTicket``s so a migrated request keeps
    its class, tenant, and deadline on the destination replica.

    priority: strict scheduling class for the ``priority`` policy (higher
      = served sooner); other policies ignore it.
    tenant: fairness bucket for the ``drr`` policy (deficit-round-robin
      shares service across tenants, not requests).
    deadline_steps: optional SLO deadline, in engine steps from enqueue;
      the ``priority`` policy orders earliest-deadline-first within a
      class, and the workload replayer scores goodput against it.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    max_tokens: Optional[int] = None
    priority: int = 0
    tenant: str = "default"
    deadline_steps: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.deadline_steps is not None and self.deadline_steps < 1:
            raise ValueError(
                f"deadline_steps must be None or >= 1, got "
                f"{self.deadline_steps}")
        if self.seed is not None and not (0 <= self.seed < 2**31):
            # The seed rides into the decode dispatch as an int32 row; a
            # silently-wrapped 64-bit seed would collide streams that the
            # caller believes are distinct.
            raise ValueError(
                f"seed must be None or in [0, 2**31), got {self.seed}")
        # Normalize so engine membership checks and dataclass equality are
        # stable however the caller spelled the set.
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0
