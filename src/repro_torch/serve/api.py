"""The front-door generation API: ``LLM.generate`` / ``LLM.submit`` — the
port of ``repro/serve/api.py``.

Callers say *what* to generate (prompts + ``SamplingParams``); continuous
batching, the paged two-tier KV cache, preemption by recompute and
Algorithm-1 page placement happen behind it.

* ``generate(prompts, params)`` — batch-blocking: submit everything, step
  the engine until every request finishes, return ``RequestOutput`` rows in
  prompt order.
* ``submit(prompt, params) -> RequestHandle`` — streaming: the handle is an
  iterable of ``(token, finish_reason)`` deltas produced as the engine
  steps; ``finish_reason`` is ``None`` until the final delta.

This slice drives one ``Engine`` directly; the multi-replica ``Router``
comes with the cluster slice (ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import (Deque, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from .._device import DeviceLike
from ..core import HardwareModel
from ..models.transformer import Model
from .engine import Engine, ServeConfig
from .sampling import DEFAULT_MAX_TOKENS, SamplingParams

Prompt = Sequence[int]
Delta = Tuple[Optional[int], Optional[str]]

__all__ = ["DEFAULT_MAX_TOKENS", "LLM", "RequestHandle", "RequestOutput"]


@dataclasses.dataclass
class RequestOutput:
    """One finished request, as the front door reports it."""

    request_id: int
    prompt_token_ids: List[int]
    token_ids: List[int]
    finish_reason: str            # stop | length | truncated | cancelled
    params: SamplingParams


class RequestHandle:
    """Streaming view of one submitted request.

    Iterate to receive ``(token, finish_reason)`` deltas: every generated
    token arrives as ``(token, None)`` except the last, which carries the
    finish reason; a request finished without a token this step emits a
    final tokenless ``(None, reason)`` delta.  Iteration drives the shared
    engine, so other in-flight handles advance too.  ``result()`` drains to
    completion and returns the ``RequestOutput``.
    """

    def __init__(self, llm: "LLM", request_id: int, prompt: Prompt,
                 params: SamplingParams):
        self._llm = llm
        self.request_id = request_id
        self.prompt_token_ids = [int(t) for t in prompt]
        self.params = params
        self.token_ids: List[int] = []
        self.finish_reason: Optional[str] = None
        self._deltas: Deque[Delta] = deque()
        self._queued = 0        # prefix of req.generated queued as deltas

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None

    def __iter__(self) -> Iterator[Delta]:
        while True:
            delta = self.next_delta()
            if delta is None:
                return
            yield delta

    def next_delta(self) -> Optional[Delta]:
        """Block (stepping the engine) until this request's next delta, or
        ``None`` when the stream is exhausted."""
        while not self._deltas:
            if self.finished:
                return None
            self._llm._absorb_finished()
            if self._deltas or self.finished:
                continue
            req = self._llm.engine.requests.get(self.request_id)
            if req is None:
                raise RuntimeError(
                    f"request {self.request_id} left the engine without "
                    f"its result reaching this handle (was "
                    f"engine.pop_finished called directly?)")
            if req.state in ("paused", "preempted"):
                # Single-threaded driver: stepping can never advance a
                # request the caller parked, so spinning would hang.
                raise RuntimeError(
                    f"request {self.request_id} is {req.state}; resume() "
                    f"it before consuming its stream")
            self._llm.step()
        return self._deltas.popleft()

    def result(self) -> RequestOutput:
        for _ in self:
            pass
        return RequestOutput(
            request_id=self.request_id,
            prompt_token_ids=list(self.prompt_token_ids),
            token_ids=list(self.token_ids),
            finish_reason=self.finish_reason,
            params=self.params)


class LLM:
    """Generation front end over one serving engine.

    Construct from a model whose parameters are loaded (``LLM(model)``) or
    from the architecture registry (``LLM.from_arch("llama3_2_1b")``).  The
    model's device is where everything runs: the card unless the caller
    built the model with ``device="cpu"``.  Tiering and scheduling knobs
    stay on ``ServeConfig``, per-request behaviour on ``SamplingParams``.
    """

    def __init__(self, model: Model, cfg: Optional[ServeConfig] = None,
                 hw: Optional[HardwareModel] = None, replicas: int = 1):
        if replicas != 1:
            raise NotImplementedError(
                f"replicas={replicas}: multi-replica serving behind a Router "
                f"is not ported yet (ROADMAP.md queue A item 8)")
        self.engine = Engine(model, cfg or ServeConfig(), hw)
        self._handles: Dict[int, RequestHandle] = {}
        self._next_id = 0

    @classmethod
    def from_arch(cls, arch: str, smoke: bool = True,
                  cfg: Optional[ServeConfig] = None, seed: int = 0,
                  replicas: int = 1, device: DeviceLike = None) -> "LLM":
        """Build ``arch`` (the published config, or its SMOKE reduction)
        with random weights drawn from ``seed`` on ``device``."""
        from ..configs import get, get_smoke

        model = Model(get_smoke(arch) if smoke else get(arch), device=device)
        gen = torch.Generator(device=model.device).manual_seed(seed)
        return cls(model.init(gen), cfg, replicas=replicas)

    # ------------------------------------------------------------ submit
    def submit(self, prompt: Prompt,
               params: Optional[SamplingParams] = None,
               request_id: Optional[int] = None) -> RequestHandle:
        """Enqueue one request and return its streaming handle."""
        params = params if params is not None else SamplingParams()
        rid = request_id if request_id is not None else self._next_id
        self._next_id = max(self._next_id, rid + 1)
        self.engine.add_request(rid, [int(t) for t in prompt], params=params)
        handle = RequestHandle(self, rid, prompt, params)
        self._handles[rid] = handle
        return handle

    def generate(self,
                 prompts: Union[Prompt, Sequence[Prompt]],
                 params: Union[None, SamplingParams,
                               Sequence[SamplingParams]] = None,
                 ) -> List[RequestOutput]:
        """Batch-blocking generation: one output row per prompt, in order.
        ``prompts`` is a list of token-id lists (a single flat token list
        is one prompt); ``params`` is shared or per-prompt."""
        if prompts and isinstance(prompts[0], (int, np.integer)):
            prompts = [prompts]
        if params is None or isinstance(params, SamplingParams):
            plist: List[Optional[SamplingParams]] = [params] * len(prompts)
        else:
            if len(params) != len(prompts):
                raise ValueError(
                    f"{len(params)} SamplingParams for {len(prompts)} "
                    f"prompts")
            plist = list(params)
        handles = [self.submit(p, sp) for p, sp in zip(prompts, plist)]
        while any(not h.finished for h in handles):
            self.step()
        return [h.result() for h in handles]

    # ----------------------------------------------------------- driving
    def step(self) -> Dict[int, int]:
        """Advance the engine one step and route deltas to their handles."""
        out = self.engine.step()
        for rid in out:
            h = self._handles.get(rid)
            req = (self.engine.requests.get(rid)
                   or self.engine.finished.get(rid))
            if h is not None and req is not None:
                self._route(h, req.generated)
        self._absorb_finished()
        return out

    @staticmethod
    def _route(h: RequestHandle, generated: Sequence[int]) -> None:
        """Queue every not-yet-queued token of the request's stream as a
        ``(token, None)`` delta, reconciling against ``req.generated``."""
        for tok in generated[h._queued:]:
            h.token_ids.append(int(tok))
            h._deltas.append((int(tok), None))
        h._queued = len(generated)

    def _absorb_finished(self) -> None:
        """Move engine finishes onto their handles: the final undelivered
        token delta gains the ``finish_reason``; a request that finished
        without a token this step gets a tokenless ``(None, reason)``."""
        for rid in list(self.engine.finished):
            h = self._handles.pop(rid, None)
            if h is None or h.finished:
                continue                 # engine driven directly / drained
            req = self.engine.pop_finished(rid)
            h.finish_reason = req.finish_reason
            self._route(h, req.generated)
            if h._deltas and h._deltas[-1][1] is None:
                tok, _ = h._deltas.pop()
                h._deltas.append((tok, req.finish_reason))
            else:
                h._deltas.append((None, req.finish_reason))

    # -------------------------------------------------- session controls
    def pause(self, request_id: int) -> None:
        self.engine.pause(request_id)

    def resume(self, request_id: int) -> None:
        self.engine.resume(request_id)

    def cancel(self, request_id: int) -> None:
        """Withdraw a live request; its handle ends with a ``cancelled``
        delta."""
        self.engine.cancel(request_id)
        self._absorb_finished()

    def is_live(self, request_id: int) -> bool:
        return request_id in self.engine.requests

    def stats(self) -> Dict[str, float]:
        return self.engine.stats()
