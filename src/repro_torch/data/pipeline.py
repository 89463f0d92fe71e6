"""Deterministic synthetic data pipeline (``repro/data/pipeline.py``).

``SyntheticLM`` (copied): reproducible token batches, documents of
geometric length packed into fixed-length rows, next-token labels.  Numpy
only, from a seeded PRNG stream, so the batches are the JAX package's bit
for bit.

``ShardedLoader`` places each rank's data block of every global batch
(``dist.sharding.batch_pspec``) on its device from a background thread
that keeps up to ``prefetch`` batches ready; on the card a block goes
through pinned host memory and an asynchronous copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..dist.sharding import (batch_pspec, mesh_coordinate, mesh_sizes,
                             spec_block)


class SyntheticLM:
    """Packed-document LM stream: tokens[i+1] is the label of tokens[i]."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, doc_mean: int = 512, pad_id: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.doc_mean = doc_mean
        self.pad_id = pad_id

    def _make_row(self, rng: np.random.Generator) -> np.ndarray:
        row = np.empty(self.seq_len + 1, np.int32)
        filled = 0
        while filled <= self.seq_len:
            n = min(1 + rng.geometric(1.0 / self.doc_mean),
                    self.seq_len + 1 - filled)
            # Markov-ish tokens: correlated stream so the model can learn.
            start = rng.integers(1, self.vocab)
            toks = (start + np.cumsum(
                rng.integers(0, 17, n))) % (self.vocab - 1) + 1
            row[filled:filled + n] = toks
            filled += n
        return row

    def batch_np(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        rows = np.stack([self._make_row(rng)
                         for _ in range(self.global_batch)])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def iter_host(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_np(step)
            step += 1


class ShardedLoader:
    """This rank's blocks of ``source``'s global batches, in step order, on
    ``device`` (the card unless the caller asks for the CPU).  Under a
    ``DeviceMesh`` a rank holds the rows of dim 0 that ``batch_pspec(mesh)``
    gives its coordinate, so the ranks' blocks concatenated in data order
    are ``source.batch_np(step)`` bit for bit; without a mesh it holds the
    whole batch.  A background thread fills a queue of at most
    ``prefetch`` batches; ``close`` stops and joins it."""

    def __init__(self, source: SyntheticLM, mesh=None, prefetch: int = 2,
                 device: DeviceLike = None):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.source = source
        self.mesh = mesh
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def block(self, arr: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch array."""
        if self.mesh is None:
            return arr
        sl = spec_block(batch_pspec(self.mesh), arr.shape,
                        mesh_sizes(self.mesh), mesh_coordinate(self.mesh))
        return arr[sl[0]]

    def _place(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(self.block(arr)))
        if self.device.type != "cuda":
            return host.to(self.device)
        out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        return out.copy_(host.pin_memory(), non_blocking=True)

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``close`` comes first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for batch in self.source.iter_host():
                if self._stop.is_set():
                    return
                placed = {k: self._place(v) for k, v in batch.items()}
                if not self._put(placed):
                    return
        # check: disable=EXC01 -- not swallowed: the consumer's next
        # ``__next__`` re-raises it.
        except BaseException as e:
            self._put(e)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()
        while True:
            item = self._q.get()
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and join it, also when it waits on a full
        queue."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("ShardedLoader's worker did not stop")
            self._thread = None
