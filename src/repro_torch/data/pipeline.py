"""Deterministic synthetic data pipeline (``repro/data/pipeline.py``
``SyntheticLM``, copied).

Reproducible token batches: documents of geometric length packed into
fixed-length rows, next-token labels.  Numpy only, from a seeded PRNG
stream, so the batches are the JAX package's bit for bit; the trainer
moves them to its device.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


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
