"""Synthetic LM data pipeline with exactly-resumable state (a copy of
``repro/data/pipeline.py``, which is numpy only: the same ``Philox``
counter stream gives the same batches bit for bit).

Production properties the trainer relies on:
* **Determinism** — batch ``i`` of shard ``s`` is a pure function of
  (seed, s, i): restart-safe, and every DP replica can derive its own
  shard without coordination.
* **Resumability** — a :class:`DataCursor` (step, shard) is stored inside
  every checkpoint; ``seek`` is O(1) (counter-based PRNG, no state replay).
* **Shardability** — ``n_shards`` mirrors the DP group count; elastic
  restarts with a different DP degree re-shard by reassigning shard ids.

Tokens follow a Zipfian marginal with a Markov twist so the loss signal is
learnable (cross-entropy drops measurably within a few hundred steps on
the ~100M example run — examples/torch_train_lm.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

__all__ = ["DataCursor", "TokenPipeline"]


@dataclasses.dataclass
class DataCursor:
    step: int = 0
    shard: int = 0

    def as_dict(self):
        return {"step": self.step, "shard": self.shard}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]), shard=int(d["shard"]))


class TokenPipeline:
    def __init__(self, vocab: int, seq_len: int, batch: int, *,
                 seed: int = 0, n_shards: int = 1, shard: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.n_shards = n_shards
        self.cursor = DataCursor(step=0, shard=shard)
        # Zipf-ish unigram + shift-mix transition (learnable structure)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._p = (1.0 / ranks ** 1.1)
        self._p /= self._p.sum()

    def seek(self, cursor: DataCursor) -> None:
        self.cursor = DataCursor(cursor.step, cursor.shard)

    def _rng_for(self, step: int) -> np.random.Generator:
        # counter-based: (seed, shard, step) -> independent stream
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=[self.cursor.shard, step, 0, 0])
        )

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (inputs, labels) int32 [batch, seq_len]."""
        rng = self._rng_for(self.cursor.step)
        toks = rng.choice(self.vocab, size=(self.batch, self.seq_len + 1), p=self._p)
        # Markov structure: token depends on predecessor half the time
        mix = rng.random((self.batch, self.seq_len)) < 0.5
        shifted = (toks[:, :-1] * 31 + 7) % self.vocab
        toks[:, 1:][mix] = shifted[mix]
        toks = toks.astype(np.int32)
        self.cursor.step += 1
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()
