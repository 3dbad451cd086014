"""Deterministic synthetic token pipeline (LM training substrate).

Produces a seeded, *checkpointable* stream of token batches: the iterator
state is just ``(seed, step)``, so resuming a run after failure replays the
exact same data order.  The generator mimics natural-text statistics
(Zipfian unigrams + short-range repetition) so losses move like on real
data.  A copy of the JAX package's stream, numpy only: its batches are
byte-identical to that package's for any ``(seed, step)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStreamState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": int(self.seed), "step": int(self.step)}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class TokenStream:
    """Batch iterator: ``next_batch()`` -> int32 [batch, seq]."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 zipf_a: float = 1.3):
        self.vocab = int(vocab_size)
        self.batch = int(batch)
        self.seq = int(seq)
        self.state = TokenStreamState(seed=seed, step=0)
        # Zipfian unigram distribution over the vocab.
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._p = p / p.sum()

    def next_batch(self) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, self.state.step]))
        toks = rng.choice(self.vocab, size=(self.batch, self.seq),
                          p=self._p).astype(np.int32)
        # short-range repetition: copy spans backwards (learnable structure)
        n_spans = max(1, self.seq // 64)
        for b in range(self.batch):
            for _ in range(n_spans):
                ln = int(rng.integers(4, min(17, max(self.seq // 4, 5))))
                if self.seq < 2 * ln + 1:
                    continue
                src = int(rng.integers(0, self.seq - 2 * ln))
                dst = src + ln
                toks[b, dst:dst + ln] = toks[b, src:src + ln]
        self.state.step += 1
        return toks

    def checkpoint(self) -> dict:
        return self.state.to_dict()

    def restore(self, d: dict):
        self.state = TokenStreamState.from_dict(d)
