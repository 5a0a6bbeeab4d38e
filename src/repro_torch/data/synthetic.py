"""Synthetic LM data (a numpy copy of ``repro.data.synthetic.SyntheticLM``).

A seeded order-1 Markov language with Zipfian unigrams: learnable bigram
structure, deterministic per (seed, index), so the port and the reference
see bit-identical token streams for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    branching: int = 4          # successors per token -> learnable bigrams

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.successors = rng.integers(0, self.vocab_size,
                                       size=(self.vocab_size, self.branching))

    def sample(self, index: int) -> np.ndarray:
        """One (seq_len+1,) token stream, deterministic in (seed, index)."""
        rng = np.random.default_rng((self.seed, index))
        out = np.empty(self.seq_len + 1, np.int32)
        out[0] = rng.choice(self.vocab_size, p=self.unigram)
        picks = rng.integers(0, self.branching, size=self.seq_len)
        resets = rng.random(self.seq_len) < 0.05     # occasional re-draws
        fresh = rng.choice(self.vocab_size, size=self.seq_len, p=self.unigram)
        for t in range(self.seq_len):
            out[t + 1] = (fresh[t] if resets[t]
                          else self.successors[out[t], picks[t]])
        return out

    def batch(self, indices) -> dict:
        toks = np.stack([self.sample(int(i)) for i in indices])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
