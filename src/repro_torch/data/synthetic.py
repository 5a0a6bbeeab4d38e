"""Synthetic datasets (numpy copies of ``repro.data.synthetic``).

SyntheticLM        : a seeded order-1 Markov language with Zipfian
                     unigrams: learnable bigram structure, deterministic
                     per (seed, index), so the port and the reference see
                     bit-identical token streams for the same seed.
SyntheticSentiment : the SST-2 stand-in of the paper's LLM experiments:
                     planted positive/negative marker tokens whose balance
                     sets a label, verbalised as the final token.
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


@dataclasses.dataclass
class SyntheticSentiment:
    """Binary 'sentiment': marker tokens 0..9 are negative cues, 10..19
    positive; the label token (vocab-2 = NEG, vocab-1 = POS) is the final
    token; loss is next-token CE, so accuracy = P(correct label token)."""
    vocab_size: int
    seq_len: int
    seed: int = 0
    n_classes: int = 2

    def sample(self, index: int, label: int | None = None):
        rng = np.random.default_rng((self.seed, index))
        if label is None:
            label = int(rng.integers(0, self.n_classes))
        body = rng.integers(20, self.vocab_size - 2, size=self.seq_len)
        # plant class markers with majority agreeing with the label
        n_mark = max(2, self.seq_len // 8)
        pos = rng.choice(self.seq_len - 1, size=n_mark, replace=False)
        agree = rng.random(n_mark) < 0.9
        cue = np.where(agree == (label == 1),
                       rng.integers(10, 20, n_mark),   # positive cues
                       rng.integers(0, 10, n_mark))    # negative cues
        body[pos] = cue
        body[-1] = self.vocab_size - 2 + label
        return body.astype(np.int32), label

    def batch(self, indices, labels=None) -> dict:
        rows, ys = [], []
        for j, i in enumerate(indices):
            r, y = self.sample(int(i),
                               None if labels is None else int(labels[j]))
            rows.append(r)
            ys.append(y)
        toks = np.stack(rows)
        labels_arr = np.full_like(toks, -100)      # only score the label slot
        labels_arr[:, :-1] = toks[:, 1:]
        return {"tokens": toks, "labels": labels_arr,
                "class": np.asarray(ys, np.int32)}

    def accuracy(self, logits_last, ys) -> float:
        """logits_last: (B, V) at the position predicting the label token
        (a numpy array, or a CPU tensor)."""
        logits_last = np.asarray(logits_last)
        pred = logits_last[:, self.vocab_size - 2:self.vocab_size].argmax(-1)
        return float((pred == np.asarray(ys)).mean())
