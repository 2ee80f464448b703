"""Synthetic LM token streams for the train driver and smoke tests — a
numpy copy of the JAX package's ``repro.data.tokens``: the same seed gives
the same tokens, bit for bit.

A mixture of a Zipfian unigram process and a deterministic-motif process so
a model has learnable structure without any external corpus.
"""
from __future__ import annotations

import numpy as np


class ZipfMotifStream:
    """Token stream: with prob ``motif_prob`` emit the continuation of a
    length-``motif_len`` motif keyed by the previous token; else sample from
    a Zipf(alpha) unigram distribution."""

    def __init__(self, vocab_size: int, seed: int = 0, alpha: float = 1.2,
                 motif_prob: float = 0.5, motif_len: int = 8):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-alpha)
        self.p = p / p.sum()
        # rng.choice(vocab, size, p=p) draws rng.random(size) and searches
        # the normalised cumulative sum of p; it sums the vocab again at
        # every call (the whole cost of a long sequence, one call per
        # position), so the sum is taken once here and the draw is made
        # the same way: the same tokens, bit for bit
        cdf = self.p.cumsum()
        self.cdf = cdf / cdf[-1]
        self.motif_prob = motif_prob
        self.motif_len = motif_len
        # deterministic successor table: motifs are fixed chains
        self.successor = self.rng.permutation(vocab_size)

    def _zipf(self, batch: int) -> np.ndarray:
        """``rng.choice(vocab, size=batch, p=self.p)``, from the CDF."""
        return self.cdf.searchsorted(self.rng.random(batch), side="right")

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), dtype=np.int32)
        out[:, 0] = self._zipf(batch)
        in_motif = np.zeros(batch, dtype=np.int32)
        for t in range(1, seq_len + 1):
            start = (in_motif == 0) & (self.rng.random(batch) < self.motif_prob)
            in_motif = np.where(start, self.motif_len,
                                np.maximum(in_motif - 1, 0))
            zipf = self._zipf(batch)
            chain = self.successor[out[:, t - 1]]
            out[:, t] = np.where(in_motif > 0, chain, zipf)
        return out

    def batch(self, batch: int, seq_len: int) -> dict:
        toks = self.sample(batch, seq_len)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
