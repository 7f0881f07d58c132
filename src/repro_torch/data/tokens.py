"""Synthetic token / frame / patch streams for the large-architecture drivers.

A numpy copy of ``repro.data.tokens``: the same ``default_rng(seed)`` draws
in the same order, so every batch is the reference's bit for bit. A Zipfian
token sampler with Markov structure gives the LM driver a learnable signal
(bigram statistics), so ``launch.train``'s loss visibly decreases; uniform
tokens would bottom out at log(V).
"""
from __future__ import annotations

import numpy as np


class MarkovTokenStream:
    """Order-1 Markov chain over a Zipf vocabulary."""

    def __init__(self, vocab_size: int, branching: int = 32, seed: int = 0):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        # each token transitions to one of `branching` successors
        self.succ = self.rng.integers(0, vocab_size,
                                      size=(vocab_size, branching))
        ranks = np.arange(1, branching + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def batch(self, batch_size: int, seq_len: int):
        """Returns {tokens (B,S), labels (B,S)} — labels are next tokens."""
        out = np.empty((batch_size, seq_len + 1), np.int32)
        out[:, 0] = self.rng.integers(0, self.vocab, size=batch_size)
        for t in range(seq_len):
            choice = self.rng.choice(self.succ.shape[1], size=batch_size,
                                     p=self.p)
            out[:, t + 1] = self.succ[out[:, t], choice]
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def synth_frames(rng, batch: int, seq: int, dim: int):
    """Audio frontend stub output: smooth frame embeddings."""
    base = rng.standard_normal((batch, seq // 4 + 2, dim)).astype(np.float32)
    idx = np.linspace(0, base.shape[1] - 1.001, seq)
    lo = idx.astype(int)
    frac = (idx - lo)[None, :, None].astype(np.float32)
    return base[:, lo] * (1 - frac) + base[:, lo + 1] * frac


def synth_vision(rng, batch: int, num_tokens: int, dim: int):
    """Vision frontend stub output: patch embeddings."""
    return rng.standard_normal((batch, num_tokens, dim)).astype(np.float32)
