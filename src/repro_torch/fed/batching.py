"""Deterministic-shape minibatching shared by every training loop.

A copy of ``repro.fed.batching``: ``epoch_batches``/``steps_per_epoch``
(the loop engine's batches) and ``padded_epoch_plan`` (the same batches
packed into fixed arrays for the cohort engine):

  * ``n >= batch_size``  — full batches only, drop the ragged tail
    (``n // batch_size`` steps of exactly ``batch_size``);
  * ``0 < n < batch_size`` — a single short batch of all ``n`` samples.
"""
from __future__ import annotations

from typing import List

import numpy as np


def epoch_batches(perm: np.ndarray, batch_size: int) -> List[np.ndarray]:
    """Split a permutation of sample indices into deterministic-shape
    batches."""
    n = len(perm)
    if n == 0:
        return []
    if n < batch_size:
        return [perm]
    nb = n // batch_size
    return list(perm[: nb * batch_size].reshape(nb, batch_size))


def steps_per_epoch(n: int, batch_size: int) -> int:
    """Number of steps ``epoch_batches`` yields for ``n`` samples."""
    if n == 0:
        return 0
    return 1 if n < batch_size else n // batch_size


def padded_epoch_plan(perms, batch_size: int, num_steps: int):
    """Stack one client's epochs of batches into fixed arrays for the
    cohort engine.

    ``perms``: one index permutation per epoch. Returns ``(idx, w,
    valid)``: ``idx`` (num_steps, batch_size) int32, ``w`` a per-sample
    weight (0 for pad slots) and ``valid`` marking real steps. ``num_steps``
    must be ≥ the client's step count over the epochs; the surplus steps
    are no-ops (valid=False)."""
    idx = np.zeros((num_steps, batch_size), np.int32)
    w = np.zeros((num_steps, batch_size), np.float32)
    valid = np.zeros((num_steps,), bool)
    s = 0
    for perm in perms:
        for b in epoch_batches(np.asarray(perm), batch_size):
            idx[s, : len(b)] = b
            w[s, : len(b)] = 1.0
            valid[s] = True
            s += 1
    return idx, w, valid
