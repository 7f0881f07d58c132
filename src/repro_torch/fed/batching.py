"""Deterministic-shape minibatching shared by every training loop.

A copy of ``repro.fed.batching.epoch_batches``/``steps_per_epoch``:

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
