"""Proxy dataset construction (Algorithm 1, Initialization lines 5–8).

A numpy copy of ``repro.data.proxy`` (same ``default_rng(seed)`` draws, so
the proxy set and the per-round index draws match the reference bit for
bit). Each client contributes a fraction alpha of its private data; the
server concatenates and redistributes. Provenance (owner id per proxy
sample) drives stage 1 of the two-stage client filter.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.data.partition import ClientData


class ProxyData(NamedTuple):
    x: np.ndarray        # (t, ...) proxy samples
    y: np.ndarray        # (t,) labels (held by server; used for eval only)
    owner: np.ndarray    # (t,) int32 contributing client


def build_proxy(clients: Sequence[ClientData], alpha: float,
                seed: int = 0) -> ProxyData:
    rng = np.random.default_rng(seed)
    xs, ys, owners = [], [], []
    for cid, c in enumerate(clients):
        n = len(c.y)
        take = max(1, int(round(alpha * n)))
        idx = rng.choice(n, size=take, replace=False)
        xs.append(np.asarray(c.x)[idx])
        ys.append(np.asarray(c.y)[idx])
        owners.append(np.full(take, cid, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    o = np.concatenate(owners)
    perm = rng.permutation(len(y))
    return ProxyData(x[perm], y[perm], o[perm])


def select_round_indices(rng: np.random.Generator, proxy: ProxyData,
                         batch: int) -> np.ndarray:
    """Server's per-round random index selection (Algorithm 1 line 13)."""
    return rng.choice(len(proxy.y), size=min(batch, len(proxy.y)),
                      replace=False)
