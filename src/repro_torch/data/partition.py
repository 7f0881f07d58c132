"""Non-IID partitioners (paper §IV-A).

A numpy copy of ``repro.data.partition``: the same ``default_rng(seed)``
draws in the same order, so it partitions bit for bit like the reference.

strong — each client gets a unique, non-overlapping label subset
         (10 clients × 10 classes ⇒ 1 exclusive class each);
weak   — each client gets `labels_per_client` labels drawn at random
         (overlapping allowed), samples of a label split evenly among its
         holders;
iid    — uniform random split.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class ClientData(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    labels: np.ndarray    # the label set this client holds


def _by_label(y: np.ndarray, num_classes: int):
    return [np.where(y == c)[0] for c in range(num_classes)]


def partition(x, y, *, num_clients: int, num_classes: int, scenario: str,
              labels_per_client: int = 3, seed: int = 0) -> List[ClientData]:
    x = np.asarray(x)
    y = np.asarray(y)
    if scenario == "weak":
        if not 1 <= labels_per_client <= num_classes:
            raise ValueError(
                f"labels_per_client={labels_per_client} must be in "
                f"[1, num_classes={num_classes}] for the weak non-IID "
                "partition (each client draws that many distinct labels)")
    rng = np.random.default_rng(seed)
    idx_by_label = _by_label(y, num_classes)
    out: List[ClientData] = []

    if scenario == "strong":
        # unique non-overlapping label subsets; with C == K, one class each
        perm = rng.permutation(num_classes)
        chunks = np.array_split(perm, num_clients)
        for c in range(num_clients):
            labels = np.sort(chunks[c])
            idx = np.concatenate([idx_by_label[lab] for lab in labels])
            rng.shuffle(idx)
            out.append(ClientData(x[idx], y[idx], labels))

    elif scenario == "weak":
        holders = [[] for _ in range(num_classes)]
        client_labels = []
        for c in range(num_clients):
            labels = rng.choice(num_classes, size=labels_per_client,
                                replace=False)
            client_labels.append(np.sort(labels))
            for lab in labels:
                holders[lab].append(c)
        # ensure every class has ≥1 holder so data isn't orphaned
        for lab in range(num_classes):
            if not holders[lab]:
                c = int(rng.integers(num_clients))
                holders[lab].append(c)
                client_labels[c] = np.sort(np.append(client_labels[c], lab))
        buckets = [[] for _ in range(num_clients)]
        for lab in range(num_classes):
            idx = idx_by_label[lab].copy()
            rng.shuffle(idx)
            for part, c in zip(np.array_split(idx, len(holders[lab])),
                               holders[lab]):
                buckets[c].append(part)
        for c in range(num_clients):
            idx = (np.concatenate(buckets[c]) if buckets[c]
                   else np.array([], np.int64))
            rng.shuffle(idx)
            out.append(ClientData(x[idx], y[idx], client_labels[c]))

    elif scenario == "iid":
        idx = rng.permutation(len(y))
        for part in np.array_split(idx, num_clients):
            out.append(ClientData(x[part], y[part], np.arange(num_classes)))
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    return out
