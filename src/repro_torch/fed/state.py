"""Externalized experiment state: everything a federated run needs to resume.

The counterpart of ``repro.fed.state``. A long-running federated service
must survive a restart: the scheduler's in-flight rounds, the server's
buffers and parked reports, every rng stream and the engine's parameters
and optimizer state. ``ExperimentState`` is the serializable container
for that state, assembled by ``RoundScheduler.snapshot()`` from per-layer
``state_dict()`` hooks (``Server``, ``StalenessBuffer``, ``SimTimeline``,
``FaultInjector``, both engines) and written through
``repro_torch.checkpoint.save_state``. Device tensors go out as numpy, and
each layer's ``load_state_dict`` puts them back on its owner's device, so
a checkpoint written on the card restores on the CPU and the other way
round.

Deterministically rebuildable structure — datasets, partitions, client
models, learned DREs (their fit reads only ``(seed, private data)``) — is
not captured: a resume rebuilds the experiment from the same
``FedConfig`` and overlays this state. The engine state is keyed per
client, in the reference's leaf names and layouts (``params/<i>/w`` …,
``opt_state/mu/…``, ``opt_state/step``), so a checkpoint of either engine,
waved or not, restores into the other, and a checkpoint of either package
overlays a client of the other.

The resume is bit for bit because every rng that advances during rounds is
captured exactly (numpy ``bit_generator.state``: PCG64's 128-bit words
serialize as JSON ints), the participation, churn, dropout and arrival
draws are stateless in ``(seed, round, client)``, and reports are
ingested in round order, so the server's parked reports plus its buffers
reproduce any in-flight aggregation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

STATE_VERSION = 1


def rng_state_dict(gen: np.random.Generator) -> Dict[str, Any]:
    """Serializable bit-generator state of a numpy ``Generator``: JSON-able
    as is (PCG64's 128-bit words are python ints, which ``save_state``
    round-trips at full width)."""
    return gen.bit_generator.state


def load_rng_state(gen: np.random.Generator, state: Dict[str, Any]) -> None:
    """Restore a ``Generator`` in place from ``rng_state_dict`` output."""
    gen.bit_generator.state = state


def opt_array(x, dtype=None) -> Optional[np.ndarray]:
    """``None``-preserving host copy of an array or tensor (a copy, so a
    restored layer never aliases the state tree it was loaded from)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True).numpy()
        return x if dtype is None else x.astype(dtype, copy=False)
    return np.array(x, dtype=dtype, copy=True)


def opt_tensor(x, device, dtype=None) -> Optional[torch.Tensor]:
    """``None``-preserving copy of an array as a tensor on ``device``."""
    if x is None:
        return None
    return torch.tensor(np.asarray(x, dtype=dtype), device=device)


def clients_state_dict(clients) -> Dict[str, Any]:
    """Per-client mutable state (``Learner.state_dict`` and the cid), in
    client-list order: the one engine checkpoint format, which both
    engines emit (the cohort engine syncs its stacked state back onto the
    ``Client`` objects first)."""
    return {"clients": [{"cid": int(c.cid), **c.state_dict()}
                        for c in clients]}


def check_clients_entries(clients, sd: Dict[str, Any]) -> List[Dict]:
    """``clients_state_dict`` output's entries, checked against the
    experiment's clients (count and order)."""
    entries = sd["clients"]
    if len(entries) != len(clients):
        raise ValueError(
            f"checkpoint holds {len(entries)} clients but the experiment "
            f"built {len(clients)} — the FedConfig does not match")
    for c, e in zip(clients, entries):
        if int(e["cid"]) != int(c.cid):
            raise ValueError(
                f"client order mismatch: checkpoint cid {e['cid']} at "
                f"position of client {c.cid}")
    return entries


def load_clients_state_dict(clients, sd: Dict[str, Any]) -> None:
    """Restore ``clients_state_dict`` output onto ``Client`` objects, each
    leaf on its client's device."""
    for c, e in zip(clients, check_clients_entries(clients, sd)):
        c.load_state_dict(e, source=f"client {c.cid}")


@dataclasses.dataclass
class ExperimentState:
    """One resumable snapshot of a federated run, at a phase boundary.

    ``scheduler`` holds the node bookkeeping (done nodes, execution trace,
    per-node simulated finish times, the round window) plus one payload
    dict per in-flight round; ``server``, ``timeline`` and ``engine`` are
    the per-layer ``state_dict()`` outputs; ``logs`` carries the retired
    rounds' ``RoundLog``s (or a tail of them)."""
    version: int
    round_mode: str
    scheduler: Dict[str, Any]
    timeline: Dict[str, Any]
    server: Dict[str, Any]
    engine: Dict[str, Any]
    logs: List[Dict[str, Any]]

    def to_tree(self) -> Dict[str, Any]:
        """Plain nested-dict form for ``save_state`` (a deep copy)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "ExperimentState":
        got = int(tree.get("version", -1))
        if got != STATE_VERSION:
            raise ValueError(
                f"experiment-state version {got} is not the supported "
                f"{STATE_VERSION} — this checkpoint was written by an "
                "incompatible build")
        return cls(**{f.name: tree[f.name]
                      for f in dataclasses.fields(cls)})
