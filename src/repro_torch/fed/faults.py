"""Deterministic payload-fault traces for Byzantine and corrupted clients.

The counterpart of ``repro.fed.faults``. Every draw is a pure function of
``(seed, round, client)`` on the lanes of ``fed.clock``, so the loop and
cohort engines inject identical corruption, and the traces equal the
reference's bit for bit. Faults act on the report payloads after local
training (the scheduler's report ingest): a faulty client trains honestly
and lies on the wire.

Two schedules compose into a round's fault mask: ``byzantine_frac``, a
fixed adversarial subset (the ``round(frac * C)`` clients with the
smallest ``(seed, client)`` lane uniforms), and ``fault_prob``, an
independent per-round coin a client. ``fault_start``/``fault_duration``
window the attack in round time (``duration=0``: unbounded).

Modes (``FAULT_MODES``): ``nan`` (claimed-ID rows become NaN),
``random_logits`` (Gaussian noise drawn with numpy on the host from
``(seed, round, client)``), ``scaled`` (× ``SCALE_FACTOR``),
``colluding_flip`` (× ``-SCALE_FACTOR``) and ``stale_replay`` (a faulty
client replays its report of its previous faulty round; the first passes
through while the cache warms). ``FaultInjector`` corrupts the port's
``(C, t, K)`` device tensors on the device, on a clone; its replay cache
holds cloned device tensors and ``state_dict`` hands it out as numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fed.clock import _lane_uniform

FAULT_MODES = ("none", "nan", "random_logits", "scaled", "colluding_flip",
               "stale_replay")

# magnitude of the scaled and colluding_flip attacks
SCALE_FACTOR = 50.0
# standard deviation of the random_logits attack
RANDOM_STD = 10.0

_TAG_BYZ = 0xBAD0    # fixed adversarial subset lane
_TAG_FLAKY = 0xFA17  # transient per-round corruption lane


def validate_fault_config(mode: str, fault_prob: float, byzantine_frac: float,
                          fault_start: int, fault_duration: int) -> None:
    if mode not in FAULT_MODES:
        raise ValueError(
            f"fault_mode must be one of {FAULT_MODES}, got {mode!r}")
    if not 0.0 <= fault_prob < 1.0:
        raise ValueError(f"fault_prob must be in [0, 1), got {fault_prob!r}")
    if not 0.0 <= byzantine_frac <= 1.0:
        raise ValueError(
            f"byzantine_frac must be in [0, 1], got {byzantine_frac!r}")
    if fault_start < 0:
        raise ValueError(f"fault_start must be >= 0, got {fault_start!r}")
    if fault_duration < 0:
        raise ValueError(
            f"fault_duration must be >= 0 (0 = unbounded), "
            f"got {fault_duration!r}")


def byzantine_ids(num_clients: int, *, seed: int = 0,
                  byzantine_frac: float = 0.0) -> np.ndarray:
    """``(C,)`` bool: the fixed adversarial subset, the ``round(frac * C)``
    clients with the smallest ``(seed, client)`` lane uniforms."""
    k = int(round(byzantine_frac * num_clients))
    mask = np.zeros((num_clients,), bool)
    if k <= 0 or num_clients == 0:
        return mask
    u = _lane_uniform(seed, num_clients, _TAG_BYZ)
    mask[np.argsort(u, kind="stable")[:k]] = True
    return mask


def fault_mask(num_clients: int, round_idx: int, *, seed: int = 0,
               mode: str = "none", fault_prob: float = 0.0,
               byzantine_frac: float = 0.0, fault_start: int = 0,
               fault_duration: int = 0) -> Optional[np.ndarray]:
    """``(C,)`` bool: which clients corrupt their report this round; None
    for nobody (mode off, empty schedule, or a round outside the window).
    The union of the Byzantine subset and the round's per-client coins."""
    validate_fault_config(mode, fault_prob, byzantine_frac, fault_start,
                          fault_duration)
    if mode == "none" or (fault_prob == 0.0 and byzantine_frac == 0.0):
        return None
    if round_idx < fault_start:
        return None
    if fault_duration > 0 and round_idx >= fault_start + fault_duration:
        return None
    mask = byzantine_ids(num_clients, seed=seed,
                         byzantine_frac=byzantine_frac)
    if fault_prob > 0.0:
        mask = mask | (_lane_uniform(num_clients=num_clients, seed=seed,
                                     tag=_TAG_FLAKY,
                                     round_idx=round_idx) < fault_prob)
    return mask if mask.any() else None


def _client_rng(seed: int, round_idx: int, cid: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [seed % 2**32, round_idx % 2**32, int(cid), _TAG_FLAKY]))


class FaultInjector:
    """Applies a fault trace to report payloads, whatever the engine.

    The scheduler builds one only when ``fault_mode != "none"``. Its one
    piece of mutable state is the ``stale_replay`` cache (a faulty
    client's last report), kept as device tensors on ``device``."""

    def __init__(self, num_clients: int, *, mode: str, seed: int = 0,
                 fault_prob: float = 0.0, byzantine_frac: float = 0.0,
                 fault_start: int = 0, fault_duration: int = 0,
                 device="cpu"):
        validate_fault_config(mode, fault_prob, byzantine_frac, fault_start,
                              fault_duration)
        self.num_clients = num_clients
        self.mode = mode
        self.seed = seed
        self.fault_prob = fault_prob
        self.byzantine_frac = byzantine_frac
        self.fault_start = fault_start
        self.fault_duration = fault_duration
        self.device = torch.device(device)
        # stale_replay cache: cid -> (logits (t, K), mask (t,)), or on the
        # class-wise path cid -> (means (K_cls, K), counts (K_cls,))
        self._replay: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def mask(self, round_idx: int) -> Optional[np.ndarray]:
        return fault_mask(self.num_clients, round_idx, seed=self.seed,
                          mode=self.mode, fault_prob=self.fault_prob,
                          byzantine_frac=self.byzantine_frac,
                          fault_start=self.fault_start,
                          fault_duration=self.fault_duration)

    def _faulty_ids(self, round_idx: int,
                    part: Optional[np.ndarray]) -> List[int]:
        m = self.mask(round_idx)
        if m is None:
            return []
        if part is not None:
            m = m & np.asarray(part, bool)
        return [int(c) for c in np.nonzero(m)[0]]

    def _noise(self, round_idx: int, cid: int, shape, device) -> torch.Tensor:
        """The random_logits payload, drawn on the host as the reference
        draws it."""
        noise = RANDOM_STD * _client_rng(self.seed, round_idx, cid
                                         ).standard_normal(shape).astype(
                                             np.float32)
        return torch.as_tensor(noise, device=device)

    def corrupt_reports(self, round_idx: int, logits: torch.Tensor,
                        masks: torch.Tensor, part: Optional[np.ndarray]):
        """Corrupt the stacked ``(C, t, K)`` logits and ``(C, t)`` masks on
        their device. Returns the inputs themselves when no participant is
        faulty this round, clones otherwise."""
        ids = self._faulty_ids(round_idx, part)
        if not ids:
            return logits, masks
        lo = torch.as_tensor(logits).to(torch.float32, copy=True)
        mk = torch.as_tensor(masks, device=lo.device).to(torch.bool,
                                                         copy=True)
        for c in ids:
            if self.mode == "nan":
                lo[c][mk[c]] = torch.nan
            elif self.mode == "random_logits":
                lo[c] = self._noise(round_idx, c, tuple(lo[c].shape),
                                    lo.device)
            elif self.mode == "scaled":
                lo[c] = SCALE_FACTOR * lo[c]
            elif self.mode == "colluding_flip":
                lo[c] = -SCALE_FACTOR * lo[c]
            elif self.mode == "stale_replay":
                cached = self._replay.get(c)
                fresh = (lo[c].clone(), mk[c].clone())
                if cached is not None:
                    lo[c], mk[c] = cached
                self._replay[c] = fresh
        return lo, mk

    def corrupt_classwise(self, round_idx: int,
                          means_counts: Sequence[Tuple[torch.Tensor,
                                                       torch.Tensor]],
                          part: Optional[np.ndarray]):
        """The same trace on the data-free ``(means, counts)`` payloads."""
        ids = self._faulty_ids(round_idx, part)
        if not ids:
            return means_counts
        out = [(torch.as_tensor(m).to(torch.float32, copy=True),
                torch.as_tensor(c).clone()) for m, c in means_counts]
        for c in ids:
            means, counts = out[c]
            if self.mode == "nan":
                means[counts > 0] = torch.nan
            elif self.mode == "random_logits":
                means[...] = self._noise(round_idx, c, tuple(means.shape),
                                         means.device)
            elif self.mode == "scaled":
                means *= SCALE_FACTOR
            elif self.mode == "colluding_flip":
                means *= -SCALE_FACTOR
            elif self.mode == "stale_replay":
                cached = self._replay.get(c)
                fresh = (means.clone(), counts.clone())
                if cached is not None:
                    out[c] = cached
                self._replay[c] = fresh
        return out

    # -- checkpoint state ---------------------------------------------------
    def state_dict(self) -> dict:
        return {"replay": [[int(c), a.cpu().numpy(), b.cpu().numpy()]
                           for c, (a, b) in sorted(self._replay.items())]}

    def load_state_dict(self, sd: dict) -> None:
        self._replay = {
            int(c): (torch.as_tensor(np.array(a, np.float32, copy=True),
                                     device=self.device),
                     torch.as_tensor(np.array(b, copy=True),
                                     device=self.device))
            for c, a, b in sd.get("replay", [])}
