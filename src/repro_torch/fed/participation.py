"""Partial participation and staleness-aware reuse of old reports.

The counterpart of ``repro.fed.participation``:

``sample_participants``
    The subset of clients that trains and reports in round ``r``, drawn
    from ``(seed, round)`` only, so every engine sees the same subset:
    ``uniform`` (without replacement), ``weighted`` (without replacement,
    P(client) ∝ private-set size) or ``roundrobin`` (round ``r`` takes
    clients ``[r·k, r·k + k) mod C``). Numpy, bit for bit the reference's.

``StalenessBuffer``
    The server's memory of each client's last-reported proxy logits and ID
    masks, by proxy-dataset position. A sampled-out client's rows are
    filled from it on this round's proxy indices and weighted
    ``staleness_decay ** age`` in the aggregate (``0 ** 0 = 1``, so decay
    0 drops stale reports and keeps fresh ones). The cached rows live on
    the server's device as tensors, and the merge is index copies and
    ``torch.where``, so it is exact; the per-client bookkeeping (who
    reported, when), the ages, the weights (``decay ** age`` in float64,
    then float32) and the mean age stay numpy, as in the reference, so a
    subset round reads nothing back from the device.

The engines keep sampled-out clients as no-op lanes: a sampled-out client
trains nothing, reports zero logits and all-False masks (replaced here)
and draws nothing from its private rng.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

PARTICIPATION_POLICIES = ("uniform", "weighted", "roundrobin")


def validate_config(cfg) -> None:
    """Fail fast on an inconsistent participation config (FedConfig-like)."""
    f = cfg.participation_fraction
    if not 0.0 < f <= 1.0:
        raise ValueError(
            f"participation_fraction must be in (0, 1], got {f!r}")
    if cfg.participation_policy not in PARTICIPATION_POLICIES:
        raise ValueError(
            f"unknown participation_policy {cfg.participation_policy!r}; "
            f"known: {', '.join(PARTICIPATION_POLICIES)}")
    if not 0.0 <= cfg.staleness_decay <= 1.0:
        raise ValueError(
            f"staleness_decay must be in [0, 1], got {cfg.staleness_decay!r}")


def cohort_size(num_clients: int, fraction: float) -> int:
    """Participants per round: ``round(fraction · C)``, clamped to ``[1, C]``.

    ``round`` is Python's banker's rounding, as in the reference: exact
    half-integers go to the nearest even count (``fraction=0.5, C=5``
    gives 2, ``C=7`` gives 4)."""
    return int(min(max(round(fraction * num_clients), 1), num_clients))


def round_rng(seed: int, round_idx: int) -> np.random.Generator:
    """The round's rng, derived from ``(seed, round)`` and nothing else, so
    sampling never perturbs the client and server streams."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2**32, round_idx, 0x5EED]))


def sample_participants(round_idx: int, num_clients: int, fraction: float,
                        policy: str = "uniform", *, seed: int = 0,
                        data_sizes: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """Boolean participation mask of shape ``(num_clients,)`` for one round.

    ``data_sizes`` (per-client private-set sizes) is required by the
    ``weighted`` policy and ignored by the others.
    """
    if policy not in PARTICIPATION_POLICIES:
        raise ValueError(f"unknown participation policy {policy!r}; "
                         f"known: {', '.join(PARTICIPATION_POLICIES)}")
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction!r}")
    k = cohort_size(num_clients, fraction)
    mask = np.zeros((num_clients,), bool)
    if k == num_clients:
        mask[:] = True
        return mask
    if policy == "roundrobin":
        ids = (round_idx * k + np.arange(k)) % num_clients
    elif policy == "uniform":
        ids = round_rng(seed, round_idx).choice(num_clients, size=k,
                                                replace=False)
    else:  # weighted
        if data_sizes is None:
            raise ValueError(
                "policy='weighted' needs per-client data_sizes")
        sizes = np.asarray(data_sizes, np.float64)
        if sizes.shape != (num_clients,) or np.any(sizes < 0):
            raise ValueError(
                f"data_sizes must be {num_clients} non-negative sizes, got "
                f"shape {sizes.shape}")
        if np.count_nonzero(sizes) < k:
            raise ValueError(
                f"policy='weighted' cannot draw {k} of "
                f"{np.count_nonzero(sizes)} clients with data; shrink "
                "participation_fraction or give every client samples")
        ids = round_rng(seed, round_idx).choice(
            num_clients, size=k, replace=False, p=sizes / sizes.sum())
    mask[ids] = True
    return mask


class StaleMerge(NamedTuple):
    """Result of ``StalenessBuffer.merge``: inputs with stale rows filled.

    ``ages_sum``/``num_contributing`` are the unnormalized pieces of
    ``mean_staleness`` (``mean = ages_sum / num_contributing``)."""
    logits: torch.Tensor        # (C, t, K) fresh or last-reported logits
    masks: torch.Tensor         # (C, t) fresh or last-reported ID masks
    client_weights: np.ndarray  # (C,) float32 staleness_decay ** age
    mean_staleness: float       # mean age over contributing clients
    ages_sum: float = 0.0       # Σ age over contributing clients
    num_contributing: int = 0   # clients whose report reaches the teacher


class StalenessBuffer:
    """Per-client cache of the last-reported proxy logits and ID masks, on
    ``device``.

    When a client participates, its fresh rows land at this round's proxy
    indices; when it sits out, the merge reads whatever it last reported
    at the indices selected now. Entries a client never reported stay
    masked out: a client contributes exactly the knowledge it uploaded.
    """

    def __init__(self, num_clients: int, proxy_size: int, num_classes: int,
                 device="cpu"):
        self.device = torch.device(device)
        self.logits = torch.zeros((num_clients, proxy_size, num_classes),
                                  dtype=torch.float32, device=self.device)
        self.masks = torch.zeros((num_clients, proxy_size), dtype=torch.bool,
                                 device=self.device)
        self.reported = np.zeros((num_clients,), bool)   # ever reported
        self.last_round = np.zeros((num_clients,), np.int64)
        self._last_merge_round: Optional[int] = None

    # ------------------------------------------------- resumable service
    def state_dict(self) -> dict:
        """The buffer's contents, the cached rows as numpy."""
        return {"logits": self.logits.cpu().numpy(),
                "masks": self.masks.cpu().numpy(),
                "reported": self.reported.copy(),
                "last_round": self.last_round.copy(),
                "last_merge_round": self._last_merge_round}

    def load_state_dict(self, sd: dict) -> None:
        logits = torch.as_tensor(np.asarray(sd["logits"], np.float32),
                                 device=self.device)
        if logits.shape != self.logits.shape:
            raise ValueError(
                f"staleness buffer shape mismatch: checkpoint "
                f"{tuple(logits.shape)} vs buffer {tuple(self.logits.shape)}")
        self.logits = logits
        self.masks = torch.as_tensor(np.asarray(sd["masks"], bool),
                                     device=self.device)
        self.reported = np.asarray(sd["reported"], bool).copy()
        self.last_round = np.asarray(sd["last_round"], np.int64).copy()
        lmr = sd.get("last_merge_round")
        self._last_merge_round = None if lmr is None else int(lmr)

    def merge(self, round_idx: int, participants, idx, logits, masks,
              decay: float) -> StaleMerge:
        """Record fresh reports, fill non-participant rows from the cache.

        ``participants``: (C,) bool; ``idx``: this round's proxy indices;
        ``logits``/``masks``: engine outputs (tensors or arrays) whose
        non-participant rows are replaced here. Returns the merged tensors
        on the buffer's device and the per-client weights ``decay ** age``.
        Merges must arrive in non-decreasing round order, or the ages
        would go negative: an earlier round raises ``ValueError``.
        """
        if (self._last_merge_round is not None
                and round_idx < self._last_merge_round):
            raise ValueError(
                f"staleness buffer reports must arrive in round order: got "
                f"round {round_idx} after round {self._last_merge_round} — "
                "reusing one Server across experiments needs a fresh buffer")
        self._last_merge_round = round_idx
        part = np.asarray(participants, bool)
        logits = torch.as_tensor(logits, dtype=torch.float32,
                                 device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        idx_d = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                device=self.device)
        pids = np.flatnonzero(part)
        if pids.size:
            # one indexed write per tensor (the proxy indices are distinct)
            pid_d = torch.as_tensor(pids, device=self.device)
            self.logits[pid_d[:, None], idx_d[None, :]] = logits[pid_d]
            self.masks[pid_d[:, None], idx_d[None, :]] = masks[pid_d]
        self.reported[part] = True
        self.last_round[part] = round_idx
        if part.all():
            # identity fast path: everything is fresh, the inputs come back
            # as they are
            return StaleMerge(logits, masks,
                              np.ones((len(part),), np.float32), 0.0,
                              0.0, int(len(part)))
        part_d = torch.as_tensor(part, device=self.device)
        merged_logits = torch.where(part_d[:, None, None], logits,
                                    self.logits[:, idx_d])
        merged_masks = torch.where(part_d[:, None], masks,
                                   self.masks[:, idx_d])
        ages = np.where(part, 0, round_idx - self.last_round)
        # never-reported clients have all-False cached masks; their weight
        # is zeroed to keep the record honest
        weights = np.where(self.reported,
                           np.power(float(decay), ages), 0.0)
        # the mean age of the reports that reach the teacher: a weight-zero
        # report is dropped from it, so its age does not count
        contributing = self.reported & (weights > 0.0)
        n_contrib = int(np.count_nonzero(contributing))
        ages_sum = float(ages[contributing].sum()) if n_contrib else 0.0
        mean_age = ages_sum / n_contrib if n_contrib else 0.0
        return StaleMerge(merged_logits, merged_masks,
                          weights.astype(np.float32), mean_age,
                          ages_sum, n_contrib)
