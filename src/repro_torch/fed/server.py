"""Federated server: proxy bookkeeping + aggregation. A trusted entity that
never trains a model (EdgeFD needs no pre-trained teacher).

Ported so far: the flat single-tier server with full participation —
``select_indices``, ``ingest_reports`` with the sanitize pass,
``aggregate_round``/``aggregate`` and the byte ledger of
``repro.fed.server``. Report ingest and aggregation stay separate steps,
as in the reference. Edge aggregators, staleness buffers, admission
control, robust reducers, trust/quarantine and the FedDF server student
are not ported yet (ROADMAP queue A items 6–8, 4).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.data.proxy import ProxyData, select_round_indices


class _PendingReports(NamedTuple):
    """One round's ingested-but-not-yet-aggregated proxy reports, on the
    server's device."""
    logits: torch.Tensor       # (C, t, K)
    masks: torch.Tensor        # (C, t) bool


class Server:
    def __init__(self, proxy: ProxyData, *, seed: int = 0,
                 sanitize: bool = True, device="cpu"):
        self.proxy = proxy
        self.rng = np.random.default_rng(seed + 7)
        self.sanitize = bool(sanitize)
        self.device = torch.device(device)
        # sanitize-pass accounting: cumulative scrubbed rows (total and per
        # client) plus the per-round counts the scheduler pops into RoundLog
        self.scrub_total = 0
        self.scrub_clients: Optional[np.ndarray] = None       # (C,) int64
        self._scrubbed_rounds: Dict[int, int] = {}
        self.bytes_received = 0
        self.bytes_broadcast = 0
        self._pending: Dict[int, _PendingReports] = {}

    def select_indices(self, batch: int) -> np.ndarray:
        return select_round_indices(self.rng, self.proxy, batch)

    def pop_scrubbed(self, round_idx: int) -> int:
        """Rows the sanitize pass scrubbed from this round's reports."""
        return int(self._scrubbed_rounds.pop(round_idx, 0))

    def ingest_reports(self, round_idx: int, logits, masks) -> None:
        """Record one round's reports from every client, (C, t, K) /
        (C, t), for a later ``aggregate_round``, after the sanitize pass.
        Tensors already on the server's device are not copied. (The
        reference's participant, staleness and entropy-filter arguments
        come with ROADMAP queue A items 6 and 4.)"""
        if round_idx in self._pending:
            raise ValueError(f"round {round_idx} reports already ingested "
                             "and not yet aggregated")
        logits = torch.as_tensor(logits, dtype=torch.float32,
                                 device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        if self.sanitize:
            # scrub before anything downstream; clean reports come back as
            # the same objects
            logits, masks, per_client = aggregation.scrub_nonfinite(logits,
                                                                    masks)
            n_bad = int(per_client.sum())
            if n_bad:
                self._scrubbed_rounds[round_idx] = (
                    self._scrubbed_rounds.get(round_idx, 0) + n_bad)
                self.scrub_total += n_bad
                if self.scrub_clients is None:
                    self.scrub_clients = np.zeros((len(per_client),),
                                                  np.int64)
                self.scrub_clients += per_client.cpu().numpy()
        self._pending[round_idx] = _PendingReports(logits, masks)

    def aggregate_round(self, round_idx: int):
        """Fuse a previously ingested round into (teacher, valid,
        mean_staleness); every report is fresh, so the staleness is 0."""
        try:
            p = self._pending.pop(round_idx)
        except KeyError:
            raise ValueError(
                f"no ingested reports for round {round_idx}; call "
                "ingest_reports first") from None
        teacher, valid = self.aggregate(p.logits, p.masks)
        return teacher, valid, 0.0

    def aggregate(self, logits, masks):
        """logits: (C, t, K); masks: (C, t). Returns device tensors
        (teacher (t, K), valid (t,) bool); the masked mean runs on the
        server's device and only the ledger's ID count is read back."""
        logits = torch.as_tensor(logits, dtype=torch.float32,
                                 device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        teacher, valid = aggregation.masked_mean_logits(
            logits, masks, guard_finite=self.sanitize)
        # accounting: clients upload only ID logits (mask-compressed)
        k = logits.shape[-1]
        self.bytes_received += int(masks.sum()) * k * 4
        self.bytes_broadcast += int(teacher.shape[0]) * k * 4
        return teacher, valid
