"""Federated server: proxy bookkeeping + aggregation. A trusted entity that
never trains a model (EdgeFD needs no pre-trained teacher) — except for
the FedDF baseline (``method="server_distill"``), whose server distills a
student of its own on the fused teacher.

Ported: the flat single-tier server of ``repro.fed.server`` —
``select_indices``; ``ingest_reports`` with the sanitize pass, which runs
before the staleness merge so a corrupt row never enters the buffer;
partial participation through the ``StalenessBuffer``
(``merge_stale``), whose cached rows live on the server's device;
admission control (``admit_reports`` under ``max_pending_reports``);
``aggregate_round``/``aggregate`` (staleness weights, DS-FL sharpening,
Selective-FD's entropy filter), ``aggregate_classwise`` (FKD/PLS), the
FedDF student and the byte ledger, which prices only this round's fresh
uploads. Report ingest and aggregation stay separate steps, as in the
reference, so overlapping rounds can interleave. Edge aggregators, robust
reducers and trust/quarantine are not ported yet (ROADMAP queue A item
7).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import aggregation
from repro_torch.core.filtering import server_entropy_filter
from repro_torch.data.proxy import ProxyData, select_round_indices
from repro_torch.fed.client import Learner
from repro_torch.fed.participation import StaleMerge, StalenessBuffer
from repro_torch.optim.optimizers import Optimizer


class _PendingReports(NamedTuple):
    """One round's ingested-but-not-yet-aggregated proxy reports, on the
    server's device: the raw reports when every client reported, or the
    stale-merged rows of a subset round (never both)."""
    participants: Optional[np.ndarray]   # (C,) bool, None = everyone
    logits: Optional[torch.Tensor]       # (C, t, K); None when merged
    masks: Optional[torch.Tensor]        # (C, t) bool; None when merged
    merged: Optional[StaleMerge]         # stale-filled rows (subset rounds)


class Server:
    def __init__(self, proxy: ProxyData, *, seed: int = 0,
                 max_pending_reports: int = 0, sanitize: bool = True,
                 device="cuda"):
        if max_pending_reports < 0:
            raise ValueError(f"max_pending_reports must be >= 0 "
                             f"(0 = unbounded), got {max_pending_reports!r}")
        self.proxy = proxy
        self.seed = seed
        self.rng = np.random.default_rng(seed + 7)
        self.sanitize = bool(sanitize)
        self.device = torch.device(device)
        # sanitize-pass accounting: cumulative scrubbed rows (total and per
        # client) plus the per-round counts the scheduler pops into RoundLog
        self.scrub_total = 0
        self.scrub_clients: Optional[np.ndarray] = None       # (C,) int64
        self._scrubbed_rounds: Dict[int, int] = {}
        # admission: the ingest queue holds at most this many client
        # reports over all in-flight rounds (0 = unbounded); a report that
        # finds it full is refused and drains through the staleness buffer
        # like a dropout. Counted per round, released by aggregate_round.
        self.max_pending_reports = int(max_pending_reports)
        self._inflight_reports: Dict[int, int] = {}
        self.bytes_received = 0
        self.bytes_broadcast = 0
        # every client's last report (partial participation only), sized at
        # the first subset ingest
        self._stale: Optional[StalenessBuffer] = None
        # rounds ingested but not yet aggregated (overlap mode keeps up to
        # max_inflight of them)
        self._pending: Dict[int, _PendingReports] = {}
        # FedDF central student (method="server_distill" only), attached by
        # the simulator after the clients are built
        self.student: Optional[Learner] = None

    def select_indices(self, batch: int) -> np.ndarray:
        return select_round_indices(self.rng, self.proxy, batch)

    def pop_scrubbed(self, round_idx: int) -> int:
        """Rows the sanitize pass scrubbed from this round's reports."""
        return int(self._scrubbed_rounds.pop(round_idx, 0))

    def _count_scrubbed(self, round_idx: Optional[int],
                        per_client: torch.Tensor) -> None:
        n_bad = int(per_client.sum())
        if not n_bad:
            return
        if round_idx is not None:
            self._scrubbed_rounds[round_idx] = (
                self._scrubbed_rounds.get(round_idx, 0) + n_bad)
        self.scrub_total += n_bad
        if self.scrub_clients is None:
            self.scrub_clients = np.zeros((len(per_client),), np.int64)
        self.scrub_clients += per_client.cpu().numpy()

    # ------------------------------------------------- FedDF student
    def attach_student(self, model: nn.Module, opt: Optimizer, *,
                       temperature: float = 3.0,
                       kernel_backend: Optional[str] = None) -> None:
        """Give the server a trainable student for ensemble distillation
        (the simulator builds client 0's architecture). Its shuffling
        stream, ``default_rng(seed + 31)``, is disjoint from the server's
        own (seed + 7) and every client's (seed + 1000·cid); its KD step
        is the clients' temperature-KL step, in train mode, and its
        evaluation runs in eval mode (``Learner``)."""
        self.student = Learner(model, opt,
                               np.random.default_rng(self.seed + 31),
                               temperature=temperature,
                               kernel_backend=kernel_backend)

    def ensemble_distill(self, px: torch.Tensor, teacher: torch.Tensor,
                         valid: torch.Tensor, *, epochs: int,
                         batch_size: int) -> float:
        """One FedDF server round: fit the student on the proxy batch
        against the fused teacher; rows no client predicted (``valid``
        False) carry zero weight, as in client-side distillation."""
        if self.student is None:
            raise RuntimeError("ensemble_distill requires attach_student()")
        return self.student.distill(px, teacher, valid.to(torch.float32),
                                    epochs, batch_size)

    def evaluate_student(self, x_test: torch.Tensor,
                         y_test: torch.Tensor) -> float:
        if self.student is None:
            raise RuntimeError("evaluate_student requires attach_student()")
        return self.student.evaluate(x_test, y_test)

    # ------------------------------------------------- proxy-logit reports
    def admit_reports(self, round_idx: int,
                      ordered_ids: np.ndarray) -> np.ndarray:
        """Admission control over one round's report arrivals.

        ``ordered_ids``: the round's reporting client ids in simulated
        arrival order. Each is admitted while the ingest queue has room —
        ``max_pending_reports`` minus the reports parked for rounds not yet
        aggregated — and refused after, so the earliest arrivals of an
        overloaded round get in. Returns the admitted prefix; with
        ``max_pending_reports=0`` every report is admitted and nothing is
        recorded."""
        ordered_ids = np.asarray(ordered_ids)
        if self.max_pending_reports <= 0:
            return ordered_ids
        used = sum(self._inflight_reports.values())
        free = max(0, self.max_pending_reports - used)
        admitted = ordered_ids[:free]
        self._inflight_reports[round_idx] = int(admitted.size)
        return admitted

    def merge_stale(self, round_idx: int, participants, idx, logits, masks,
                    *, decay: float) -> StaleMerge:
        """Record this round's fresh reports and fill non-participant rows
        from each client's last report (``fed.participation``)."""
        if self._stale is None:
            c, _, k = logits.shape
            self._stale = StalenessBuffer(c, len(self.proxy.x), k,
                                          device=self.device)
        return self._stale.merge(round_idx, participants, idx, logits, masks,
                                 decay)

    def ingest_reports(self, round_idx: int, participants, idx, logits,
                       masks, *, decay: float,
                       entropy_filter: bool = False) -> None:
        """Record one round's reports, (C, t, K) / (C, t), for a later
        ``aggregate_round``. Tensors already on the server's device are not
        copied.

        The sanitize pass runs first, so a non-finite row never enters the
        staleness buffer. Stale rows are merged now: ingests arrive in
        round order (the scheduler's order edges), so the buffer holds
        exactly the rounds before this one. ``participants=None`` (every
        client reported) skips the buffer. ``entropy_filter`` matters only
        to the reference's two-tier server; the flat server runs it in
        ``aggregate``."""
        if round_idx in self._pending:
            raise ValueError(f"round {round_idx} reports already ingested "
                             "and not yet aggregated")
        logits = torch.as_tensor(logits, dtype=torch.float32,
                                 device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        if self.sanitize:
            # clean reports come back as the same objects
            logits, masks, per_client = aggregation.scrub_nonfinite(logits,
                                                                    masks)
            self._count_scrubbed(round_idx, per_client)
        if participants is None:
            self._pending[round_idx] = _PendingReports(None, logits, masks,
                                                       None)
            return
        merged = self.merge_stale(round_idx, participants, idx, logits,
                                  masks, decay=decay)
        self._pending[round_idx] = _PendingReports(
            np.asarray(participants, bool), None, None, merged)

    def aggregate_round(self, round_idx: int, *,
                        sharpen: Optional[float] = None,
                        entropy_filter: bool = False):
        """Fuse a previously ingested round into (teacher, valid,
        mean_staleness). A full-participation round takes the plain
        ``aggregate``; a subset round aggregates the stale-merged rows
        with their staleness weights, its ledger pricing the
        participants' uploads only."""
        try:
            p = self._pending.pop(round_idx)
        except KeyError:
            raise ValueError(
                f"no ingested reports for round {round_idx}; call "
                "ingest_reports first") from None
        # the round's parked reports leave the admission queue
        self._inflight_reports.pop(round_idx, None)
        if p.merged is None:
            teacher, valid = self.aggregate(p.logits, p.masks,
                                            sharpen=sharpen,
                                            entropy_filter=entropy_filter)
            return teacher, valid, 0.0
        teacher, valid = self.aggregate(
            p.merged.logits, p.merged.masks, sharpen=sharpen,
            entropy_filter=entropy_filter,
            client_weights=p.merged.client_weights,
            uploaded_rows=p.participants)
        return teacher, valid, p.merged.mean_staleness

    def aggregate(self, logits, masks, *, sharpen: Optional[float] = None,
                  entropy_filter: bool = False, client_weights=None,
                  uploaded_rows=None):
        """logits: (C, t, K); masks: (C, t). Returns device tensors
        (teacher (t, K), valid (t,) bool); the mean runs on the server's
        device and only the ledger's ID count is read back.

        ``client_weights`` (C,) weights stale reports by ``decay ** age``
        (all ones takes the plain masked mean, as in the reference).
        ``uploaded_rows`` (C,) bool restricts the ledger to the clients
        that reported this round: stale reuse costs no bytes. The ledger
        prices the pre-filter masks: clients uploaded every row their own
        filter kept, before Selective-FD's server-side entropy filter
        tightens the masks."""
        logits = torch.as_tensor(logits, dtype=torch.float32,
                                 device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        uploaded_masks = masks
        if entropy_filter:  # Selective-FD baseline's extra server stage
            masks = server_entropy_filter(logits, masks)
        cw = (None if client_weights is None
              else np.asarray(client_weights, np.float32))
        if cw is not None and not bool(np.all(cw == 1.0)):
            teacher, valid = aggregation.weighted_masked_mean_logits(
                logits, masks, torch.as_tensor(cw, device=self.device),
                temperature_sharpen=sharpen, guard_finite=self.sanitize)
        else:
            teacher, valid = aggregation.masked_mean_logits(
                logits, masks, temperature_sharpen=sharpen,
                guard_finite=self.sanitize)
        # accounting: clients upload only ID logits (mask-compressed), and
        # only the round's participants upload at all
        k = logits.shape[-1]
        up = (uploaded_masks if uploaded_rows is None
              else uploaded_masks[torch.as_tensor(
                  np.asarray(uploaded_rows, bool), device=self.device)])
        self.bytes_received += int(up.sum()) * k * 4
        self.bytes_broadcast += int(teacher.shape[0]) * k * 4
        return teacher, valid

    # ------------------------------------------------- class-wise reports
    def aggregate_classwise(self, means_counts: Sequence[Tuple[torch.Tensor,
                                                               torch.Tensor]],
                            *, count_weighted: bool, uploaded_rows=None,
                            round_idx: Optional[int] = None):
        """FKD/PLS: fuse every client's per-class mean logits (K_cls, K)
        and counts (K_cls,) into (teacher (K_cls, K), valid (K_cls,) bool).

        PLS (``count_weighted``) weights each client's class mean by its
        sample count, FKD by 1 per client holding the class. The sanitize
        pass zeroes non-finite class rows and drops their counts. Every
        reporting client uploads its whole table (``uploaded_rows`` (C,)
        bool: this round's participants, whose sampled-out peers hand in
        zero counts and upload nothing; None: everyone) and the fused
        table is broadcast back; both go into the byte ledger."""
        means = torch.stack([torch.as_tensor(m, dtype=torch.float32,
                                             device=self.device)
                             for m, _ in means_counts])      # (C, K_cls, K)
        counts = torch.stack([torch.as_tensor(c, dtype=torch.float32,
                                              device=self.device)
                              for _, c in means_counts])     # (C, K_cls)
        if self.sanitize:
            fin = torch.isfinite(means).all(dim=-1)           # (C, K_cls)
            if not bool(fin.all()):
                self._count_scrubbed(
                    round_idx, torch.sum((counts > 0) & ~fin, dim=1,
                                         dtype=torch.int64))
                means = torch.where(fin[..., None], means, 0.0)
                counts = torch.where(fin, counts, 0.0)
        if count_weighted:
            w = counts[..., None]
        else:
            w = (counts > 0).to(torch.float32)[..., None]
        num = torch.sum(means * w, dim=0)
        den = torch.sum(w, dim=0)
        teacher = num / torch.clamp_min(den, 1.0)
        valid = torch.sum(counts, dim=0) > 0
        reporting = (means.shape[0] if uploaded_rows is None
                     else int(np.asarray(uploaded_rows, bool).sum()))
        self.bytes_received += reporting * means[0].numel() * 4
        self.bytes_broadcast += teacher.numel() * 4
        return teacher, valid
