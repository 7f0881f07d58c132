"""Federated server: proxy bookkeeping + aggregation. A trusted entity that
never trains a model (EdgeFD needs no pre-trained teacher) — except for
the FedDF baseline (``method="server_distill"``), whose server distills a
student of its own on the fused teacher.

The counterpart of ``repro.fed.server``: ``select_indices``;
``ingest_reports`` with the sanitize pass, which runs before anything
downstream so a corrupt row never enters a staleness buffer or an edge
partial; partial participation through the ``StalenessBuffer``, whose
cached rows live on the server's device; admission control
(``admit_reports`` under ``max_pending_reports``); ``aggregate_round``/
``aggregate`` (staleness weights, DS-FL sharpening, Selective-FD's
entropy filter, the robust reducers), ``aggregate_classwise`` (FKD/PLS),
the FedDF student and the byte ledger, which prices only this round's
fresh uploads. Report ingest and aggregation stay separate steps, as in
the reference, so overlapping rounds can interleave.

With ``num_edges > 1`` the server is two-tier: E edge aggregators each own
a contiguous client shard and, at ingest, apply the server-side filter,
keep the staleness bookkeeping in a per-shard buffer (made at the shard's
first subset ingest) and reduce the shard to one ``(num, den)`` partial.
The root fuses the E partials, so a pending round holds O(E · t · K).
Under a robust ``robust_aggregation`` each edge contributes ``(center ·
n_e, n_e)``, the reference's approximation of the flat robust reduce.

Trust and quarantine: with ``track_outliers`` every aggregation scores
each client's distance from the fused center, folds it into an EWMA trust
score and, past ``quarantine_threshold``, quarantines the client for
``quarantine_rounds`` × its strikes; the scheduler's participant draw
leaves it out. Trust, strikes and quarantine are host numpy arrays; the
reports stay on the server's device, and only the ledger's counts and the
(C,) outlier distances come back to the host.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

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


class _PendingPartials(NamedTuple):
    """One round's edge-reduced reports (``num_edges > 1`` only), on the
    server's device: each edge already collapsed its shard to a partial
    sum, so the (C, t, K) stack does not outlive ``ingest_reports``."""
    nums: torch.Tensor      # (E, t, K) per-edge weighted logit sums
    dens: torch.Tensor      # (E, t) per-edge weight sums
    uploaded_bytes: int     # upload traffic, priced from pre-filter masks
    mean_staleness: float   # fleet-wide Σ age / Σ contributing
    # trust signal (track_outliers only): each client's distance from its
    # edge's center and whether it contributed, computed at ingest
    outlier: Optional[np.ndarray] = None    # (C,) float64
    contrib: Optional[np.ndarray] = None    # (C,) bool


# EWMA trust scores of non-finite senders are pinned here instead of inf,
# so the running average stays finite
_TRUST_CAP = 1e9


class Server:
    def __init__(self, proxy: ProxyData, *, seed: int = 0,
                 num_edges: int = 1, max_pending_reports: int = 0,
                 robust_aggregation: str = "mean", trim_frac: float = 0.2,
                 sanitize: bool = True, quarantine_threshold: float = 0.0,
                 trust_ewma: float = 0.5, quarantine_rounds: int = 2,
                 track_outliers: bool = False, device="cuda"):
        if num_edges < 1:
            raise ValueError(f"num_edges must be >= 1, got {num_edges!r}")
        if max_pending_reports < 0:
            raise ValueError(f"max_pending_reports must be >= 0 "
                             f"(0 = unbounded), got {max_pending_reports!r}")
        if robust_aggregation not in aggregation.ROBUST_AGGREGATIONS:
            raise ValueError(
                f"robust_aggregation must be one of "
                f"{aggregation.ROBUST_AGGREGATIONS}, "
                f"got {robust_aggregation!r}")
        if not 0.0 <= trim_frac < 0.5:
            raise ValueError(
                f"trim_frac must be in [0, 0.5), got {trim_frac!r}")
        if quarantine_threshold < 0.0:
            raise ValueError(f"quarantine_threshold must be >= 0 "
                             f"(0 = off), got {quarantine_threshold!r}")
        if not 0.0 < trust_ewma <= 1.0:
            raise ValueError(
                f"trust_ewma must be in (0, 1], got {trust_ewma!r}")
        if quarantine_rounds < 1:
            raise ValueError(f"quarantine_rounds must be >= 1, "
                             f"got {quarantine_rounds!r}")
        self.proxy = proxy
        self.seed = seed
        self.rng = np.random.default_rng(seed + 7)
        self.num_edges = int(num_edges)
        self.device = torch.device(device)
        # -- defense stack
        self.robust_aggregation = robust_aggregation
        self.trim_frac = float(trim_frac)
        self.sanitize = bool(sanitize)
        self.quarantine_threshold = float(quarantine_threshold)
        self.trust_ewma = float(trust_ewma)
        self.quarantine_rounds = int(quarantine_rounds)
        # outlier distances are computed only when something reads them:
        # the quarantine rule or the watchdog
        self.track_outliers = bool(track_outliers) or quarantine_threshold > 0
        # sanitize-pass accounting: cumulative scrubbed rows (total and per
        # client) plus the per-round counts the scheduler pops into RoundLog
        self.scrub_total = 0
        self.scrub_clients: Optional[np.ndarray] = None       # (C,) int64
        self._scrubbed_rounds: Dict[int, int] = {}
        # trust and quarantine, sized to the fleet at the first signal:
        # trust is an EWMA of the median-normalized outlier distance;
        # quarantined_until[c] > r means c sits out round r; strikes
        # lengthen each new quarantine
        self.trust: Optional[np.ndarray] = None               # (C,) float64
        self.quarantined_until: Optional[np.ndarray] = None   # (C,) int64
        self.strikes: Optional[np.ndarray] = None             # (C,) int64
        # per-round normalized outlier scores and quarantine events, until
        # the scheduler pops them
        self._round_outlier: Dict[int, np.ndarray] = {}
        self._quarantine_events: Dict[int, List[int]] = {}
        # admission: the ingest queue holds at most this many client
        # reports over all in-flight rounds (0 = unbounded); a report that
        # finds it full is refused and drains through the staleness buffer
        # like a dropout. Counted per round, released by aggregate_round.
        self.max_pending_reports = int(max_pending_reports)
        self._inflight_reports: Dict[int, int] = {}
        self.bytes_received = 0
        self.bytes_broadcast = 0
        # every client's last report (partial participation only), sized at
        # the first subset ingest: one flat buffer, or one an edge shard
        self._stale: Optional[StalenessBuffer] = None
        self._edge_stale: List[Optional[StalenessBuffer]] = []
        self._shard_slices: Optional[List[slice]] = None
        # rounds ingested but not yet aggregated (overlap mode keeps up to
        # max_inflight of them)
        self._pending: Dict[int, Union[_PendingReports,
                                       _PendingPartials]] = {}
        # FedDF central student (method="server_distill" only), attached by
        # the simulator after the clients are built
        self.student: Optional[Learner] = None

    def _shards(self, num_clients: int) -> List[slice]:
        """Contiguous per-edge client shards, fixed at first use; at most
        one edge a client."""
        if self._shard_slices is None:
            e = min(self.num_edges, num_clients)
            bounds = np.linspace(0, num_clients, e + 1).astype(int)
            self._shard_slices = [slice(int(a), int(b))
                                  for a, b in zip(bounds[:-1], bounds[1:])
                                  if b > a]
            self._edge_stale = [None] * len(self._shard_slices)
        return self._shard_slices

    def select_indices(self, batch: int) -> np.ndarray:
        return select_round_indices(self.rng, self.proxy, batch)

    # ------------------------------------------------ trust & quarantine
    def _ensure_fleet(self, num_clients: int) -> None:
        """Size (or grow, padding with zeros) the per-client bookkeeping."""
        def grow(a, dtype):
            if a is None:
                return np.zeros((num_clients,), dtype)
            if a.shape[0] < num_clients:
                b = np.zeros((num_clients,), dtype)
                b[:a.shape[0]] = a
                return b
            return a
        self.trust = grow(self.trust, np.float64)
        self.quarantined_until = grow(self.quarantined_until, np.int64)
        self.strikes = grow(self.strikes, np.int64)
        self.scrub_clients = grow(self.scrub_clients, np.int64)

    def quarantine_mask(self, round_idx: int) -> Optional[np.ndarray]:
        """(C,) bool, True where a client sits out this round; None when
        nobody does."""
        if self.quarantined_until is None:
            return None
        mask = self.quarantined_until > round_idx
        return mask if mask.any() else None

    def quarantine(self, ids, first_round: int, *,
                   event_round: Optional[int] = None) -> List[int]:
        """Keep ``ids`` out of the rounds from ``first_round`` on, for
        ``quarantine_rounds`` × each one's strike count. On release a
        client is on probation: its trust is reset to half the threshold.
        The event is recorded under ``event_round`` (default
        ``first_round``) for that round's ``RoundLog``."""
        ids = sorted(int(c) for c in np.asarray(ids).ravel())
        if not ids:
            return []
        self._ensure_fleet(max(ids) + 1)
        for c in ids:
            self.strikes[c] += 1
            until = first_round + self.quarantine_rounds * int(
                self.strikes[c])
            self.quarantined_until[c] = max(
                int(self.quarantined_until[c]), until)
            self.trust[c] = 0.5 * self.quarantine_threshold
        key = first_round if event_round is None else event_round
        self._quarantine_events.setdefault(key, []).extend(ids)
        return ids

    def _update_trust(self, round_idx: int, dist: np.ndarray,
                      contributing: np.ndarray) -> None:
        """Fold one round's outlier distances into the EWMA trust scores:
        normalized by the round's median over finite contributors,
        non-finite senders pinned at ``_TRUST_CAP``, non-contributing
        clients left as they are."""
        dist = np.asarray(dist, np.float64)
        contributing = np.asarray(contributing, bool)
        self._ensure_fleet(dist.shape[0])
        finite = np.isfinite(dist) & contributing
        scale = float(np.median(dist[finite])) if finite.any() else 0.0
        with np.errstate(invalid="ignore"):
            norm = np.where(np.isfinite(dist),
                            dist / max(scale, 1e-12), np.inf)
        norm = np.minimum(np.where(contributing, norm, 0.0), _TRUST_CAP)
        a = self.trust_ewma
        self.trust = np.where(contributing,
                              (1.0 - a) * self.trust + a * norm, self.trust)
        self._round_outlier[round_idx] = norm
        if self.quarantine_threshold > 0.0:
            bad = contributing & (self.trust > self.quarantine_threshold)
            if bad.any():
                # round_idx has just aggregated: the exclusion starts next
                # round
                self.quarantine(np.nonzero(bad)[0], round_idx + 1,
                                event_round=round_idx)

    def pop_scrubbed(self, round_idx: int) -> int:
        """Rows the sanitize pass scrubbed from this round's reports."""
        return int(self._scrubbed_rounds.pop(round_idx, 0))

    def pop_quarantined(self, round_idx: int) -> List[int]:
        """Clients quarantined on this round's evidence (may be empty)."""
        return self._quarantine_events.pop(round_idx, [])

    def pop_round_outlier(self, round_idx: int) -> Optional[np.ndarray]:
        """This round's normalized outlier scores; None when tracking is
        off or the round had none."""
        return self._round_outlier.pop(round_idx, None)

    def _count_scrubbed(self, round_idx: Optional[int],
                        per_client: torch.Tensor) -> None:
        n_bad = int(per_client.sum())
        if not n_bad:
            return
        if round_idx is not None:
            self._scrubbed_rounds[round_idx] = (
                self._scrubbed_rounds.get(round_idx, 0) + n_bad)
        self.scrub_total += n_bad
        self._ensure_fleet(len(per_client))
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

        The sanitize pass runs first, so a non-finite row never enters a
        staleness buffer or an edge partial. Stale rows are merged now:
        ingests arrive in round order (the scheduler's order edges), so
        the buffer holds exactly the rounds before this one.
        ``participants=None`` (every client reported) skips the buffer.
        ``entropy_filter`` acts here only on the two-tier server, whose
        edges filter their shard before reducing it; the flat server runs
        it in ``aggregate``."""
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
        if self.num_edges > 1:
            self._pending[round_idx] = self._ingest_edges(
                round_idx, participants, idx, logits, masks, decay=decay,
                entropy_filter=entropy_filter)
            return
        if participants is None:
            self._pending[round_idx] = _PendingReports(None, logits, masks,
                                                       None)
            return
        merged = self.merge_stale(round_idx, participants, idx, logits,
                                  masks, decay=decay)
        self._pending[round_idx] = _PendingReports(
            np.asarray(participants, bool), None, None, merged)

    def _ingest_edges(self, round_idx: int, participants, idx,
                      logits: torch.Tensor, masks: torch.Tensor, *,
                      decay: float, entropy_filter: bool) -> _PendingPartials:
        """Two-tier ingest: every edge reduces its client shard to one
        ``(num, den)`` partial, with the server-side filter and the
        staleness bookkeeping kept shard-local.

        Under a robust ``robust_aggregation`` each edge runs the robust
        reduce over its own shard and contributes ``(center · n_e, n_e)``;
        the root fuses contributor-weighted edge centers. As in the
        reference this approximates the flat robust reduce (a mean of
        shard medians is not the global median) at the mean path's
        O(E · t · K) root cost; ``num_edges=1`` never comes here, so E = 1
        is the flat robust reduce exactly."""
        part = (None if participants is None
                else np.asarray(participants, bool))
        part_d = (None if part is None
                  else torch.as_tensor(part, device=self.device))
        num_clients, k = logits.shape[0], logits.shape[-1]
        shards = self._shards(num_clients)
        nums, dens = [], []
        uploaded_bytes = 0
        ages_sum, n_contrib = 0.0, 0
        robust = self.robust_aggregation != "mean"
        outlier = (np.zeros((num_clients,), np.float64)
                   if self.track_outliers else None)
        contrib = (np.zeros((num_clients,), bool)
                   if self.track_outliers else None)
        for e, sl in enumerate(shards):
            l_e, m_e = logits[sl], masks[sl]
            cw = None
            if part is None:
                # everyone reported: the uploads are the raw ID rows
                uploaded_bytes += int(m_e.sum()) * k * 4
            else:
                # priced from the pre-filter fresh masks of this round's
                # reporters; stale reuse costs no bytes
                uploaded_bytes += int(m_e[part_d[sl]].sum()) * k * 4
                if self._edge_stale[e] is None:
                    self._edge_stale[e] = StalenessBuffer(
                        l_e.shape[0], len(self.proxy.x), k,
                        device=self.device)
                merged = self._edge_stale[e].merge(
                    round_idx, part[sl], idx, l_e, m_e, decay)
                l_e, m_e = merged.logits, merged.masks
                cw = merged.client_weights
                ages_sum += merged.ages_sum
                n_contrib += merged.num_contributing
            if entropy_filter:  # a per-row filter: shard-local is exact
                m_e = server_entropy_filter(l_e, m_e)
            if robust:
                # one vote a surviving client: staleness weights act only
                # as a contribute/exclude mask
                m_r = (m_e if cw is None else m_e & torch.as_tensor(
                    cw > 0.0, device=self.device)[:, None])
                center, _ = aggregation.robust_reduce(
                    l_e, m_r, self.robust_aggregation,
                    trim_frac=self.trim_frac)
                cnt = torch.sum(m_r, dim=0).to(torch.float32)  # (t,)
                num, den = center * cnt[:, None], cnt
            else:
                m_r = m_e
                num, den = aggregation.partial_masked_sums(
                    l_e, m_e, None if cw is None
                    else torch.as_tensor(cw, device=self.device),
                    guard_finite=self.sanitize)
                center = None
            if self.track_outliers:
                if center is None:
                    center = num / torch.clamp_min(den, 1.0)[:, None]
                d_e, c_e = aggregation.client_outlier_distance(
                    l_e, m_r, center)
                outlier[sl], contrib[sl] = d_e, c_e
            nums.append(num)
            dens.append(den)
        mean_staleness = (ages_sum / n_contrib
                          if part is not None and n_contrib else 0.0)
        return _PendingPartials(torch.stack(nums), torch.stack(dens),
                                uploaded_bytes, mean_staleness,
                                outlier, contrib)

    def aggregate_round(self, round_idx: int, *,
                        sharpen: Optional[float] = None,
                        entropy_filter: bool = False):
        """Fuse a previously ingested round into (teacher, valid,
        mean_staleness). A two-tier round fuses its edge partials (the
        filter and the staleness weights are already in them); a
        full-participation round takes the plain ``aggregate``; a subset
        round aggregates the stale-merged rows with their staleness
        weights, its ledger pricing the participants' uploads only. With
        ``track_outliers`` every branch updates the trust scores."""
        try:
            p = self._pending.pop(round_idx)
        except KeyError:
            raise ValueError(
                f"no ingested reports for round {round_idx}; call "
                "ingest_reports first") from None
        # the round's parked reports leave the admission queue
        self._inflight_reports.pop(round_idx, None)
        if isinstance(p, _PendingPartials):
            teacher, valid = aggregation.fuse_partial_sums(
                p.nums, p.dens, temperature_sharpen=sharpen)
            self.bytes_received += p.uploaded_bytes
            self.bytes_broadcast += int(teacher.shape[0]) * int(
                teacher.shape[-1]) * 4
            if self.track_outliers and p.outlier is not None:
                self._update_trust(round_idx, p.outlier, p.contrib)
            return teacher, valid, p.mean_staleness
        if p.merged is None:
            teacher, valid = self.aggregate(p.logits, p.masks,
                                            sharpen=sharpen,
                                            entropy_filter=entropy_filter)
            if self.track_outliers:
                dist, contrib = aggregation.client_outlier_distance(
                    p.logits, p.masks, teacher)
                self._update_trust(round_idx, dist, contrib)
            return teacher, valid, 0.0
        teacher, valid = self.aggregate(
            p.merged.logits, p.merged.masks, sharpen=sharpen,
            entropy_filter=entropy_filter,
            client_weights=p.merged.client_weights,
            uploaded_rows=p.participants)
        if self.track_outliers:
            m_eff = p.merged.masks & torch.as_tensor(
                p.merged.client_weights > 0.0, device=self.device)[:, None]
            dist, contrib = aggregation.client_outlier_distance(
                p.merged.logits, m_eff, teacher)
            self._update_trust(round_idx, dist, contrib)
        return teacher, valid, p.merged.mean_staleness

    def aggregate(self, logits, masks, *, sharpen: Optional[float] = None,
                  entropy_filter: bool = False, client_weights=None,
                  uploaded_rows=None):
        """logits: (C, t, K); masks: (C, t). Returns device tensors
        (teacher (t, K), valid (t,) bool); the reduce runs on the server's
        device and only the ledger's ID count is read back.

        ``client_weights`` (C,) weights stale reports by ``decay ** age``
        (all ones takes the plain masked mean, as in the reference); under
        a robust ``robust_aggregation`` they only include or exclude a
        client. ``uploaded_rows`` (C,) bool restricts the ledger to the
        clients that reported this round: stale reuse costs no bytes. The
        ledger prices the pre-filter masks: clients uploaded every row
        their own filter kept, before Selective-FD's server-side entropy
        filter tightens the masks."""
        logits = torch.as_tensor(logits, dtype=torch.float32,
                                 device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        uploaded_masks = masks
        if entropy_filter:  # Selective-FD baseline's extra server stage
            masks = server_entropy_filter(logits, masks)
        cw = (None if client_weights is None
              else np.asarray(client_weights, np.float32))
        if self.robust_aggregation != "mean":
            m_r = (masks if cw is None else masks & torch.as_tensor(
                cw > 0.0, device=self.device)[:, None])
            teacher, valid = aggregation.robust_reduce(
                logits, m_r, self.robust_aggregation,
                trim_frac=self.trim_frac, temperature_sharpen=sharpen)
        elif cw is not None and not bool(np.all(cw == 1.0)):
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
        pass zeroes non-finite class rows and drops their counts. A robust
        ``robust_aggregation`` reduces the (C, K_cls, K) stack over
        clients, class slots standing in for proxy positions, one vote a
        reporting client, always globally (the payload is K_cls · K). With
        ``num_edges > 1`` the mean is summed edge by edge, a regrouped sum.
        Every reporting client uploads its whole table (``uploaded_rows``
        (C,) bool: this round's participants; None: everyone) and the
        fused table is broadcast back; both go into the byte ledger."""
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
        if self.robust_aggregation != "mean":
            teacher, valid = aggregation.robust_reduce(
                means, counts > 0, self.robust_aggregation,
                trim_frac=self.trim_frac)
        else:
            if count_weighted:
                w = counts[..., None]
            else:
                w = (counts > 0).to(torch.float32)[..., None]
            if self.num_edges > 1:
                shards = self._shards(int(means.shape[0]))
                num = sum(torch.sum((means * w)[sl], dim=0) for sl in shards)
                den = sum(torch.sum(w[sl], dim=0) for sl in shards)
            else:
                num = torch.sum(means * w, dim=0)
                den = torch.sum(w, dim=0)
            teacher = num / torch.clamp_min(den, 1.0)
            valid = torch.sum(counts, dim=0) > 0
        reporting = (means.shape[0] if uploaded_rows is None
                     else int(np.asarray(uploaded_rows, bool).sum()))
        self.bytes_received += reporting * means[0].numel() * 4
        self.bytes_broadcast += teacher.numel() * 4
        return teacher, valid
