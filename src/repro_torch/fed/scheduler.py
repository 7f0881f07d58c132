"""Round scheduler, sync mode: the lockstep Algorithm-1 phase order.

Each round runs the phases of its method (``round_phases``) in order,

    local_train ──▶ report ──▶ aggregate ──▶ distill ──▶ eval

with a ``server_distill`` phase before distill for FedDF and only
``local_train ──▶ eval`` for independent learning, each timed on the host
clock into ``RoundLog.phase_s`` (every phase ends in a host read of its
results, so the time covers the device work). The report phase draws the
round's proxy batch from the server's rng, collects every client's logits
and ID mask, and ingests them into the server; the data-free methods
(FKD, PLS) report class-wise mean logits instead and distill on their
private data. The proxy batch, the reports and the teacher stay on the
clients' device from report to distill; only the ID count and the byte
ledger are read back. This is ``repro.fed.scheduler.RoundScheduler`` under
``round_mode="sync"``; overlap mode, per-cohort nodes, the simulated
straggler clock, faults and the watchdog are not ported yet (ROADMAP queue
A item 6), so ``sim_finish_s``/``served_model_age_s`` stay 0.0.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.protocol import RoundLog
from repro_torch.data.synthetic import sample_tensor
from repro_torch.fed.faults import validate_fault_config

ROUND_MODES = ("sync", "overlap")
# the reference's simulated arrival processes (repro.fed.clock)
ARRIVAL_PROCESSES = ("static", "poisson", "bursty")
# the five phase names, in intra-round dependency order
PHASE_ORDER = ("local_train", "report", "aggregate", "distill", "eval")


def round_phases(method) -> Tuple[str, ...]:
    """The phases one round of ``method`` runs, in order."""
    if method.name == "indlearn":  # no collaboration: train, then measure
        return ("local_train", "eval")
    if method.server_distill:
        # FedDF: the server student trains on the fused teacher before the
        # clients distill from it
        return ("local_train", "report", "aggregate", "server_distill",
                "distill", "eval")
    return PHASE_ORDER


def resolve_round_mode(mode: Optional[str]) -> str:
    """``auto`` → the ``REPRO_ROUND_MODE`` env var if set, else ``sync``."""
    if mode in (None, "auto"):
        env = os.environ.get("REPRO_ROUND_MODE")
        mode = env if env not in (None, "", "auto") else "sync"
    if mode not in ROUND_MODES:
        raise ValueError(f"unknown round_mode {mode!r}; known: auto, "
                         + ", ".join(ROUND_MODES))
    return mode


def validate_config(cfg) -> None:
    """Fail fast on an inconsistent scheduler config (FedConfig-like):
    ``repro.fed.scheduler.validate_config``, knob for knob, so the port
    refuses what the reference refuses even where it has not ported the
    knob's feature yet."""
    resolve_round_mode(cfg.round_mode)
    if cfg.max_inflight < 1:
        raise ValueError(
            f"max_inflight must be >= 1 (1 = lockstep), got "
            f"{cfg.max_inflight!r}")
    if cfg.straggler_factor < 1.0:
        raise ValueError(
            f"straggler_factor must be >= 1.0 (1.0 = homogeneous fleet), "
            f"got {cfg.straggler_factor!r}")
    f = cfg.participation_fraction
    if not 0.0 < f <= 1.0:
        raise ValueError(
            f"participation_fraction must be in (0, 1], got {f!r}")
    if cfg.arrival_process not in ARRIVAL_PROCESSES:
        raise ValueError(
            f"unknown arrival_process {cfg.arrival_process!r}; known: "
            + ", ".join(ARRIVAL_PROCESSES))
    if cfg.arrival_spread < 0.0:
        raise ValueError(
            f"arrival_spread must be >= 0, got {cfg.arrival_spread!r}")
    if cfg.arrival_bursts < 1:
        raise ValueError(
            f"arrival_bursts must be >= 1, got {cfg.arrival_bursts!r}")
    for knob in ("churn_prob", "dropout_prob"):
        v = getattr(cfg, knob)
        if not 0.0 <= v < 1.0:
            raise ValueError(f"{knob} must be in [0, 1), got {v!r}")
    if cfg.max_pending_reports < 0:
        raise ValueError(
            f"max_pending_reports must be >= 0 (0 = unbounded), got "
            f"{cfg.max_pending_reports!r}")
    validate_fault_config(cfg.fault_mode, cfg.fault_prob, cfg.byzantine_frac,
                          cfg.fault_start, cfg.fault_duration)
    if cfg.watchdog_max_rollbacks < 0:
        raise ValueError(
            f"watchdog_max_rollbacks must be >= 0, got "
            f"{cfg.watchdog_max_rollbacks!r}")
    if cfg.watchdog_acc_drop <= 0.0:
        raise ValueError(
            f"watchdog_acc_drop must be > 0, got {cfg.watchdog_acc_drop!r}")
    if cfg.watchdog_loss_factor <= 1.0:
        raise ValueError(
            f"watchdog_loss_factor must be > 1, got "
            f"{cfg.watchdog_loss_factor!r}")


class _RoundState:
    """Mutable state threaded between one round's phases."""

    def __init__(self, r: int):
        self.r = r
        self.idx = None             # proxy indices / batch / owners
        self.px = None
        self.teacher = None         # aggregation outputs
        self.valid = None
        self.means_counts = None    # data-free reports and their fusion
        self.teacher_by_class = None
        self.valid_by_class = None
        self.local_losses: List[float] = []
        self.distill_losses: List[float] = []
        self.id_frac = 1.0
        self.mean_staleness = 0.0
        self.accs: List[float] = []
        self.phase_s = {}
        self.server_distill_loss = 0.0   # FedDF ensemble server
        self.server_student_acc = None


class RoundScheduler:
    """Executes rounds phase by phase over an engine/server pair."""

    def __init__(self, engine, server, method, cfg, x_test, y_test):
        self.mode = resolve_round_mode(cfg.round_mode)
        if self.mode != "sync":
            raise NotImplementedError(
                "round_mode='overlap' is not ported yet: ROADMAP queue A "
                "item 6 (the full scheduler)")
        self.engine = engine
        self.server = server
        self.method = method
        self.cfg = cfg
        self.x_test = x_test
        self.y_test = y_test
        self.phases = round_phases(method)

    def run_rounds(self, start: int, count: int,
                   progress: Optional[Callable[[RoundLog], None]] = None
                   ) -> List[RoundLog]:
        """Execute rounds ``[start, start + count)``."""
        logs = []
        for r in range(start, start + count):
            st = _RoundState(r)
            for phase in self.phases:
                t0 = time.perf_counter()
                getattr(self, "_phase_" + phase)(st)
                st.phase_s[phase] = time.perf_counter() - t0
            log = self._finish_round(st)
            logs.append(log)
            if progress:
                progress(log)
        return logs

    # --------------------------------------------------------- phase bodies
    def _phase_local_train(self, st: _RoundState) -> None:
        cfg = self.cfg
        st.local_losses = self.engine.phase_local_train(cfg.local_epochs,
                                                        cfg.batch_size)

    def _phase_report(self, st: _RoundState) -> None:
        cfg = self.cfg
        if self.method.data_free:  # FKD/PLS upload class-wise means
            st.means_counts = self.engine.phase_classwise_report()
            return
        st.idx = self.server.select_indices(cfg.proxy_batch)
        # the round's proxy batch goes to the device once, for report and
        # distill alike
        st.px = sample_tensor(self.server.proxy.x[st.idx],
                              self.engine.device)
        powner = self.server.proxy.owner[st.idx]
        logits, masks = self.engine.phase_report(st.px, powner)
        # ID fraction over every (client, sample) pair of the round: an
        # exact count over the pair count, as numpy's mean of a bool array
        st.id_frac = int(masks.sum()) / masks.numel()
        self.server.ingest_reports(st.r, logits, masks)

    def _phase_aggregate(self, st: _RoundState) -> None:
        if self.method.data_free:
            st.teacher_by_class, st.valid_by_class = \
                self.server.aggregate_classwise(
                    st.means_counts, count_weighted=self.method.count_weighted,
                    round_idx=st.r)
            st.means_counts = None
            return
        st.teacher, st.valid, st.mean_staleness = self.server.aggregate_round(
            st.r, sharpen=self.method.sharpen,
            entropy_filter=self.method.server_filter)

    def _phase_server_distill(self, st: _RoundState) -> None:
        """FedDF: train the server's student on the round's proxy batch
        against the fused teacher the clients are about to distill from."""
        cfg = self.cfg
        epochs = cfg.server_distill_epochs or cfg.distill_epochs
        st.server_distill_loss = self.server.ensemble_distill(
            st.px, st.teacher, st.valid, epochs=epochs,
            batch_size=cfg.batch_size)

    def _phase_distill(self, st: _RoundState) -> None:
        cfg = self.cfg
        if self.method.data_free:
            st.distill_losses = self.engine.phase_distill_private(
                st.teacher_by_class, st.valid_by_class, cfg.distill_epochs,
                cfg.batch_size)
            return
        w = st.valid.to(torch.float32)
        st.distill_losses = self.engine.phase_distill(
            st.px, st.teacher, w, cfg.distill_epochs, cfg.batch_size)

    def _phase_eval(self, st: _RoundState) -> None:
        st.accs = self.engine.phase_eval(self.x_test, self.y_test)
        if self.server.student is not None:
            st.server_student_acc = self.server.evaluate_student(
                self.x_test, self.y_test)

    def _finish_round(self, st: _RoundState) -> RoundLog:
        return RoundLog(
            round=st.r,
            mean_acc=float(np.mean(st.accs)),
            accs=st.accs,
            local_loss=float(np.mean(st.local_losses)),
            distill_loss=(float(np.mean(st.distill_losses))
                          if st.distill_losses else 0.0),
            id_fraction=st.id_frac,
            bytes_up=self.server.bytes_received,
            bytes_down=self.server.bytes_broadcast,
            wall_s=sum(st.phase_s.values()),
            mean_staleness=st.mean_staleness,
            phase_s=dict(st.phase_s),
            server_distill_loss=st.server_distill_loss,
            server_student_acc=st.server_student_acc,
            scrubbed_rows=self.server.pop_scrubbed(st.r),
        )
