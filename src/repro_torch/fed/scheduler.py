"""Round scheduler, sync mode: the lockstep Algorithm-1 phase order.

Each round runs five phases in order,

    local_train ──▶ report ──▶ aggregate ──▶ distill ──▶ eval

each timed on the host clock into ``RoundLog.phase_s`` (every phase ends
in a host read of its results, so the time covers the device work). The
report phase draws the round's proxy batch from the server's rng, collects
every client's logits and ID mask, and ingests them into the server. The
proxy batch, the reports and the teacher stay on the clients' device from
report to distill; only the ID count and the byte ledger are read back.
This is ``repro.fed.scheduler.RoundScheduler`` under ``round_mode="sync"``;
overlap mode, per-cohort nodes, the simulated straggler clock, faults and
the watchdog are not ported yet (ROADMAP queue A item 6), so
``sim_finish_s``/``served_model_age_s`` stay 0.0.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.protocol import RoundLog

ROUND_MODES = ("sync", "overlap")
# the five phase names, in intra-round dependency order
PHASE_ORDER = ("local_train", "report", "aggregate", "distill", "eval")


def resolve_round_mode(mode: Optional[str]) -> str:
    """``auto`` → the ``REPRO_ROUND_MODE`` env var if set, else ``sync``."""
    if mode in (None, "auto"):
        env = os.environ.get("REPRO_ROUND_MODE")
        mode = env if env not in (None, "", "auto") else "sync"
    if mode not in ROUND_MODES:
        raise ValueError(f"unknown round_mode {mode!r}; known: auto, "
                         + ", ".join(ROUND_MODES))
    return mode


class _RoundState:
    """Mutable state threaded between one round's phases."""

    def __init__(self, r: int):
        self.r = r
        self.idx = None             # proxy indices / batch / owners
        self.px = None
        self.teacher = None         # aggregation outputs
        self.valid = None
        self.local_losses: List[float] = []
        self.distill_losses: List[float] = []
        self.id_frac = 1.0
        self.mean_staleness = 0.0
        self.accs: List[float] = []
        self.phase_s = {}


class RoundScheduler:
    """Executes rounds phase by phase over an engine/server pair."""

    def __init__(self, engine, server, cfg, x_test, y_test):
        self.mode = resolve_round_mode(cfg.round_mode)
        if self.mode != "sync":
            raise NotImplementedError(
                "round_mode='overlap' is not ported yet: ROADMAP queue A "
                "item 6 (the full scheduler)")
        self.engine = engine
        self.server = server
        self.cfg = cfg
        self.x_test = x_test
        self.y_test = y_test
        self.phases = PHASE_ORDER

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
        st.idx = self.server.select_indices(cfg.proxy_batch)
        # the round's proxy batch goes to the device once, for report and
        # distill alike
        st.px = torch.as_tensor(self.server.proxy.x[st.idx],
                                dtype=torch.float32, device=self.engine.device)
        powner = self.server.proxy.owner[st.idx]
        logits, masks = self.engine.phase_report(st.px, powner)
        # ID fraction over every (client, sample) pair of the round: an
        # exact count over the pair count, as numpy's mean of a bool array
        st.id_frac = int(masks.sum()) / masks.numel()
        self.server.ingest_reports(st.r, logits, masks)

    def _phase_aggregate(self, st: _RoundState) -> None:
        st.teacher, st.valid, st.mean_staleness = self.server.aggregate_round(
            st.r)

    def _phase_distill(self, st: _RoundState) -> None:
        cfg = self.cfg
        w = st.valid.to(torch.float32)
        st.distill_losses = self.engine.phase_distill(
            st.px, st.teacher, w, cfg.distill_epochs, cfg.batch_size)

    def _phase_eval(self, st: _RoundState) -> None:
        st.accs = self.engine.phase_eval(self.x_test, self.y_test)

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
            scrubbed_rows=self.server.pop_scrubbed(st.r),
        )
