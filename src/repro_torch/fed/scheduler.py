"""Phase-graph round scheduler: lockstep (sync) and overlapping (overlap).

The counterpart of ``repro.fed.scheduler``. A round is a chain of phase
nodes with declared data dependencies,

    local_train ──▶ report ──▶ aggregate ──▶ distill ──▶ eval

(a ``server_distill`` node before distill for FedDF, only ``local_train
──▶ eval`` for independent learning), and a deterministic executor runs
whatever is ready. ``FedConfig.round_mode`` picks the dependency set:

``sync``
    ``local_train(r)`` also waits on ``eval(r-1)``: a barrier between
    rounds, the lockstep Algorithm-1 order.

``overlap``
    ``local_train(r)`` waits on ``eval(r - max_inflight)`` instead, so up
    to ``max_inflight`` rounds are in flight: round r+1 trains and reports
    while round r aggregates and distills, sampled-out clients' knowledge
    draining through the server's staleness buffer (reports are ingested
    in round order). The ready-node policy runs client-side front phases
    (``local_train``, ``report``) before drain phases, oldest round first.

Overlap is a host order of nodes, priced on the simulated timeline; the
device work of two nodes never runs at once. Every node is timed on the
host (``RoundLog.phase_s``; on a CUDA engine the node ends in a device
synchronize, so its time covers its device work) and priced onto the
simulated straggler timeline (``fed.clock``): clients run in parallel at
deterministic speeds, the server is one serial resource, and
``RoundLog.sim_finish_s`` records when the round retires there.
``sim_phase_costs`` replaces the measured seconds with fixed ones (keys
``phase`` or ``"phase@cohort"``), which makes the timeline deterministic.

Per round the scheduler draws the participants (``sample_participants``,
then churn), drops mid-round dropouts before the report, admits reports
in simulated-arrival order under ``max_pending_reports``, and computes
the ID fraction over the reporting clients from integer counts. With
``fault_mode`` set, a ``FaultInjector`` corrupts the faulty clients'
reports before admission (class-wise payloads before aggregation);
clients the server has quarantined sit the round out, unless that would
empty it.

**Concurrent cohorts** (``concurrent_cohorts=True``) key the client-side
nodes ``(phase, round, cohort)`` so the cohorts of a mixed zoo pipeline
independently; aggregation stays a global barrier.

``REPRO_ROUND_MODE`` fills in for ``round_mode="auto"``. The divergence
watchdog and ``snapshot``/``restore`` (ROADMAP queue A item 8: the
watchdog rolls back to a snapshot) are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.protocol import RoundLog
from repro_torch.data.synthetic import sample_tensor
from repro_torch.fed.clock import (ARRIVAL_PROCESSES, SimTimeline,
                                   arrival_offsets, client_speeds,
                                   dropout_mask, online_mask)
from repro_torch.fed.faults import FaultInjector, validate_fault_config
from repro_torch.fed.participation import sample_participants

ROUND_MODES = ("sync", "overlap")
# the five phase names, in intra-round dependency order
PHASE_ORDER = ("local_train", "report", "aggregate", "distill", "eval")
# client-side phases that admit new rounds into the pipeline; the rest
# drain old ones
FRONT_PHASES = frozenset({"local_train", "report"})
# phases priced on client lanes of the simulated timeline ("aggregate" is
# the serial server, "eval" is free measurement)
CLIENT_PHASES = frozenset({"local_train", "report", "distill"})


def round_phases(method) -> Tuple[str, ...]:
    """The phase nodes one round of ``method`` contributes to the graph."""
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
    ``repro.fed.scheduler.validate_config``, knob for knob."""
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
    """Mutable state threaded between one round's phase nodes."""

    def __init__(self, r: int):
        self.r = r
        self.part: Optional[np.ndarray] = None   # participants (None: all)
        self.kw: Dict = {}          # engine kwargs ({} at fraction 1)
        self.idx = None             # proxy indices, batch (on the device)
        self.px = None
        self.powner = None
        self.means_counts = None    # data-free report payload
        self.teacher = None         # aggregation outputs
        self.valid = None
        self.teacher_by_class = None
        self.valid_by_class = None
        self.local_losses: List[float] = []
        self.distill_losses: List[float] = []
        self.id_frac = 1.0
        self.mean_staleness = 0.0
        self.accs: Optional[List[float]] = None
        self.phase_s: Dict[str, float] = {}
        self.sim_finish_s = 0.0
        # (logits, masks) between the report body and the ingest event
        # that follows its pricing, within one node execution
        self.report_payload = None
        # concurrent cohorts: the round's reporting participants (st.part
        # minus dropout and admission overflow; a cohort that has not
        # trained yet still needs st.part), whether participation was
        # drawn, and the report rows the cohorts' nodes accumulate until
        # the round's last report node ingests them
        self.rpart: Optional[np.ndarray] = None
        self.sampled = False
        self.reports_pending: Optional[int] = None
        self.report_logits = None
        self.report_masks = None
        # each client's simulated report arrival, pinned when its report
        # node is priced (later nodes may advance the lanes before ingest)
        self.report_arrival: Optional[np.ndarray] = None
        self.server_distill_loss = 0.0   # FedDF ensemble server
        self.server_student_acc = None


class RoundScheduler:
    """Executes the round phase graph over an engine/server pair.

    One scheduler owns one contiguous run of rounds: the straggler
    timeline, the execution trace (``trace``, node keys in host order) and
    the in-flight round states live here. ``sim_phase_costs`` prices the
    timeline with fixed per-phase costs (deterministic) instead of the
    measured host seconds."""

    def __init__(self, engine, server, method, cfg, x_test, y_test, *,
                 sim_phase_costs: Optional[Dict[str, float]] = None):
        validate_config(cfg)
        if cfg.watchdog:
            raise NotImplementedError(
                "the divergence watchdog is not ported yet: ROADMAP queue A "
                "item 8 (state and service: it rolls back to a snapshot)")
        self.engine = engine
        self.server = server
        self.method = method
        self.cfg = cfg
        self.x_test = x_test
        self.y_test = y_test
        self.mode = resolve_round_mode(cfg.round_mode)
        # sync IS the overlap graph at pipeline depth 1
        self.max_inflight = cfg.max_inflight if self.mode == "overlap" else 1
        self.phases = round_phases(method)
        self.sim_phase_costs = sim_phase_costs
        self.timeline = SimTimeline(client_speeds(
            engine.num_clients, seed=cfg.seed,
            straggler_factor=cfg.straggler_factor))
        self._concurrent = bool(cfg.concurrent_cohorts)
        self._cohort_pos: Optional[List[np.ndarray]] = None
        if self._concurrent:
            if not hasattr(engine, "cohort_positions"):
                raise TypeError(
                    f"concurrent_cohorts=True needs an engine with the "
                    f"per-cohort interface (cohort_positions/cohort_*); "
                    f"{type(engine).__name__} has none")
            self._cohort_pos = [np.asarray(p, int)
                                for p in engine.cohort_positions()]
        # node keys in host execution order: (phase, round), or (phase,
        # round, cohort) for a concurrent cohort's client node
        self.trace: List[Tuple] = []
        self._sim_end: Dict[Tuple, float] = {}
        self._order = {p: i for i, p in enumerate(self.phases)}
        self._window: Optional[Tuple[int, int]] = None
        self._states: Dict[int, _RoundState] = {}
        self._nodes: Dict[Tuple, List] = {}
        self._pending: set = set()
        self._done: set = set()
        self.logs: List[RoundLog] = []
        self.completed = 0
        # sim time of the last retirement: the served model's freshness
        # reference (service start = 0.0)
        self._last_retire_s = 0.0
        self._cuda = torch.device(engine.device).type == "cuda"
        # the payload-fault trace, built only when a fault mode is set
        self.faults: Optional[FaultInjector] = None
        if cfg.fault_mode != "none":
            self.faults = FaultInjector(
                engine.num_clients, mode=cfg.fault_mode, seed=cfg.seed,
                fault_prob=cfg.fault_prob, byzantine_frac=cfg.byzantine_frac,
                fault_start=cfg.fault_start,
                fault_duration=cfg.fault_duration, device=engine.device)

    # ------------------------------------------------------------ the graph
    def _build_deps(self, rounds) -> Dict[Tuple, List]:
        """Nodes and their dependencies for a contiguous round window.

        A dep is ``(phase, round[, cohort], kind)``: ``data`` deps gate
        host execution and the simulated timeline; ``order`` deps (the same
        phase of the previous round) pin the host order — server rng
        draws, report ingestion and log assembly go in round order — and
        cost nothing on the timeline. Concurrent cohorts key client nodes
        per cohort: data stays within a cohort until the global aggregate,
        and cohort c's ``local_train(r)`` waits on its own ``distill(r -
        max_inflight)``, with an order edge to ``eval(r - max_inflight)``."""
        window = set(rounds)
        nodes: Dict[Tuple, List] = {}
        if not self._concurrent:
            for r in rounds:
                for i, p in enumerate(self.phases):
                    deps = []
                    if i > 0:  # intra-round chain: the data flow
                        deps.append((self.phases[i - 1], r, "data"))
                    if (r - 1) in window:  # host-order edge
                        deps.append((p, r - 1, "order"))
                    if i == 0 and (r - self.max_inflight) in window:
                        # admission: round r enters once round
                        # r - max_inflight has retired
                        deps.append((self.phases[-1], r - self.max_inflight,
                                     "data"))
                    nodes[(p, r)] = deps
            return nodes
        ncoh = len(self._cohort_pos)
        client = [p for p in self.phases if p in CLIENT_PHASES]
        last_client = client[-1]  # the cohort's last phase of a round
        for r in rounds:
            for i, p in enumerate(self.phases):
                prev = self.phases[i - 1] if i > 0 else None
                if p not in CLIENT_PHASES:  # global: aggregate/sdist/eval
                    deps = []
                    if prev is not None:
                        if prev in CLIENT_PHASES:  # barrier on every cohort
                            deps += [(prev, r, cj, "data")
                                     for cj in range(ncoh)]
                        else:
                            deps.append((prev, r, "data"))
                    if (r - 1) in window:
                        deps.append((p, r - 1, "order"))
                    nodes[(p, r)] = deps
                    continue
                for ci in range(ncoh):
                    deps = []
                    if prev is not None:
                        # a client phase reads its own cohort's previous
                        # client phase, or the global teacher
                        deps.append((prev, r, ci, "data")
                                    if prev in CLIENT_PHASES
                                    else (prev, r, "data"))
                    if (r - 1) in window:
                        deps.append((p, r - 1, ci, "order"))
                        if p == "report":
                            # every cohort of round r-1 reports before any
                            # cohort of round r: proxy draws and ingestion
                            # stay round-ordered
                            deps += [(p, r - 1, cj, "order")
                                     for cj in range(ncoh) if cj != ci]
                    if p == client[0] and (r - self.max_inflight) in window:
                        q = r - self.max_inflight
                        deps.append((last_client, q, ci, "data"))
                        deps.append((self.phases[-1], q, "order"))
                    nodes[(p, r, ci)] = deps
        return nodes

    # ------------------------------------------------------- the event loop
    def begin(self, start: int, count: int) -> None:
        """Open the round window ``[start, start + count)``; the timeline,
        trace and node finish times carry over from an earlier window."""
        if self._pending:
            raise RuntimeError(
                f"cannot begin a new round window: {len(self._pending)} "
                "nodes of the current window are still pending")
        rounds = range(start, start + count)
        self._window = (start, count)
        self._states = {r: _RoundState(r) for r in rounds}
        self._nodes = self._build_deps(rounds)
        self._pending = set(self._nodes)
        self._done = set()
        self.logs = []
        self.completed = 0

    def has_pending(self) -> bool:
        """True while the open window still has nodes to execute."""
        return bool(self._pending)

    def step(self) -> Tuple[str, int, Optional[RoundLog]]:
        """Execute the next ready node. Returns ``(phase, round, log)``,
        ``log`` the finished ``RoundLog`` when the node retired its
        round."""
        if not self._pending:
            raise RuntimeError("no pending nodes — call begin() first")
        ready = [
            k for k in self._pending
            if all(d[1] not in self._states or d[:-1] in self._done
                   for d in self._nodes[k])
        ]
        # front phases before drain phases, oldest round first, intra-round
        # order next, cohort index last: under sync with one cohort exactly
        # one node is ever ready
        key = min(ready, key=lambda k: (k[0] not in FRONT_PHASES, k[1],
                                        self._order[k[0]],
                                        k[2] if len(k) > 2 else -1))
        phase, r = key[0], key[1]
        self._run_node(key, self._states[r], self._nodes[key])
        self._pending.remove(key)
        self._done.add(key)
        log = None
        if phase == self.phases[-1]:
            log = self._finish_round(self._states[r])
            self.logs.append(log)
            self.completed += 1
            self._retire(r)
        return phase, r, log

    def drain(self, progress: Optional[Callable[[RoundLog], None]] = None
              ) -> List[RoundLog]:
        """Run the open window to completion."""
        while self._pending:
            _, _, log = self.step()
            if log is not None and progress:
                progress(log)
        return self.logs

    def run_rounds(self, start: int, count: int,
                   progress: Optional[Callable[[RoundLog], None]] = None
                   ) -> List[RoundLog]:
        """Execute rounds ``[start, start + count)`` through the graph."""
        self.begin(start, count)
        return self.drain(progress)

    def _retire(self, r: int) -> None:
        """Drop a retired round's bookkeeping. Finish times stay until they
        are ``max_inflight`` rounds old (``eval(q)`` gates
        ``local_train(q + max_inflight)``)."""
        del self._states[r]
        # the round's outlier scores are the watchdog's (ROADMAP queue A
        # item 8); dropped here so they do not pile up
        self.server.pop_round_outlier(r)
        self._done -= {k for k in self._done if k[1] == r}
        horizon = r - self.max_inflight
        for key in [k for k in self._sim_end if k[1] <= horizon]:
            del self._sim_end[key]

    def snapshot(self, *, logs_tail: Optional[int] = None):
        raise NotImplementedError(
            "RoundScheduler.snapshot is not ported yet: ROADMAP queue A "
            "item 8 (state and service, fed/state.py)")

    def restore(self, state) -> None:
        raise NotImplementedError(
            "RoundScheduler.restore is not ported yet: ROADMAP queue A "
            "item 8 (state and service, fed/state.py)")

    # ------------------------------------------------------- node execution
    def _run_node(self, key: Tuple, st: _RoundState, deps) -> None:
        phase = key[0]
        self.trace.append(key)
        t0 = time.perf_counter()
        if len(key) > 2:  # a concurrent cohort's client node
            getattr(self, "_phase_" + phase + "_cohort")(st, key[2])
        else:
            getattr(self, "_phase_" + phase)(st)
        if self._cuda:
            # the node's device work belongs to its time
            torch.cuda.synchronize(self.engine.device)
        dt = time.perf_counter() - t0
        st.phase_s[phase] = st.phase_s.get(phase, 0.0) + dt
        self._account(key, st, deps, dt)
        if phase == "report":
            # ingestion is an event after the node's pricing, so each
            # report's simulated arrival is known and admission can replay
            # them in arrival order
            t0 = time.perf_counter()
            self._ingest_reports(st)
            st.phase_s[phase] += time.perf_counter() - t0

    def _report_part(self, st: _RoundState):
        """The round's reporting participants (``st.rpart`` under
        concurrent cohorts, ``st.part`` otherwise)."""
        return st.rpart if st.rpart is not None else st.part

    def _per_client_cost(self, phase: str, epart) -> Optional[np.ndarray]:
        """Per-client base costs of an engine-wide client node when
        ``sim_phase_costs`` prices cohorts one by one (``"phase@cohort"``
        keys), so the serial graph charges each architecture its own
        cost."""
        costs = self.sim_phase_costs
        if costs is None or not any("@" in k for k in costs):
            return None
        if self._cohort_pos is None:
            if not hasattr(self.engine, "cohort_positions"):
                return None
            self._cohort_pos = [np.asarray(p, int)
                                for p in self.engine.cohort_positions()]
        per = np.zeros((self.engine.num_clients,), float)
        for ci, pos in enumerate(self._cohort_pos):
            c = costs.get(f"{phase}@{ci}", costs.get(phase, 0.0))
            n = len(pos) if epart is None else int(epart[pos].sum())
            per[pos] = c / max(n, 1)
        return per

    def _account(self, key: Tuple, st: _RoundState, deps,
                 measured_s: float) -> None:
        """Price the node onto the simulated straggler timeline."""
        phase = key[0]
        ready_s = max((self._sim_end.get(d[:-1], 0.0)
                       for d in deps if d[-1] == "data"),
                      default=0.0)
        costs = self.sim_phase_costs
        if costs is None:
            base = measured_s
        elif len(key) > 2:
            base = costs.get(f"{phase}@{key[2]}", costs.get(phase, 0.0))
        else:
            base = costs.get(phase, 0.0)
        if phase in CLIENT_PHASES:
            epart = (st.part if phase == "local_train"
                     else self._report_part(st))
            if len(key) > 2:  # this node covers one cohort's lanes
                pos = self._cohort_pos[key[2]]
                lane_part = np.zeros((self.engine.num_clients,), bool)
                lane_part[pos] = True if epart is None else epart[pos]
                n = int(lane_part.sum())
                per_client = base / max(n, 1)
            else:
                lane_part = epart
                n = (self.engine.num_clients if epart is None
                     else int(np.asarray(epart, bool).sum()))
                per_client = self._per_client_cost(phase, epart)
                if per_client is None:
                    per_client = base / max(n, 1)
            # the host ran the participants back to back; deployed clients
            # run in parallel, each paying its share times its straggler
            # speed. Arrival offsets gate local_train, the round's entry.
            offsets = None
            if phase == "local_train":
                offsets = arrival_offsets(
                    self.engine.num_clients, st.r, seed=self.cfg.seed,
                    process=self.cfg.arrival_process,
                    spread=self.cfg.arrival_spread,
                    bursts=self.cfg.arrival_bursts)
            end = self.timeline.client_phase(lane_part, per_client,
                                             ready_s, offsets=offsets)
            if phase == "report":
                if st.report_arrival is None:
                    st.report_arrival = np.zeros(
                        (self.engine.num_clients,), float)
                ids = (np.arange(self.engine.num_clients)
                       if lane_part is None else np.flatnonzero(lane_part))
                st.report_arrival[ids] = self.timeline.client_free[ids]
        elif phase in ("aggregate", "server_distill"):
            end = self.timeline.server_phase(base, ready_s)
        else:  # eval: simulation-side measurement, free on the timeline
            end = ready_s
        end = float(end)
        self._sim_end[key] = end
        st.sim_finish_s = end

    # --------------------------------------------------------- phase bodies
    def _draw_participants(self, st: _RoundState) -> None:
        """Participation sampling, then churn, then quarantine, for one
        round."""
        cfg = self.cfg
        st.sampled = True
        if cfg.participation_fraction < 1.0:
            sizes = None
            if cfg.participation_policy == "weighted":
                sizes = np.asarray([len(c.y) for c in self.engine.clients],
                                   np.int64)
            st.part = sample_participants(
                st.r, self.engine.num_clients, cfg.participation_fraction,
                cfg.participation_policy, seed=cfg.seed, data_sizes=sizes)
        # an offline client sits the round out and drains through the
        # staleness buffer like a sampled-out one
        online = online_mask(self.engine.num_clients, st.r, seed=cfg.seed,
                             churn=cfg.churn_prob)
        if online is not None:
            st.part = online if st.part is None else (st.part & online)
        # quarantined clients sit out like sampled-out ones, unless that
        # would empty the round
        q = self.server.quarantine_mask(st.r)
        if q is not None:
            keep = ~q if st.part is None else (st.part & ~q)
            if keep.any():
                st.part = keep
        if st.part is not None:
            st.kw = {"participants": st.part}

    def _phase_local_train(self, st: _RoundState) -> None:
        cfg = self.cfg
        self._draw_participants(st)
        st.local_losses = self.engine.phase_local_train(
            cfg.local_epochs, cfg.batch_size, **st.kw)

    def _phase_local_train_cohort(self, st: _RoundState, ci: int) -> None:
        cfg = self.cfg
        if not st.sampled:  # the round's draw, at its first cohort node
            self._draw_participants(st)
        losses = self.engine.cohort_local_train(
            ci, cfg.local_epochs, cfg.batch_size, participants=st.part)
        if not st.local_losses:
            st.local_losses = [0.0] * self.engine.num_clients
        for j, p in enumerate(self._cohort_pos[ci]):
            st.local_losses[p] = losses[j]

    def _draw_proxy(self, st: _RoundState) -> None:
        """The round's proxy batch, on the engine's device once for report
        and distill alike."""
        st.idx = self.server.select_indices(self.cfg.proxy_batch)
        st.px = sample_tensor(self.server.proxy.x[st.idx],
                              self.engine.device)
        st.powner = self.server.proxy.owner[st.idx]

    def _phase_report(self, st: _RoundState) -> None:
        cfg = self.cfg
        # mid-round dropout: these clients trained but vanish before
        # reporting, and ride the staleness buffer for the rest of the
        # round
        dropped = dropout_mask(self.engine.num_clients, st.r, seed=cfg.seed,
                               dropout=cfg.dropout_prob)
        if dropped is not None:
            st.part = (~dropped if st.part is None else (st.part & ~dropped))
            st.kw = {"participants": st.part}
        if self.method.data_free:  # FKD/PLS upload class-wise means
            st.means_counts = self.engine.phase_classwise_report(**st.kw)
            return
        self._draw_proxy(st)
        # computed here, ingested after the node's pricing
        st.report_payload = self.engine.phase_report(st.px, st.powner,
                                                     **st.kw)

    def _phase_report_cohort(self, st: _RoundState, ci: int) -> None:
        cfg = self.cfg
        num = self.engine.num_clients
        pos = self._cohort_pos[ci]
        if st.reports_pending is None:  # the round's first report node
            st.reports_pending = len(self._cohort_pos)
            # dropout drawn once a round; cohorts that have not trained yet
            # still see the training mask in st.part
            dropped = dropout_mask(num, st.r, seed=cfg.seed,
                                   dropout=cfg.dropout_prob)
            if dropped is not None:
                st.rpart = (~dropped if st.part is None
                            else (st.part & ~dropped))
        part = self._report_part(st)
        if self.method.data_free:
            mc = self.engine.cohort_classwise_report(ci, participants=part)
            if st.means_counts is None:
                st.means_counts = [None] * num
            for j, p in enumerate(pos):
                st.means_counts[p] = mc[j]
        else:
            if st.idx is None:  # one proxy draw a round, in round order
                self._draw_proxy(st)
            lg, mk = self.engine.cohort_report(ci, st.px, st.powner,
                                               participants=part)
            if st.report_logits is None:
                st.report_logits = torch.zeros(
                    (num,) + tuple(lg.shape[1:]), dtype=torch.float32,
                    device=lg.device)
                st.report_masks = torch.zeros(
                    (num, mk.shape[1]), dtype=torch.bool, device=mk.device)
            pos_d = torch.as_tensor(pos, device=lg.device)
            st.report_logits[pos_d] = lg.to(torch.float32)
            st.report_masks[pos_d] = mk
        st.reports_pending -= 1

    def _ingest_reports(self, st: _RoundState) -> None:
        """Server-side report ingestion, an arrival-ordered event.

        With ``max_pending_reports > 0`` the server admits reports in
        simulated arrival order (each client's report-lane finish, ties by
        client id) while its queue has room; refused clients become
        non-participants for the rest of the round. Under concurrent
        cohorts the rows accumulate over the round's report nodes and are
        ingested once, at its last."""
        if self.method.data_free:
            return
        if st.report_payload is not None:  # serial: same-node handoff
            logits, masks = st.report_payload
            st.report_payload = None
        elif st.report_logits is not None and st.reports_pending == 0:
            logits, masks = st.report_logits, st.report_masks
            st.report_logits = st.report_masks = None
        else:  # concurrent: cohorts still reporting
            return
        cfg = self.cfg
        part = self._report_part(st)
        if self.faults is not None:
            # faulty clients lie about what they send, after training and
            # before the server sees anything (admission and the ID
            # fraction read the corrupted masks)
            logits, masks = self.faults.corrupt_reports(st.r, logits, masks,
                                                        part)
        cap = int(self.server.max_pending_reports)
        if cap > 0:
            ids = (np.arange(self.engine.num_clients)
                   if part is None else np.flatnonzero(part))
            arrival = st.report_arrival[ids]
            ordered = ids[np.lexsort((ids, arrival))]
            admitted_ids = self.server.admit_reports(st.r, ordered)
            if admitted_ids.size < ids.size:
                admitted = np.zeros((self.engine.num_clients,), bool)
                admitted[admitted_ids] = True
                part = admitted
                if self._concurrent:
                    st.rpart = admitted
                else:
                    st.part = admitted
                    st.kw = {"participants": st.part}
        # ID fraction over the clients that reported, from integer counts
        # (numpy's mean of a bool array, exactly)
        if part is None:
            st.id_frac = int(masks.sum()) / masks.numel()
        elif part.any():
            rows = masks[torch.as_tensor(part, device=masks.device)]
            st.id_frac = int(rows.sum()) / rows.numel()
        else:
            st.id_frac = 0.0
        self.server.ingest_reports(st.r, part, st.idx, logits, masks,
                                   decay=cfg.staleness_decay,
                                   entropy_filter=self.method.server_filter)

    def _phase_aggregate(self, st: _RoundState) -> None:
        if self.method.data_free:
            if self.faults is not None:
                # class-wise payloads are untouched between report and
                # aggregate, so the trace acts here, for the serial and the
                # concurrent report paths alike
                st.means_counts = self.faults.corrupt_classwise(
                    st.r, st.means_counts, self._report_part(st))
            st.teacher_by_class, st.valid_by_class = \
                self.server.aggregate_classwise(
                    st.means_counts, count_weighted=self.method.count_weighted,
                    uploaded_rows=self._report_part(st), round_idx=st.r)
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
                cfg.batch_size, **st.kw)
            return
        w = st.valid.to(torch.float32)
        st.distill_losses = self.engine.phase_distill(
            st.px, st.teacher, w, cfg.distill_epochs, cfg.batch_size,
            **st.kw)

    def _phase_distill_cohort(self, st: _RoundState, ci: int) -> None:
        cfg = self.cfg
        part = self._report_part(st)
        if self.method.data_free:
            losses = self.engine.cohort_distill_private(
                ci, st.teacher_by_class, st.valid_by_class,
                cfg.distill_epochs, cfg.batch_size, participants=part)
        else:
            losses = self.engine.cohort_distill(
                ci, st.px, st.teacher, st.valid.to(torch.float32),
                cfg.distill_epochs, cfg.batch_size, participants=part)
        if not st.distill_losses:
            st.distill_losses = [0.0] * self.engine.num_clients
        for j, p in enumerate(self._cohort_pos[ci]):
            st.distill_losses[p] = losses[j]

    def _phase_eval(self, st: _RoundState) -> None:
        st.accs = self.engine.phase_eval(self.x_test, self.y_test)
        if self.server.student is not None:
            st.server_student_acc = self.server.evaluate_student(
                self.x_test, self.y_test)

    def _finish_round(self, st: _RoundState) -> RoundLog:
        # served-model freshness: how long the model this round replaces
        # served (sim seconds since the last retirement); overlap rounds
        # may finish out of order on the timeline, so it clamps at 0
        age = max(0.0, st.sim_finish_s - self._last_retire_s)
        self._last_retire_s = max(self._last_retire_s, st.sim_finish_s)
        part = self._report_part(st)
        newly_q = self.server.pop_quarantined(st.r)
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
            participants=(None if part is None
                          else [int(i) for i in np.flatnonzero(part)]),
            mean_staleness=st.mean_staleness,
            phase_s=dict(st.phase_s),
            sim_finish_s=st.sim_finish_s,
            served_model_age_s=age,
            server_distill_loss=st.server_distill_loss,
            server_student_acc=st.server_student_acc,
            scrubbed_rows=self.server.pop_scrubbed(st.r),
            quarantined=newly_q if newly_q else None,
        )
