"""The port's phase-graph scheduler (``repro_torch.fed.scheduler``).

* Its control plane against the reference's, node for node: both
  packages' ``RoundScheduler`` drive engines that compute nothing (every
  phase returns zeros) and their real servers, on the mixed zoo's three
  cohorts, priced with ``benchmarks/hetero_zoo.py``'s per-cohort fixed
  costs, in sync, overlap and concurrent-cohort mode under participation
  policies, churn, dropout, bursty arrivals and admission: the trace, the
  participants, staleness, ID fraction, ledger and simulated finishes
  equal.
* (The mixed zoo against a live reference run, sync and with concurrent
  cohorts under overlap and participation, is in ``test_torch_cohort.py``,
  where the two reference runs share their compiled steps.)
* The loop and cohort engines bitwise equal under partial participation
  and overlap; sampled-out lanes left bitwise untouched; the round-mode
  switch and the parts that are not ported yet.
"""
import types

import numpy as np
import pytest
import torch

from _torch_parity import HETERO_COSTS
from repro.common.types import FedConfig as RefFedConfig
from repro.core.methods import get_method as ref_get_method
from repro.data.proxy import ProxyData as RefProxyData
from repro.fed.scheduler import RoundScheduler as RefRoundScheduler
from repro.fed.server import Server as RefServer
from repro_torch.common.types import FedConfig
from repro_torch.core.methods import get_method
from repro_torch.core.protocol import run_experiment, run_round
from repro_torch.data.proxy import ProxyData
from repro_torch.fed import simulator
from repro_torch.fed.cohort import CohortEngine
from repro_torch.fed.participation import sample_participants
from repro_torch.fed.scheduler import RoundScheduler, resolve_round_mode
from repro_torch.fed.server import Server

# nine clients in the mixed zoo's three cohorts (cid % 3), ragged sizes
COHORTS = [np.array([0, 3, 6]), np.array([1, 4, 7]), np.array([2, 5, 8])]
SIZES = [40, 55, 30, 60, 45, 35, 50, 65, 25]
K, PROXY = 3, 48


class _NullEngine:
    """The engine interface of either package at no cost: every phase
    returns zeros (reports: zero logits, an ID mask that is all True),
    as numpy arrays (``torch_out=False``, the reference's) or CPU
    tensors (the port's)."""

    def __init__(self, torch_out: bool):
        self.torch_out = torch_out
        self.num_clients = len(SIZES)
        self.clients = [types.SimpleNamespace(y=np.zeros(n)) for n in SIZES]
        self.device = torch.device("cpu")

    def cohort_positions(self):
        return COHORTS

    def _report(self, m, px):
        logits, masks = np.zeros((m, len(px), K), np.float32), \
            np.ones((m, len(px)), bool)
        if self.torch_out:
            return torch.from_numpy(logits), torch.from_numpy(masks)
        return logits, masks

    def phase_local_train(self, epochs, batch_size, participants=None):
        return [0.0] * self.num_clients

    def phase_report(self, px, powner, participants=None):
        return self._report(self.num_clients, px)

    def phase_distill(self, px, teacher, weight, epochs, batch_size,
                      participants=None):
        return [0.0] * self.num_clients

    def phase_eval(self, x_test, y_test):
        return [0.0] * self.num_clients

    def phase_classwise_report(self, participants=None):
        raise AssertionError("no data-free method runs here")

    phase_distill_private = phase_classwise_report

    def cohort_local_train(self, ci, epochs, batch_size, participants=None):
        return [0.0] * len(COHORTS[ci])

    def cohort_report(self, ci, px, powner, participants=None):
        return self._report(len(COHORTS[ci]), px)

    def cohort_distill(self, ci, px, teacher, weight, epochs, batch_size,
                       participants=None):
        return [0.0] * len(COHORTS[ci])


def _proxy():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((PROXY, 5)).astype(np.float32),
            rng.integers(0, K, PROXY).astype(np.int32),
            (np.arange(PROXY) % 9).astype(np.int32))


def _null_run(ref: bool, method: str, kw: dict):
    cfg = (RefFedConfig if ref else FedConfig)(
        num_clients=9, rounds=4, method=method, proxy_batch=16, seed=3,
        **kw)
    server = (RefServer(RefProxyData(*_proxy()), seed=3,
                        max_pending_reports=cfg.max_pending_reports)
              if ref else
              Server(ProxyData(*_proxy()), seed=3,
                     max_pending_reports=cfg.max_pending_reports,
                     device="cpu"))
    sched = (RefRoundScheduler if ref else RoundScheduler)(
        _NullEngine(not ref), server,
        (ref_get_method if ref else get_method)(method), cfg, None, None,
        sim_phase_costs=HETERO_COSTS)
    logs = sched.run_rounds(0, cfg.rounds)
    return [tuple(k) for k in sched.trace], logs


@pytest.mark.parametrize("method", ["edgefd", "indlearn"])
@pytest.mark.parametrize("kw", [
    dict(round_mode="sync"),
    dict(round_mode="sync", concurrent_cohorts=True,
         participation_fraction=0.5, participation_policy="roundrobin"),
    dict(round_mode="overlap", participation_fraction=0.5,
         staleness_decay=0.5),
    dict(round_mode="overlap", max_inflight=3, participation_fraction=0.6,
         participation_policy="weighted", staleness_decay=1.0,
         arrival_process="poisson", arrival_spread=1.5),
    dict(round_mode="overlap", concurrent_cohorts=True,
         participation_fraction=0.7, staleness_decay=0.5, churn_prob=0.2,
         dropout_prob=0.2, max_pending_reports=5, arrival_process="bursty",
         arrival_spread=2.0)],
    ids=["sync", "sync-concurrent-roundrobin", "overlap",
         "overlap-3-weighted-poisson", "overlap-concurrent-heavy"])
def test_control_plane_matches_reference_node_for_node(method, kw):
    ref_trace, ref_logs = _null_run(True, method, kw)
    trace, logs = _null_run(False, method, kw)
    assert trace == ref_trace
    for p, q in zip(logs, ref_logs, strict=True):
        assert (p.participants, p.mean_staleness, p.id_fraction, p.bytes_up,
                p.bytes_down, p.sim_finish_s, p.served_model_age_s) == (
            q.participants, q.mean_staleness, q.id_fraction, q.bytes_up,
            q.bytes_down, q.sim_finish_s, q.served_model_age_s)
    if kw.get("concurrent_cohorts"):
        assert ("local_train", 0, 2) in trace


def _run(engine, **kw):
    cfg = FedConfig(num_clients=6, rounds=3, zoo="mixed", engine=engine,
                    seed=0, **kw)
    return simulator.run(cfg, n_train=600, n_test=100, device="cpu",
                         sim_phase_costs=HETERO_COSTS).rounds


@pytest.mark.parametrize("kw", [
    dict(participation_fraction=0.5, staleness_decay=0.5,
         round_mode="overlap"),
    dict(participation_fraction=0.5, participation_policy="roundrobin",
         round_mode="overlap", concurrent_cohorts=True, dropout_prob=0.2)],
    ids=["overlap", "overlap-concurrent-dropout"])
def test_loop_and_cohort_engines_agree_bitwise(kw):
    loop, cohort = _run("loop", **kw), _run("cohort", **kw)
    for a, b in zip(loop, cohort):
        assert (a.participants, a.mean_staleness, a.sim_finish_s,
                a.served_model_age_s, a.bytes_up, a.id_fraction) == (
            b.participants, b.mean_staleness, b.sim_finish_s,
            b.served_model_age_s, b.bytes_up, b.id_fraction)
        assert (a.accs, a.local_loss, a.distill_loss) == (
            b.accs, b.local_loss, b.distill_loss)


@pytest.mark.parametrize("phase", ["distill", "local_train",
                                   "distill_private"])
def test_sampled_out_lanes_stay_bitwise_unchanged(phase):
    """A distill, local-train or private-distill phase over a participation
    mask moves the participants and leaves every sampled-out lane's
    parameters, momentum, step count and rng bitwise as they were."""
    clients, *_ = simulator.build_experiment(
        FedConfig(num_clients=4, rounds=1, engine="cohort"), n_train=400,
        n_test=50, device="cpu")
    engine = CohortEngine(clients)
    cohort = engine.cohorts[0]
    part = np.array([True, False, True, False])
    before = [p.detach().clone() for p in cohort.params]
    mu = [v.clone() for v in cohort.opt_state["mu"]]
    step = cohort.opt_state["step"].clone()
    rng_states = [c.rng.bit_generator.state for c in clients]
    rng = np.random.default_rng(0)
    if phase == "distill":
        losses = engine.phase_distill(
            rng.standard_normal((40, 50)).astype(np.float32),
            rng.standard_normal((40, 10)).astype(np.float32),
            np.ones(40, np.float32), 2, 16, participants=part)
    elif phase == "local_train":
        losses = engine.phase_local_train(1, 32, participants=part)
    else:
        losses = engine.phase_distill_private(
            rng.standard_normal((10, 10)).astype(np.float32),
            np.ones(10, bool), 1, 32, participants=part)
    assert [v == 0.0 for v in losses] == list(~part)
    for i in np.flatnonzero(~part):
        assert all(torch.equal(p[i], q[i])
                   for p, q in zip(cohort.params, before))
        assert all(torch.equal(v[i], w[i])
                   for v, w in zip(cohort.opt_state["mu"], mu))
        assert cohort.opt_state["step"][i] == step[i]
        assert clients[i].rng.bit_generator.state == rng_states[i]
    for i in np.flatnonzero(part):
        assert not torch.equal(cohort.params[0][i], before[0][i])
        assert clients[i].rng.bit_generator.state != rng_states[i]


def test_round_mode_env_and_single_round(monkeypatch):
    monkeypatch.setenv("REPRO_ROUND_MODE", "overlap")
    assert resolve_round_mode("auto") == "overlap"
    assert resolve_round_mode("sync") == "sync"
    monkeypatch.setenv("REPRO_ROUND_MODE", "")
    assert resolve_round_mode(None) == "sync"
    with pytest.raises(ValueError, match="round_mode"):
        resolve_round_mode("eager")
    cfg = FedConfig(num_clients=3, rounds=1, round_mode="overlap",
                    participation_fraction=0.5, method="fedmd")
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, n_train=300, n_test=60, device="cpu")
    log = run_round(0, clients, server, get_method("fedmd"), cfg, x_test,
                    y_test)
    want = sample_participants(0, 3, 0.5, "uniform", seed=0)
    assert log.participants == [int(i) for i in np.flatnonzero(want)]
    assert len(log.participants) == 2 and log.sim_finish_s > 0.0
    assert log.served_model_age_s == log.sim_finish_s


def test_what_is_not_ported_raises():
    cfg = FedConfig(num_clients=2, rounds=1)
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, n_train=200, n_test=50, device="cpu")
    res = run_experiment(clients, server, "edgefd", cfg, x_test, y_test)
    assert res.rounds[0].participants is None
    engine = CohortEngine(clients)
    sched = RoundScheduler(engine, server, get_method("edgefd"), cfg,
                           x_test, y_test)
    for call in (sched.snapshot, lambda: sched.restore({})):
        with pytest.raises(NotImplementedError, match="queue A item 8"):
            call()
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        RoundScheduler(engine, server, get_method("edgefd"),
                       FedConfig(num_clients=2, watchdog=True), x_test,
                       y_test)
    # the fault injector is ported: the scheduler builds it
    sched = RoundScheduler(engine, server, get_method("edgefd"),
                           FedConfig(num_clients=2, fault_mode="nan",
                                     fault_prob=0.5), x_test, y_test)
    assert sched.faults is not None and sched.faults.mode == "nan"
