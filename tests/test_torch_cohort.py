"""The port's cohort engine against the live JAX reference's cohort engine.

The harness and its tolerances are in ``tests/_torch_parity.py``: both
packages run ``engine="cohort"`` from the reference's dataset arrays,
initial parameters and k-means++ seeds; the port runs on the CPU through
its plain PyTorch versions. Losses hold to rtol 1e-4, accuracies to one
test sample, and the ID fraction and byte ledger exactly, up to counted
near-threshold pairs. The scenarios follow ``tests/test_cohort_parity.py``
(the uniform iid split takes the batched DRE fit; strong and weak split
unevenly, so their clients fit one by one, as the reference's do).

Within the port: the cohort engine against its loop engine (bit for bit
on the CPU here, where each client's batched products equal its own),
and wave streaming against the unwaved cohort, bit for bit.
"""
import pytest
import torch

from _torch_parity import (HETERO_COSTS, assert_logs_match,
                           assert_params_match, cohort_config)
from repro_torch.common.types import FedConfig
from repro_torch.core.protocol import run_experiment
from repro_torch.fed import simulator
from repro_torch.fed.cohort import CohortEngine

# host-clock fields: the simulated timeline is priced from the measured
# phase seconds
TIMING = ("wall_s", "phase_s", "sim_finish_s", "served_model_age_s")


@pytest.mark.parametrize("scenario", ["strong", "weak", "iid"])
def test_edgefd_cohort_matches_live_reference_cohort(scenario):
    ref, port = assert_logs_match(cohort_config("edgefd", scenario))
    assert_params_match(ref, port)


@pytest.mark.parametrize("method", ["fedmd", "indlearn", "fkd",
                                    "selective-fd"])
def test_methods_on_the_cohort_match_live_reference_cohort(method):
    assert_logs_match(cohort_config(method, "strong"))


def test_ragged_clients_and_a_short_proxy_batch_match_reference():
    """Weak non-IID sizes differ by client; a proxy batch of 40 is one
    short batch of 40 for every client (batch size 64)."""
    assert_logs_match(cohort_config("edgefd", "weak", proxy_batch=40))


def test_mixed_zoo_three_cohorts_match_live_reference():
    """Sync rounds priced with hetero_zoo's per-cohort costs: the lockstep
    trace and the simulated finishes equal the reference's too."""
    ref, port = assert_logs_match(cohort_config("edgefd", "strong",
                                                num_clients=6, zoo="mixed"),
                                  sim_phase_costs=HETERO_COSTS)
    assert port.trace[:5] == [(p, 0) for p in ("local_train", "report",
                                                "aggregate", "distill",
                                                "eval")]
    assert_params_match(ref, port)
    widths = sorted({tuple(w.shape[1] for w in c.model.weights)
                     for c in port.clients})
    assert widths == [(128, 64, 10), (256, 128, 10), (512, 256, 10)]


def test_mixed_zoo_concurrent_overlap_matches_reference():
    """The mixed zoo of the test above (whose reference run compiled the
    same cohort steps) with concurrent cohorts, overlapping rounds and
    half the clients a round: per-cohort client nodes, aggregation a
    global barrier, the trace and the simulated finishes the
    reference's."""
    kw = cohort_config("edgefd", "strong", num_clients=6, rounds=3,
                       zoo="mixed", round_mode="overlap",
                       concurrent_cohorts=True, participation_fraction=0.5,
                       staleness_decay=0.5)
    _, port = assert_logs_match(kw, sim_phase_costs=HETERO_COSTS)
    assert ("local_train", 0, 2) in port.trace
    assert ("aggregate", 0) in port.trace
    assert port.result.rounds[-1].mean_staleness > 0.0


def test_image_singleton_cohorts_match_live_reference():
    assert_logs_match(cohort_config("edgefd", "strong"), "mnist_like")


def _run(engine, wave_size=0, **kw):
    cfg = FedConfig(**dict(dict(num_clients=6, rounds=2, method="edgefd",
                                scenario="iid", zoo="mixed", seed=0,
                                proxy_batch=100, engine=engine,
                                wave_size=wave_size), **kw))
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, n_train=900, n_test=200, device="cpu")
    res = run_experiment(clients, server, cfg.method, cfg, x_test, y_test)
    return res, clients


def _logs(res):
    return [{k: v for k, v in vars(r).items() if k not in TIMING}
            for r in res.rounds]


@pytest.mark.parametrize("kw", [
    dict(), dict(scenario="strong", zoo="shared"),
    dict(method="selective-fd", zoo="shared"),
    dict(method="fkd", scenario="weak"), dict(method="server_distill")],
    ids=["edgefd-iid-mixed", "edgefd-strong", "selective-fd-iid", "fkd-weak",
         "server_distill"])
def test_cohort_equals_the_ports_loop_engine(kw):
    cohort, cc = _run("cohort", **kw)
    loop, lc = _run("loop", **kw)
    assert _logs(cohort) == _logs(loop)
    for a, b in zip(cc, lc):          # synced back onto the clients
        assert all(torch.equal(p, q) for p, q in zip(a.params, b.params))
        assert a.opt_state["step"] == b.opt_state["step"]


@pytest.mark.parametrize("kw,wave", [
    (dict(num_clients=9), 2),                          # 3 cohorts of 3
    (dict(zoo="shared", method="selective-fd"), 4),    # waves of 4 and 2
    (dict(zoo="shared", scenario="strong", method="fkd"), 4)],
    ids=["mixed-9-waves-of-2", "selective-fd-waves-of-4", "fkd-waves-of-4"])
def test_waves_equal_the_unwaved_cohort_bit_for_bit(kw, wave):
    unwaved, uc = _run("cohort", **kw)
    waved, wc = _run("cohort", wave_size=wave, **kw)
    assert _logs(waved) == _logs(unwaved)
    for a, b in zip(wc, uc):
        assert all(torch.equal(p, q) for p, q in zip(a.params, b.params))


def test_cohorts_group_by_arch_key_and_refuse_mismatched_members():
    cfg = FedConfig(num_clients=6, rounds=1, zoo="mixed", engine="cohort")
    clients, *_ = simulator.build_experiment(cfg, n_train=600, n_test=50,
                                             device="cpu")
    engine = CohortEngine(clients)
    assert [c.positions for c in engine.cohorts] == [[0, 3], [1, 4], [2, 5]]
    assert all(len({id(m.opt) for m in c.members}) == 1
               for c in engine.cohorts)
    clients[3].temperature = 1.0
    with pytest.raises(ValueError, match="differ in temperature"):
        CohortEngine(clients)
    clients[3].temperature = clients[0].temperature
    clients[3].arch_key = clients[1].arch_key      # a 128-wide MLP among 64
    with pytest.raises(ValueError, match="different model structures"):
        CohortEngine(clients)


def test_cohort_refuses_what_is_not_ported():
    cfg = FedConfig(num_clients=2, rounds=1, engine="cohort")
    clients, *_ = simulator.build_experiment(cfg, n_train=200, n_test=50,
                                             device="cpu")
    engine = CohortEngine(clients)
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        engine.state_dict()
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        engine.load_state_dict({})
