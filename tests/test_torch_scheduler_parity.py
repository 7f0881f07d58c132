"""The full round scheduler against a live reference run: partial
participation with each policy, the staleness buffer, overlapping rounds
and wave streaming, on the loop and cohort engines. Each case prices the
simulated timeline with fixed phase costs (``benchmarks/async_rounds.py``'s),
so ``tests/_torch_parity.py`` holds participants, staleness, the ledger,
``sim_finish_s``, ``served_model_age_s`` and the node-for-node trace
exact, losses within rtol 1e-4 and accuracies within a test sample.

One reference run, on its cohort engine (which the reference holds equal
to its loop engine, and waved equal to unwaved), serves several port
runs: the port's cohort engine, its loop engine and its waves. Heavy
traffic — weighted sampling, churn, mid-round dropout, bursty arrivals
and admission under ``max_pending_reports`` over overlapping rounds —
runs on the edgefd case's split and client count, so its reference run
reuses that case's compiled steps."""
import pytest

from _torch_parity import (FIXED_COSTS, assert_logs_match, check_logs,
                           cohort_config, run_port, run_reference)

OVERLAP = dict(participation_fraction=0.5, round_mode="overlap",
               max_inflight=2, rounds=3)


@pytest.mark.parametrize("method,kw", [
    ("edgefd", dict(participation_policy="uniform", staleness_decay=0.5)),
    ("fkd", dict(participation_policy="roundrobin", staleness_decay=0.0))],
    ids=["edgefd-uniform-decay-0.5", "fkd-roundrobin-decay-0"])
def test_overlap_partial_participation_matches_reference(method, kw):
    # edgefd on the iid split, whose compiled steps the heavy-traffic case
    # below reuses (the strong split under participation: the mixed zoo's
    # concurrent case in test_torch_cohort.py)
    scenario = "iid" if method == "edgefd" else "strong"
    ref_kw = cohort_config(method, scenario, num_clients=6, **OVERLAP, **kw)
    ref = run_reference(ref_kw, sim_phase_costs=FIXED_COSTS)
    variants = [dict(), dict(engine="loop")]
    if method == "edgefd":
        variants.append(dict(wave_size=4))   # waves of 4 and 2
    for variant in variants:
        port_kw = dict(ref_kw, **variant)
        port = run_port(port_kw, ref, FIXED_COSTS)
        check_logs(port_kw, ref, port, sim_phase_costs=FIXED_COSTS)
    rounds = port.result.rounds
    assert all(len(r.participants) == 3 for r in rounds)
    # overlap interleaves round 1's front phases before round 0 drains
    assert port.trace[2] == ("local_train", 1)
    if method == "edgefd":
        assert rounds[-1].mean_staleness > 0.0
    else:   # decay 0 drops every stale report
        assert all(r.mean_staleness == 0.0 for r in rounds)


def test_indlearn_overlap_matches_reference():
    kw = cohort_config("indlearn", "strong", num_clients=6, **OVERLAP)
    ref = run_reference(kw, sim_phase_costs=FIXED_COSTS)
    for variant in (dict(), dict(engine="loop")):
        port_kw = dict(kw, **variant)
        port = run_port(port_kw, ref, FIXED_COSTS)
        check_logs(port_kw, ref, port, sim_phase_costs=FIXED_COSTS)
    assert {p for p, _ in port.trace} == {"local_train", "eval"}


def test_churn_dropout_admission_bursty_match_reference():
    """An ingest queue of 3 reports under overlap: round 1 ingests while
    round 0's reports are parked and finds the queue full."""
    kw = cohort_config("edgefd", "iid", num_clients=6, rounds=3,
                       participation_fraction=0.75,
                       participation_policy="weighted", staleness_decay=0.5,
                       churn_prob=0.2, dropout_prob=0.2,
                       max_pending_reports=3, arrival_process="bursty",
                       arrival_spread=2.0, round_mode="overlap")
    _, port = assert_logs_match(kw, sim_phase_costs=FIXED_COSTS)
    rounds = port.result.rounds
    assert all(len(r.participants) <= 3 for r in rounds)
    assert rounds[1].participants == [] and rounds[1].id_fraction == 0.0
