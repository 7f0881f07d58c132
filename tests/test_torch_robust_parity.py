"""Whole runs of the robustness layer against a live run of the JAX
reference, on ``tests/test_faults.py``'s scenarios (edgefd strong, 5
clients, 2 rounds, proxy batch 96, batch 32, n_train 500, n_test 200):
each fault mode, the three robust reducers under a colluding flip,
quarantine, and ``nan`` with the sanitize pass off. One reference loop
run a scenario; the port's loop and cohort engines are each held to it
(``tests/_torch_parity.py``'s tolerances: losses rtol 1e-4, accuracies
within a test sample, ID fraction and bytes exact up to near-threshold
pairs, ``participants``, ``scrubbed_rows`` and ``quarantined`` equal), and
the servers' trust, strikes, quarantine and scrub counts and the fault
injectors' replay caches after the run (``assert_server_state_match``)."""
from __future__ import annotations

import functools

import numpy as np
import pytest

import _torch_parity as P

N_TRAIN, N_TEST = 500, 200
BASE = P.config("edgefd", "strong", num_clients=5, rounds=2, proxy_batch=96,
                batch_size=32, lr=1e-2)
SCENARIOS = {
    **{mode: dict(fault_mode=mode, byzantine_frac=0.4, fault_prob=0.2)
       for mode in ("nan", "random_logits", "scaled", "colluding_flip")},
    # three rounds: the replay cache warms, then replays
    "stale_replay": dict(fault_mode="stale_replay", byzantine_frac=0.4,
                         fault_prob=0.2, rounds=3),
    **{red: dict(fault_mode="colluding_flip", byzantine_frac=0.3,
                 robust_aggregation=red,
                 trim_frac=0.45 if red == "trimmed_mean" else 0.2)
       for red in ("trimmed_mean", "median", "krum_row")},
    "quarantine": dict(fault_mode="scaled", byzantine_frac=0.25,
                       robust_aggregation="trimmed_mean", trim_frac=0.3,
                       quarantine_threshold=2.0, quarantine_rounds=2,
                       num_clients=4, rounds=3),
    "nan_unsanitized": dict(fault_mode="nan", byzantine_frac=0.34,
                            sanitize_reports=False, rounds=3),
}


def _kw(name, engine="loop"):
    return dict(BASE, **SCENARIOS[name], engine=engine)


@functools.lru_cache(maxsize=None)
def _reference(name):
    return P.run_reference(_kw(name), n_train=N_TRAIN, n_test=N_TEST)


@pytest.mark.parametrize("engine", ["loop", "cohort"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_matches_reference(name, engine):
    ref = _reference(name)
    kw = _kw(name, engine)
    port = P.run_port(kw, ref)
    P.check_logs(kw, ref, port, N_TEST)
    P.assert_server_state_match(ref, port)


def test_nan_is_scrubbed_every_round():
    ref = _reference("nan")
    assert all(r.scrubbed_rows > 0 for r in ref.result.rounds)
    port = P.run_port(_kw("nan", "cohort"), ref)
    assert [r.scrubbed_rows for r in port.result.rounds] == [
        r.scrubbed_rows for r in ref.result.rounds]
    assert all(np.isfinite(r.distill_loss) for r in port.result.rounds)


def test_unsanitized_nan_poisons_the_same_rounds():
    """With the sanitize pass off the NaN rows reach the mean in both
    packages: the same rounds have a NaN distill loss, nothing is
    scrubbed."""
    ref = _reference("nan_unsanitized")
    port = P.run_port(_kw("nan_unsanitized"), ref)
    want = [bool(np.isnan(r.distill_loss)) for r in ref.result.rounds]
    assert any(want)
    assert [bool(np.isnan(r.distill_loss))
            for r in port.result.rounds] == want
    assert all(r.scrubbed_rows == 0 for r in port.result.rounds)


def test_quarantine_drops_the_attacker():
    """The scaled attacker is quarantined on round 0's evidence and sits
    out the next round, in both packages."""
    from repro_torch.fed.faults import byzantine_ids
    ref = _reference("quarantine")
    port = P.run_port(_kw("quarantine", "cohort"), ref)
    cid = int(np.flatnonzero(byzantine_ids(4, byzantine_frac=0.25))[0])
    for res in (ref.result, port.result):
        ev = next(r.round for r in res.rounds if r.quarantined)
        assert cid in res.rounds[ev].quarantined
        assert cid not in res.rounds[ev + 1].participants
    assert port.server.strikes[cid] == ref.server.strikes[cid] >= 1
