"""Two-tier runs against the JAX reference's two-tier runs:
``tests/test_scale.py``'s three cases at E = 3 (full participation,
fraction 0.6 with staleness decay 0.5, Selective-FD's entropy filter at
the edges) and the median reducer at E = 3 under a colluding flip (the
edges' approximation of the flat robust reduce), edgefd strong, 5
clients, 3 rounds, proxy batch 96, batch 32, n_train 500. One reference
loop run a case, the port's loop and cohort engines each held to it
(``tests/_torch_parity.py``'s tolerances), and each held apart from the
flat reference where the approximation makes the two differ."""
from __future__ import annotations

import functools

import numpy as np
import pytest

import _torch_parity as P

N_TRAIN, N_TEST = 500, 200
BASE = P.config("edgefd", "strong", num_clients=5, rounds=3, proxy_batch=96,
                batch_size=32, lr=1e-2, num_edge_aggregators=3)
CASES = {
    "full": dict(),
    "subset": dict(participation_fraction=0.6, staleness_decay=0.5),
    "selective_fd": dict(method="selective-fd"),
    "median": dict(robust_aggregation="median", fault_mode="colluding_flip",
                   byzantine_frac=0.3),
}


def _kw(name, engine="loop", **over):
    return dict(BASE, **CASES[name], engine=engine, **over)


@functools.lru_cache(maxsize=None)
def _reference(name, edges=3):
    return P.run_reference(_kw(name, num_edge_aggregators=edges),
                           n_train=N_TRAIN, n_test=N_TEST)


@pytest.mark.parametrize("engine", ["loop", "cohort"])
@pytest.mark.parametrize("name", list(CASES))
def test_two_tier_matches_reference(name, engine):
    ref = _reference(name)
    kw = _kw(name, engine)
    port = P.run_port(kw, ref)
    P.check_logs(kw, ref, port, N_TEST)
    P.assert_server_state_match(ref, port)
    assert len(port.server._shards(5)) == 3


def test_two_tier_median_is_the_edges_approximation():
    """At E = 3 the port's median run, held to the reference's two-tier
    run above, parts from the reference's flat run beyond the tolerance:
    the root averages edge medians, which is not the global median."""
    flat = _reference("median", edges=1).result.rounds
    port = P.run_port(_kw("median", "cohort"), _reference("median"))
    got = np.array([r.distill_loss for r in port.result.rounds])
    want = np.array([r.distill_loss for r in flat])
    assert (np.abs(got - want) > P.LOSS_RTOL * np.abs(want)).any()
