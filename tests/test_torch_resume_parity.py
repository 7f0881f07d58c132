"""Snapshot and restore across the two packages, held to a live reference.

One container on disk and one state layout (``repro_torch.fed.state``):
(a) a reference snapshot at each phase boundary of round 1, written by
``repro.checkpoint.save_state``, is read by the port's ``restore_state``
and restored into the port's experiment, built from the reference's
arrays as the parity harness builds it (``tests/_torch_parity.py``); (b)
a port snapshot restores into a freshly built reference; (c) the port's
divergence watchdog is held to the reference's; (d) an lm_tokens resume
(the transformer clients' leaf names and stacked layout). Each drained run
is held to the live uninterrupted reference within the harness's
tolerances: losses rtol 1e-4, accuracies within a test sample, bytes
exact up to near-threshold pairs, participants, staleness and (under fixed
phase costs) the simulated timeline exact, and the node trace equal.
"""
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.checkpoint import restore_state as ref_restore_state
from repro.checkpoint import save_state as ref_save_state
from repro_torch.checkpoint import restore_state, save_state

PHASES = ("local_train", "report", "aggregate", "distill", "eval")
# the kill-and-resume configuration of tests/_resume_prog.py, on the
# harness's sizes: overlap with partial participation and staleness
KW = P.config("edgefd", "strong", rounds=3, round_mode="overlap",
              max_inflight=2, participation_fraction=0.75,
              staleness_decay=0.5)


def _snapshots(sched, rounds, crash_round=1):
    """Run ``sched`` to its end; its snapshot trees at each boundary of
    ``crash_round``, by phase."""
    sched.begin(0, rounds)
    snaps = {}
    while sched.has_pending():
        phase, r, _ = sched.step()
        if r == crash_round:
            snaps[phase] = sched.snapshot().to_tree()
    return snaps


@pytest.fixture(scope="module")
def live():
    """One reference run of KW (its snapshots kept) and one port run."""
    sched, ref = P.build_reference(KW, sim_phase_costs=P.FIXED_COSTS)
    ref_snaps = _snapshots(sched, KW["rounds"])
    ref.result, ref.trace = P._Result(sched.logs), list(sched.trace)
    port = P.port_scheduler(KW, ref, P.FIXED_COSTS)
    port_snaps = _snapshots(port, KW["rounds"])
    return ref, ref_snaps, port, port_snaps


def _as_run(sched, dre_of):
    """A drained scheduler's logs and trace as the harness's ``Run``;
    ``dre_of`` is the port run whose DREs and proxy set the near-threshold
    count reads."""
    return P.Run(P._Result(sched.logs), dre_of.engine.clients,
                 dre_of.server, trace=list(sched.trace))


@pytest.mark.parametrize("phase", PHASES)
def test_reference_snapshot_resumes_in_the_port(live, phase, tmp_path):
    ref, ref_snaps, port, _ = live
    ref_save_state(str(tmp_path), 1, ref_snaps[phase])
    sched = P.port_scheduler(KW, ref, P.FIXED_COSTS)
    sched.restore(restore_state(str(tmp_path), 1))
    sched.drain()
    P.check_logs(KW, ref, _as_run(sched, sched), P.N_TEST, P.FIXED_COSTS)


@pytest.mark.parametrize("phase", PHASES)
def test_port_snapshot_resumes_in_the_reference(live, phase, tmp_path):
    ref, _, port, port_snaps = live
    save_state(str(tmp_path), 1, port_snaps[phase])
    sched, _ = P.build_reference(KW, sim_phase_costs=P.FIXED_COSTS)
    sched.restore(ref_restore_state(str(tmp_path), 1))
    sched.drain()
    P.check_logs(KW, ref, _as_run(sched, port), P.N_TEST, P.FIXED_COSTS)


def test_watchdog_matches_live_reference():
    """tests/test_faults.py's watchdog scenario (a nan burst in round 2,
    the sanitize pass off) in both packages: the same rollbacks and
    quarantined clients, every retired log finite and within the
    tolerances."""
    kw = P.config("edgefd", "strong", num_clients=6, rounds=4,
                  proxy_batch=96, batch_size=32, sanitize_reports=False,
                  fault_mode="nan", byzantine_frac=0.34, fault_start=2,
                  fault_duration=1, watchdog=True)
    ref, port = P.assert_logs_match(kw)
    assert ([r.rollbacks for r in port.result.rounds]
            == [r.rollbacks for r in ref.result.rounds])
    assert port.result.rounds[-1].rollbacks >= 1
    assert any(r.quarantined for r in port.result.rounds)
    assert all(np.isfinite(r.mean_acc) and np.isfinite(r.distill_loss)
               for r in port.result.rounds)
    P.assert_server_state_match(ref, port)


def test_lm_tokens_reference_snapshot_resumes_in_the_port(tmp_path):
    """The transformer clients at tests/test_torch_lm_tokens.py's sizes: a
    reference snapshot after round 1's training and report (the clients'
    trained weights and momentum in the reference's stacked pytree)
    restores into the port and drains within the tolerances."""
    kw = P.config("edgefd", "strong", num_clients=3, rounds=2,
                  proxy_batch=64, batch_size=16, lr=1e-2)
    sched, ref = P.build_reference(kw, "lm_tokens", 300, 150)
    snaps = _snapshots(sched, kw["rounds"])
    ref.result, ref.trace = P._Result(sched.logs), list(sched.trace)
    ref_save_state(str(tmp_path), 1, snaps["report"])
    port = P.port_scheduler(kw, ref)
    port.restore(restore_state(str(tmp_path), 1))
    port.drain()
    P.check_logs(kw, ref, _as_run(port, port), 150)
    trained = port.engine.clients[0].model.jax_params()
    assert trained["blocks"]["attn"]["wq"].shape[0] == 2   # layer axis
    assert isinstance(port.engine.clients[0].opt_state["mu"][0],
                      torch.Tensor)
