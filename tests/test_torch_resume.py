"""Kill-and-resume within the port, on the CPU: snapshot/restore bit for
bit across engines and modes.

The cases of ``tests/test_resume.py`` (and ``tests/test_faults.py``'s
resume and watchdog cases) one for one, at the reference's sizes: 4
clients, n_train 400, MLP hidden (16,), fixed phase costs
(``tests/_torch_resume_prog.py``). In-process tests restore from every
phase boundary of a middle round through ``RoundScheduler.snapshot()`` /
``restore()`` into a freshly built experiment; the subprocess test drives
``repro_torch.launch.fed_serve``'s real SIGKILL crash hook. The mesh
cases run in one world of two gloo ranks on the CPU
(``tests/_torch_mesh_prog.py``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh_prog
import _torch_resume_prog as prog
from _torch_resume_prog import build_sched, cfg, check_resume, strip
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.common.types import FedConfig
from repro_torch.fed import faults, simulator
from repro_torch.fed.state import ExperimentState

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("round_mode", ["sync", "overlap"])
def test_loop_resume_every_boundary(round_mode):
    """Loop engine, partial participation and staleness: a restore from
    every phase boundary of round 1 replays the rest bit for bit."""
    assert check_resume("loop", round_mode) == 5


def test_cohort_resume_inflight_boundaries():
    """Cohort engine under overlap, where round 1 is really in flight
    (reports parked, stacked state mid-round)."""
    assert check_resume("cohort", "overlap",
                        boundaries=("report", "aggregate", "distill")) == 3


def test_server_distill_resume_every_boundary():
    """FedDF: the server student's parameters, optimizer state and stream
    ride the checkpoint, so every boundary of round 1 — server_distill's
    too — replays bit for bit."""
    assert check_resume("loop", "sync", method="server_distill") == 6


def test_concurrent_cohort_resume_boundaries():
    """The mixed zoo's per-cohort nodes under overlap: 4 clients in 3
    cohorts, 3 client phases × 3 cohort nodes + aggregate + eval."""
    assert check_resume("cohort", "overlap", zoo="mixed",
                        concurrent_cohorts=True) == 11


def test_snapshot_restore_preserves_event_loop_bookkeeping():
    """Pending and done nodes, the trace and the sim times survive the tree
    form; restore rejects a round-mode mismatch."""
    config = FedConfig(num_clients=4, rounds=3, method="edgefd",
                       scenario="strong", proxy_batch=64, batch_size=32,
                       seed=0, round_mode="overlap", max_inflight=2)
    s1 = build_sched(config)
    s1.begin(0, config.rounds)
    for _ in range(7):
        s1.step()
    tree = s1.snapshot().to_tree()
    s2 = build_sched(config)
    s2.restore(tree)
    assert s2._pending == s1._pending
    assert s2._done == s1._done
    assert s2.trace == s1.trace
    assert s2._sim_end == s1._sim_end
    assert strip(s2.logs) == strip(s1.logs)
    s3 = build_sched(FedConfig(num_clients=4, rounds=3, method="edgefd",
                               scenario="strong", proxy_batch=64,
                               batch_size=32, seed=0, round_mode="sync"))
    with pytest.raises(ValueError, match="round_mode"):
        s3.restore(tree)


def test_logs_tail_keeps_checkpoint_bytes_flat(tmp_path):
    """With ``logs_tail=0`` a checkpoint's bytes stop growing with the
    service's age, while full snapshots grow round over round; a tail-less
    tree still restores, ``completed`` kept and the logs empty."""
    config = FedConfig(num_clients=4, rounds=4, method="edgefd",
                       scenario="strong", proxy_batch=64, batch_size=32,
                       seed=0, round_mode="sync")
    sched = build_sched(config)
    sched.begin(0, config.rounds)
    flat_sizes, full_sizes, trees = [], [], []
    done = 0
    while sched.has_pending():
        _, _, log = sched.step()
        if log is None:
            continue
        done += 1
        p1 = save_state(str(tmp_path / f"flat{done}"), done,
                        sched.snapshot(logs_tail=0).to_tree())
        p2 = save_state(str(tmp_path / f"full{done}"), done,
                        sched.snapshot().to_tree())
        flat_sizes.append(os.path.getsize(p1))
        full_sizes.append(os.path.getsize(p2))
        trees.append(sched.snapshot(logs_tail=0).to_tree())
    assert done == 4
    assert full_sizes[-1] > full_sizes[0]
    assert max(flat_sizes) - min(flat_sizes) < 512
    s2 = build_sched(config)
    s2.restore(ExperimentState.from_tree(trees[1]))
    assert s2.completed == 2 and s2.logs == []
    s2.drain()
    ref = build_sched(config).run_rounds(0, config.rounds)
    assert strip(s2.logs) == strip(ref[2:])


def test_backpressure_ages_never_negative():
    """Admission under a tight report budget: overflow clients drain
    through the staleness buffer with ages only moving forward."""
    config = FedConfig(num_clients=6, rounds=4, method="edgefd",
                       scenario="strong", proxy_batch=64, batch_size=32,
                       seed=1, round_mode="overlap", max_inflight=2,
                       staleness_decay=0.5, max_pending_reports=3,
                       straggler_factor=4.0)
    logs = build_sched(config).run_rounds(0, config.rounds)
    assert all(lg.mean_staleness >= 0.0 for lg in logs)
    assert any(lg.participants is not None and len(lg.participants) < 6
               for lg in logs)


def test_waved_cohort_checkpoint_restores_into_unwaved_and_loop(tmp_path):
    """The engine state is keyed per client: a checkpoint of the cohort
    engine in waves of 3 (the last wave padded) restores into the unwaved
    cohort engine and into the loop engine, and each drains to that
    engine's uninterrupted run bit for bit (the engines agree bit for bit
    on the CPU, as tests/test_torch_cohort.py holds them)."""
    waved = cfg("cohort", "overlap", wave_size=3)
    s1 = build_sched(waved)
    s1.begin(0, waved.rounds)
    while s1.has_pending():
        phase, r, _ = s1.step()
        if (phase, r) == ("eval", 0):
            save_state(str(tmp_path), 1, s1.snapshot().to_tree())
    tree = restore_state(str(tmp_path), 1)
    for engine in ("cohort", "loop"):
        s2 = build_sched(cfg(engine, "overlap"))
        s2.restore(tree)
        s2.drain()
        ref = build_sched(cfg(engine, "overlap")).run_rounds(0, 3)
        assert strip(s2.logs[1:]) == strip(ref[1:])


def test_fed_serve_sigkill_resume(tmp_path):
    """The real crash harness on the CPU: fed_serve SIGKILLs itself at a
    boundary of round 1 (overlap: round 0's checkpoint carries round 1 in
    flight), a second run resumes, and the history equals an uninterrupted
    service's bit for bit, apart from the measured fields."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.abspath(os.path.join(here, "..", "src"))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    common = [sys.executable, "-m", "repro_torch.launch.fed_serve",
              "--device", "cpu", "--clients", "3", "--rounds", "2",
              "--n-train", "256", "--n-test", "64", "--round-mode",
              "overlap", "--participation", "0.75", "--staleness-decay",
              "0.5", "--fixed-phase-costs"]
    ckpt = str(tmp_path / "svc")
    crashed = subprocess.run(
        common + ["--ckpt-dir", ckpt, "--ckpt-every", "1",
                  "--crash-after-phase", "aggregate:1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert crashed.returncode == -9, (
        f"expected SIGKILL exit, got {crashed.returncode}:\n"
        f"{crashed.stdout}\n{crashed.stderr}")
    assert os.path.exists(os.path.join(ckpt, "ckpt_00000001.npz"))
    sidecar = os.path.join(ckpt, "logs.jsonl")
    assert os.path.exists(sidecar)
    resumed = subprocess.run(
        common + ["--ckpt-dir", ckpt, "--ckpt-every", "1", "--resume",
                  "--json", str(tmp_path / "resumed.json")],
        env=env, capture_output=True, text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "resumed from checkpoint step 1" in resumed.stdout
    with open(sidecar) as f:
        side = [json.loads(ln) for ln in f if ln.strip()]
    assert [d["round"] for d in side] == [0, 1]
    ref = subprocess.run(common + ["--json", str(tmp_path / "ref.json")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr

    def load(p):
        with open(p) as f:
            return [{k: v for k, v in d.items()
                     if k not in prog.MEASURED_FIELDS} for d in json.load(f)]
    assert load(tmp_path / "resumed.json") == load(tmp_path / "ref.json")


def test_fed_serve_refuses_cuda_without_a_card(monkeypatch):
    """Like fed_train, the service defaults to the card and raises on a
    host without one unless the CPU is asked for."""
    from repro_torch.launch import fed_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        fed_serve.main(["--clients", "2", "--rounds", "1"])


# ---- tests/test_faults.py's resume and watchdog cases

QUARANTINE = dict(fault_mode="scaled", byzantine_frac=0.25,
                  robust_aggregation="trimmed_mean", trim_frac=0.3,
                  quarantine_threshold=2.0, quarantine_rounds=2)


def test_quarantine_triggers_and_resumes_bit_for_bit():
    """Trust tracking quarantines the scaled attacker, the next round runs
    without it, and the trust/quarantine/fault state rides kill-and-resume
    bit for bit. The port's own draw (its initial weights are not the
    reference's) first quarantines on round 2's evidence, one round later
    than the reference's draw, so the run takes a fourth round to show the
    next round without the attacker."""
    res = simulator.run(FedConfig(num_clients=4, rounds=4, method="edgefd",
                                  scenario="strong", proxy_batch=96,
                                  batch_size=32, seed=0, **QUARANTINE),
                        "mnist_feat", n_train=500, n_test=200, device="cpu")
    cid = int(np.flatnonzero(faults.byzantine_ids(4, seed=0,
                                                  byzantine_frac=0.25))[0])
    assert cid in [c for r in res.rounds for c in (r.quarantined or [])]
    ev = next(r.round for r in res.rounds if r.quarantined)
    after = next(r for r in res.rounds if r.round == ev + 1)
    assert after.participants is not None and cid not in after.participants
    assert check_resume("loop", "sync", **QUARANTINE) == 5


def test_stale_replay_cache_resumes_bit_for_bit():
    """The stale_replay cache is injector state: a kill between its warm
    and replay rounds does not change what is replayed."""
    assert check_resume("loop", "sync", fault_mode="stale_replay",
                        fault_prob=0.4) == 5


WATCHDOG_BASE = dict(num_clients=6, rounds=4, method="edgefd",
                     scenario="strong", proxy_batch=96, batch_size=32,
                     sanitize_reports=False)
NAN_BURST = dict(fault_mode="nan", byzantine_frac=0.34, fault_start=2,
                 fault_duration=1)


@pytest.mark.parametrize("engine", ["loop", "cohort"])
def test_watchdog_rolls_back_and_recovers(engine):
    """A mid-run nan burst with the sanitize pass off: without the watchdog
    the run never recovers; with it the burst round is rolled back, the
    nan senders quarantined, the rounds before the burst equal the
    fault-free run's, and every retired log is finite."""
    def run(**kw):
        return simulator.run(FedConfig(**WATCHDOG_BASE, engine=engine, **kw),
                             "mnist_feat", n_train=500, n_test=200,
                             device="cpu")
    clean, broken = run(), run(**NAN_BURST)
    guarded = run(**NAN_BURST, watchdog=True)
    assert not np.isfinite(broken.rounds[-1].distill_loss)
    assert len(guarded.rounds) == 4
    assert all(np.isfinite(r.mean_acc) and np.isfinite(r.distill_loss)
               for r in guarded.rounds)
    assert guarded.rounds[-1].rollbacks >= 1
    assert any(r.quarantined for r in guarded.rounds)
    assert guarded.final_acc >= clean.final_acc - 0.15

    def pinned(r):
        return (r.accs, r.mean_acc, r.local_loss, r.distill_loss,
                r.id_fraction, r.bytes_up, r.bytes_down)
    for c, g in zip(clean.rounds[:2], guarded.rounds[:2]):
        assert pinned(c) == pinned(g)


@pytest.fixture(scope="module")
def mesh_resumes(tmp_path_factory):
    """The mesh cases of ``tests/test_resume.py`` and
    ``tests/test_fd_transformer.py`` in one world of two ranks (the
    reference forces four host devices; two keep the test's processes
    within the suite's cores, and the 4 clients still split over the
    client axis, or each client over the model axis)."""
    return _torch_mesh_prog.spawn(2, "resume", {"cases": [
        {"kind": "resume", "engine": "cohort", "round_mode": "overlap",
         "num_devices": 2},
        {"kind": "cross", "save_engine": "cohort", "save_devices": 2,
         "load_engine": "loop", "load_devices": 0},
        {"kind": "cross", "save_engine": "loop", "save_devices": 0,
         "load_engine": "cohort", "load_devices": 2},
        {"kind": "resume", "engine": "cohort", "round_mode": "overlap",
         "num_devices": 2, "model_shards": 2},
    ]}, tmp_path_factory.mktemp("mesh_resume"), timeout=300)


def test_mesh_resume_and_cross_engine_forced_devices(mesh_resumes):
    """The cohort engine on a 1-D mesh of two ranks: a restore from every
    boundary of round 1 is bit for bit on every rank, and a mesh
    checkpoint restores into the unsharded loop engine and back within
    the mesh-parity tolerance."""
    for rank in mesh_resumes:
        assert rank[:3] == [5, True, True]


def test_sharded_kill_and_resume_bit_for_bit(mesh_resumes):
    """Kill-and-resume through a model-sharded round: the (1, 2) mesh
    under overlap, a restore from every boundary of round 1 into a
    freshly built sharded experiment, bit for bit."""
    for rank in mesh_resumes:
        assert rank[3] == 5
