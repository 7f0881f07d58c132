"""Kill-and-resume checker for the port (``tests/_resume_prog.py``'s
counterpart, on the CPU).

``check_resume`` runs an experiment to its end, capturing a
``RoundScheduler.snapshot()`` at every phase boundary of a middle round;
then, for each boundary, it builds the experiment again from scratch (a
fresh process's view), restores, drains, and asserts the completed round
logs are bit for bit those of the uninterrupted run, apart from the
measured ``wall_s`` and ``phase_s``.
"""
from __future__ import annotations

import dataclasses

# deterministic sim pricing, so the timeline fields are comparable
FIXED_COSTS = {"local_train": 1.0, "report": 0.1, "aggregate": 0.3,
               "distill": 1.0, "eval": 0.0}
# host-measured wall-clock can never match across runs; everything else
# must be bit for bit
MEASURED_FIELDS = ("wall_s", "phase_s")
N_TRAIN, N_TEST = 400, 100


def cfg(engine: str, round_mode: str, **kw):
    from repro_torch.common.types import FedConfig
    base = dict(num_clients=4, rounds=3, method="edgefd", scenario="strong",
                proxy_batch=64, batch_size=32, lr=1e-2, seed=0,
                engine=engine, round_mode=round_mode, max_inflight=2,
                participation_fraction=0.75, staleness_decay=0.5)
    base.update(kw)
    return FedConfig(**base)


def build_sched(config, dataset: str = "mnist_feat", device="cpu"):
    """The experiment of ``config`` as ``fed_serve.build_scheduler`` builds
    it, at the reference's resume-test sizes (MLP hidden (16,))."""
    from repro_torch.core.methods import get_method
    from repro_torch.core.protocol import engine_from_config, make_scheduler
    from repro_torch.fed.simulator import build_experiment
    clients, server, x_test, y_test = build_experiment(
        config, dataset, n_train=N_TRAIN, n_test=N_TEST, mlp_hidden=(16,),
        device=device)
    engine = engine_from_config(clients, config)
    method = get_method(config.method)
    if method.client_filter != "none":
        engine.learn_dres(config.seed)
    return make_scheduler(engine, server, method, config, x_test, y_test,
                          sim_phase_costs=FIXED_COSTS)


def strip(logs):
    return [{k: v for k, v in dataclasses.asdict(lg).items()
             if k not in MEASURED_FIELDS} for lg in logs]


def snapshots(config, crash_round: int = 1, boundaries=None,
              dataset: str = "mnist_feat"):
    """An uninterrupted run's stripped logs, and its snapshot trees at each
    phase boundary of ``crash_round`` (``boundaries``: those phases
    only)."""
    sched = build_sched(config, dataset)
    sched.begin(0, config.rounds)
    snaps = []
    while sched.has_pending():
        phase, r, _ = sched.step()
        if r == crash_round and (boundaries is None or phase in boundaries):
            snaps.append(((phase, r), sched.snapshot().to_tree()))
    assert snaps, "crash round never executed"
    return strip(sched.logs), snaps


def check_resume(engine: str, round_mode: str, crash_round: int = 1,
                 boundaries=None, dataset: str = "mnist_feat",
                 **cfg_kw) -> int:
    """Snapshot at every phase boundary of ``crash_round``; resume each in
    a freshly built experiment. Returns the number of boundaries."""
    config = cfg(engine, round_mode, **cfg_kw)
    ref, snaps = snapshots(config, crash_round, boundaries, dataset)
    for (phase, r), tree in snaps:
        sched = build_sched(config, dataset)
        sched.restore(tree)
        sched.drain()
        assert strip(sched.logs) == ref, (
            f"resume from boundary ({phase}, {r}) diverged "
            f"[engine={engine} mode={round_mode}]")
    return len(snaps)



def check_cross_engine(save_engine: str, save_devices: int,
                       load_engine: str, load_devices: int,
                       round_mode: str = "sync", **cfg_kw) -> None:
    """Save under one engine layout (``*_devices``: the cohort engine's
    mesh, 0 none), restore under another after round 0 retired. Engines
    agree within 1e-5 (the mesh-parity tolerance), not bitwise, so the
    restored run is held to an uninterrupted run of the loading one."""
    import numpy as np
    cfg_save = cfg(save_engine, round_mode, num_devices=save_devices,
                   **cfg_kw)
    cfg_load = cfg(load_engine, round_mode, num_devices=load_devices,
                   **cfg_kw)
    s1 = build_sched(cfg_save)
    s1.begin(0, cfg_save.rounds)
    tree = None
    while s1.has_pending():
        phase, r, _ = s1.step()
        if (phase, r) == ("eval", 0):      # a retired-round boundary
            tree = s1.snapshot().to_tree()
    if save_devices:
        # a mesh checkpoint is rank 0's whole state, read by every rank
        import torch.distributed as dist
        box = [tree]
        dist.broadcast_object_list(box, src=0)
        tree = box[0]
    s2 = build_sched(cfg_load)
    s2.restore(tree)
    s2.drain()
    logs_ref = build_sched(cfg_load).run_rounds(0, cfg_load.rounds)
    assert len(s2.logs) == len(logs_ref)
    for got, want in zip(s2.logs[1:], logs_ref[1:]):   # round 0: the saver
        np.testing.assert_allclose(got.accs, want.accs, rtol=0.0, atol=1e-5)
        np.testing.assert_allclose(got.local_loss, want.local_loss,
                                   rtol=0.0, atol=1e-5)
        np.testing.assert_allclose(got.distill_loss, want.distill_loss,
                                   rtol=0.0, atol=1e-5)
        assert got.participants == want.participants
