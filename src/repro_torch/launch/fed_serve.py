"""Resumable federated service on a GPU: checkpoint, crash, resume.

The counterpart of ``repro.launch.fed_serve``. Where ``fed_train`` is a
batch run, ``fed_serve`` treats the experiment as a long-running service:
the scheduler advances one phase node per event tick, the full experiment
state (the scheduler's window and in-flight rounds, the server's buffers
and parked reports, every client's parameters and optimizer state, every
rng stream) is checkpointed every ``--ckpt-every`` retired rounds through
``repro_torch.checkpoint`` (atomic write, retention, corrupt-file
fallback; the reference's container, so either package's checkpoint
loads in the other), and ``--resume`` picks up the latest checkpoint
after a crash.

The guarantee: kill the process at any phase boundary, resume from the
last checkpoint, and the completed round logs are bit for bit those of
the uninterrupted run, apart from the measured ``wall_s`` and ``phase_s``
— on the loop and cohort engines, in sync and overlap mode, on the card
and on the CPU. ``--fixed-phase-costs`` pins the simulated-timeline fields
too; without it they price at measured wall-clock, which no checkpoint
can replay.

``--crash-after-phase NAME:K`` is the kill-and-resume harness's hook: the
process SIGKILLs itself right after executing node ``(NAME, K)``, after
any checkpoint due at that boundary::

    python -m repro_torch.launch.fed_serve --rounds 2 --ckpt-dir svc \
        --ckpt-every 1 --fixed-phase-costs --crash-after-phase aggregate:1
    python -m repro_torch.launch.fed_serve --rounds 2 --ckpt-dir svc \
        --ckpt-every 1 --fixed-phase-costs --resume --json svc.json

Takes ``fed_train``'s flags plus ``--device``, which defaults to ``cuda``:
without a CUDA device the service raises unless ``--device cpu`` asks for
the CPU. Each retired round logs ``served_model_age_s`` next to
``sim_finish_s``: how long the previous model was the one a user query
would hit (``core.protocol.RoundLog``).

Over a device mesh (``--engine cohort --devices N [--model-shards M]``,
one process a rank under ``python -m torch.distributed.run``) every rank
takes every snapshot (the engine's state is gathered from all of them),
rank 0 alone prints, writes the sidecar, the checkpoints and ``--json``,
and a resume reads the checkpoint on every rank, each taking its own rows
and slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
from typing import List, Optional, Tuple

from repro_torch.checkpoint import latest_step, restore_state, save_state
from repro_torch.core.methods import get_method
from repro_torch.core.protocol import (RoundLog, engine_from_config,
                                       make_scheduler)
from repro_torch.fed import mesh as fed_mesh
from repro_torch.fed import participation, scheduler as sched_mod, simulator
from repro_torch.fed.scheduler import RoundScheduler
from repro_torch.kernels import dispatch
from repro_torch.launch.fed_train import (add_config_args, config_from_args,
                                          print_round)

# fixed per-phase base costs (simulated seconds) for --fixed-phase-costs:
# benchmarks/async_rounds.py's, so served freshness lines up with it
FIXED_COSTS = {"local_train": 1.0, "report": 0.1, "aggregate": 0.3,
               "distill": 1.0, "eval": 0.0}

# retired-round history sidecar, beside the checkpoints: each retired
# RoundLog is appended as one JSON line before the checkpoint is written,
# and checkpoints are taken with ``snapshot(logs_tail=0)``, so their size
# stays flat over a long service
LOGS_SIDECAR = "logs.jsonl"


def _trim_sidecar(path: str, completed: int,
                  tail_len: int) -> List[RoundLog]:
    """Reconcile the sidecar with a restored checkpoint.

    The sidecar is appended before each checkpoint, so after a crash it
    may hold rounds the restored state has not retired yet; those are
    replayed and appended again, so the file is cut to its first
    ``completed`` lines. Returns the history's head: the retired rounds
    the checkpoint does not carry (``completed - tail_len`` of them)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    keep = lines[:completed]
    if len(keep) != len(lines):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(ln + "\n" for ln in keep))
        os.replace(tmp, path)
    head = keep[:max(completed - tail_len, 0)]
    return [RoundLog(**json.loads(ln)) for ln in head]


def parse_crash_spec(spec: str) -> Optional[Tuple[str, int]]:
    """``"aggregate:1"`` → ``("aggregate", 1)``; empty → ``None``."""
    if not spec:
        return None
    try:
        name, k = spec.rsplit(":", 1)
        return (name, int(k))
    except ValueError:
        raise SystemExit(
            f"--crash-after-phase wants NAME:ROUND (e.g. aggregate:1), "
            f"got {spec!r}")


def build_scheduler(cfg, dataset: str, n_train: int, n_test: int,
                    fixed_costs: bool, device="cuda") -> RoundScheduler:
    """Build the experiment on ``device`` exactly as ``simulator.run``
    does. A resume relies on this being deterministic in ``cfg``: data,
    partitions, model inits and DRE fits are rebuilt, and the checkpoint
    overlays only mutable state."""
    participation.validate_config(cfg)
    sched_mod.validate_config(cfg)
    simulator.check_slice(cfg, dataset)
    dispatch.resolve(cfg.kernel_backend)
    device = simulator.run_device(cfg, device)
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, dataset, n_train=n_train, n_test=n_test, device=device)
    engine = engine_from_config(clients, cfg)
    method = get_method(cfg.method)
    if method.client_filter != "none":
        engine.learn_dres(cfg.seed)
    return make_scheduler(engine, server, method, cfg, x_test, y_test,
                          sim_phase_costs=FIXED_COSTS if fixed_costs
                          else None)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Resumable federated service: event-loop scheduling "
                    "with periodic experiment checkpoints")
    add_config_args(ap)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the service runs; cuda raises on a host "
                         "without a CUDA device")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (empty = no checkpointing)")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint every N retired rounds (0 disables; "
                         "requires --ckpt-dir)")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="retain only the newest K checkpoints "
                         "(0 = keep everything)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir "
                         "(falls back to a fresh start when none exists)")
    ap.add_argument("--crash-after-phase", default="",
                    help="fault injection: SIGKILL the process right after "
                         "executing phase node NAME:ROUND (after any "
                         "checkpoint due at that boundary) — the "
                         "kill-and-resume harness hook")
    ap.add_argument("--fixed-phase-costs", action="store_true",
                    help="price the simulated timeline with fixed per-phase "
                         "costs instead of measured wall-clock, making sim "
                         "fields (sim_finish_s, served_model_age_s) "
                         "deterministic and resume bit-for-bit complete")
    ap.add_argument("--json", default="",
                    help="write the full round-log history here on exit")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    crash_at = parse_crash_spec(args.crash_after_phase)
    ckpt_on = bool(args.ckpt_dir) and args.ckpt_every > 0
    keep_last = args.keep_last if args.keep_last > 0 else None

    sched = build_scheduler(cfg, args.dataset, args.n_train, args.n_test,
                            args.fixed_phase_costs, args.device)
    # over a mesh rank 0 alone speaks and writes
    main_rank = fed_mesh.world_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)

    sidecar = (os.path.join(args.ckpt_dir, LOGS_SIDECAR)
               if ckpt_on and main_rank else None)
    if sidecar is not None:
        # the sidecar is appended before the first checkpoint is written
        os.makedirs(args.ckpt_dir, exist_ok=True)
    resumed_from = None
    history: List[RoundLog] = []
    if args.resume and args.ckpt_dir:
        step = latest_step(args.ckpt_dir)
        if step is not None:
            sched.restore(restore_state(args.ckpt_dir, step))
            resumed_from = step
            if sidecar is not None and os.path.exists(sidecar):
                history = _trim_sidecar(sidecar, sched.completed,
                                        len(sched.logs))
            say(f"resumed from checkpoint step {step} "
                f"({sched.completed} rounds already retired)")
    if resumed_from is None:
        sched.begin(0, cfg.rounds)
        if sidecar is not None and os.path.exists(sidecar):
            os.remove(sidecar)  # stale history from a previous service

    while sched.has_pending():
        phase, r, log = sched.step()
        if log is not None:
            if main_rank:
                print_round(log, cfg.num_clients)
            if sidecar is not None:
                # appended before the checkpoint: after a crash the sidecar
                # can only run ahead of the restored state, and
                # _trim_sidecar cuts the overhang on resume
                with open(sidecar, "a") as f:
                    f.write(json.dumps(dataclasses.asdict(log)) + "\n")
            if ckpt_on and sched.completed % args.ckpt_every == 0:
                # every rank snapshots: a mesh engine gathers its state
                tree = sched.snapshot(logs_tail=0).to_tree()
                try:
                    if main_rank:
                        path = save_state(args.ckpt_dir, sched.completed,
                                          tree, keep_last=keep_last)
                        say(f"  checkpoint -> {path}")
                except OSError as e:
                    # the writer already retried with backoff; a service
                    # keeps serving through a storage outage and tries again
                    # at the next boundary
                    say(f"  checkpoint FAILED after retries ({e!r}); "
                        f"continuing without", flush=True)
        if crash_at is not None and (phase, r) == crash_at:
            say(f"crash hook: SIGKILL after ({phase}, {r})", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    logs = history + sched.logs
    if logs:
        mean_age = sum(lg.served_model_age_s for lg in logs) / len(logs)
        say(f"\nserved {len(logs)} rounds  final={logs[-1].mean_acc:.4f}"
            f"  best={max(lg.mean_acc for lg in logs):.4f}"
            f"  mean_model_age={mean_age:.2f}s")
    if args.json and main_rank:
        with open(args.json, "w") as f:
            json.dump([dataclasses.asdict(lg) for lg in logs], f, indent=2)
    return logs


if __name__ == "__main__":
    main()
