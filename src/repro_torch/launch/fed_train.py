"""Federated-distillation entry point — the paper's main experiment on a GPU.

``python -m repro_torch.launch.fed_train --method edgefd --scenario strong \
      --dataset mnist_feat --rounds 10 [--device cuda|cpu]``

``--method`` takes every method of Table III (``repro_torch.core.methods``);
``--dataset`` takes the image datasets (``mnist_like``, ``fashion_like``,
``cifar_like``: the Tables I/II CNN zoo, convolutions in fp32), the
feature datasets and ``lm_tokens`` (transformer clients).

Takes the reference's flags (``repro.launch.fed_train.add_config_args``)
plus ``--device``, which defaults to ``cuda``: without a CUDA device the
run raises unless ``--device cpu`` asks for the CPU. The scheduler's flags
(``--participation``, ``--policy``, ``--staleness-decay``,
``--round-mode``, ``--max-inflight``, ``--max-pending-reports``,
``--straggler-factor``, ``--arrival-*``, ``--churn``, ``--dropout``,
``--concurrent-cohorts``) reach the run; each round's line and ``--json``
carry its participants, mean staleness, simulated finish and served-model
age. The robustness flags reach the run too: ``--fault-mode``,
``--fault-prob``, ``--byzantine-frac``, ``--fault-start`` and
``--fault-duration`` (the payload-fault injector),
``--robust-aggregation`` and ``--trim-frac`` (the robust reducers),
``--edge-aggregators`` (the two-tier server), ``--no-sanitize``, and
``--quarantine-threshold``, ``--quarantine-rounds`` and ``--trust-ewma``
(trust and quarantine); a round's line shows its scrubbed rows and
quarantined clients when there are any. ``--watchdog`` (with
``--watchdog-acc-drop``, ``--watchdog-loss-factor`` and
``--watchdog-max-rollbacks``) rolls a sick round back to the last healthy
one and quarantines its suspects (``--json`` carries each round's
``rollbacks``). ``--engine cohort --devices N [--model-shards M]`` lays
the cohort engine over a mesh of N ranks, one process a rank
(``repro_torch.fed.mesh``), M of them a client's model shards::

    python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.fed_train --engine cohort --devices 2 \
        --model-shards 2 --dataset lm_tokens

(NCCL on cards, one rank a card; two ranks sharing a card need
``REPRO_DIST_BACKEND=gloo``; on the CPU, gloo and ``--device cpu``). Rank
0 alone prints and writes ``--json``; a request for more than one rank
outside the launcher raises, naming it. ``launch.fed_serve`` is the
resumable service over the same flags.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.common.types import FedConfig
from repro_torch.core import methods
from repro_torch.fed import mesh as fed_mesh
from repro_torch.fed import simulator

# short labels for the per-phase wall-clock breakdown (RoundLog.phase_s)
PHASE_ABBREV = {"local_train": "lt", "report": "rep", "aggregate": "agg",
                "server_distill": "sdist", "distill": "dist", "eval": "ev"}


def add_config_args(ap: argparse.ArgumentParser) -> None:
    """Install every experiment-defining flag (the ``FedConfig`` surface),
    the same flags as ``repro.launch.fed_train``."""
    ap.add_argument("--method", default="edgefd",
                    choices=sorted(methods.METHODS))
    ap.add_argument("--scenario", default="strong",
                    choices=["strong", "weak", "iid"])
    ap.add_argument("--dataset", default="mnist_feat",
                    help="synthetic dataset: mnist_like / fashion_like / "
                         "cifar_like = images (the Tables I/II CNN zoo); "
                         "*_feat = flat features (MLP zoo); lm_tokens = "
                         "token sequences (transformer clients, the reduced "
                         "granite backbone)")
    ap.add_argument("--engine", default="loop", choices=["loop", "cohort"])
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--model-shards", type=int, default=0)
    ap.add_argument("--wave-size", type=int, default=0)
    ap.add_argument("--edge-aggregators", type=int, default=1)
    ap.add_argument("--arrival-process", default="static",
                    choices=["static", "poisson", "bursty"])
    ap.add_argument("--arrival-spread", type=float, default=0.0)
    ap.add_argument("--arrival-bursts", type=int, default=4)
    ap.add_argument("--churn", type=float, default=0.0)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--policy", default="uniform",
                    choices=["uniform", "weighted", "roundrobin"])
    ap.add_argument("--staleness-decay", type=float, default=0.0)
    ap.add_argument("--round-mode", default="auto",
                    choices=["auto", "sync", "overlap"])
    ap.add_argument("--max-inflight", type=int, default=2)
    ap.add_argument("--max-pending-reports", type=int, default=0)
    ap.add_argument("--straggler-factor", type=float, default=4.0)
    ap.add_argument("--server-distill-epochs", type=int, default=0)
    ap.add_argument("--zoo", default="auto",
                    choices=["auto", "shared", "mixed"])
    ap.add_argument("--concurrent-cohorts", action="store_true")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["auto", "cuda", "torch", "pallas", "jnp"],
                    help="hot-path kernel dispatch "
                         "(repro_torch.kernels.dispatch): auto = CUDA "
                         "kernels for tensors on a CUDA device "
                         "(REPRO_KERNEL_BACKEND overrides); cuda = force "
                         "the kernels; torch = force the plain PyTorch "
                         "version; pallas/jnp = aliases of cuda/torch")
    ap.add_argument("--fault-mode", default="none",
                    choices=["none", "nan", "random_logits", "scaled",
                             "colluding_flip", "stale_replay"])
    ap.add_argument("--fault-prob", type=float, default=0.0)
    ap.add_argument("--byzantine-frac", type=float, default=0.0)
    ap.add_argument("--fault-start", type=int, default=0)
    ap.add_argument("--fault-duration", type=int, default=0)
    ap.add_argument("--robust-aggregation", default="mean",
                    choices=["mean", "trimmed_mean", "median", "krum_row"])
    ap.add_argument("--trim-frac", type=float, default=0.2)
    ap.add_argument("--no-sanitize", action="store_true")
    ap.add_argument("--quarantine-threshold", type=float, default=0.0)
    ap.add_argument("--quarantine-rounds", type=int, default=2)
    ap.add_argument("--trust-ewma", type=float, default=0.5)
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--watchdog-acc-drop", type=float, default=0.2)
    ap.add_argument("--watchdog-loss-factor", type=float, default=10.0)
    ap.add_argument("--watchdog-max-rollbacks", type=int, default=3)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--proxy-fraction", type=float, default=0.2)
    ap.add_argument("--proxy-batch", type=int, default=512)
    ap.add_argument("--threshold", type=float, default=-1.0,
                    help="<0 = per-client quantile calibration")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--n-train", type=int, default=5000)
    ap.add_argument("--n-test", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)


def config_from_args(args: argparse.Namespace) -> FedConfig:
    """Build the ``FedConfig`` from ``add_config_args`` output."""
    return FedConfig(
        num_clients=args.clients,
        rounds=args.rounds,
        method=args.method,
        scenario=args.scenario,
        proxy_fraction=args.proxy_fraction,
        proxy_batch=args.proxy_batch,
        id_threshold=None if args.threshold < 0 else args.threshold,
        lr=args.lr,
        seed=args.seed,
        engine=args.engine,
        num_devices=args.devices,
        model_shards=args.model_shards,
        wave_size=args.wave_size,
        num_edge_aggregators=args.edge_aggregators,
        arrival_process=args.arrival_process,
        arrival_spread=args.arrival_spread,
        arrival_bursts=args.arrival_bursts,
        churn_prob=args.churn,
        dropout_prob=args.dropout,
        participation_fraction=args.participation,
        participation_policy=args.policy,
        staleness_decay=args.staleness_decay,
        round_mode=args.round_mode,
        max_inflight=args.max_inflight,
        max_pending_reports=args.max_pending_reports,
        straggler_factor=args.straggler_factor,
        kernel_backend=args.kernel_backend,
        server_distill_epochs=args.server_distill_epochs,
        zoo=args.zoo,
        concurrent_cohorts=args.concurrent_cohorts,
        fault_mode=args.fault_mode,
        fault_prob=args.fault_prob,
        byzantine_frac=args.byzantine_frac,
        fault_start=args.fault_start,
        fault_duration=args.fault_duration,
        robust_aggregation=args.robust_aggregation,
        trim_frac=args.trim_frac,
        sanitize_reports=not args.no_sanitize,
        quarantine_threshold=args.quarantine_threshold,
        trust_ewma=args.trust_ewma,
        quarantine_rounds=args.quarantine_rounds,
        watchdog=args.watchdog,
        watchdog_acc_drop=args.watchdog_acc_drop,
        watchdog_loss_factor=args.watchdog_loss_factor,
        watchdog_max_rollbacks=args.watchdog_max_rollbacks,
    )


def print_round(log, num_clients: int) -> None:
    """One progress line per retired round: with partial participation the
    participant count and the mean staleness, the rows the sanitize pass
    scrubbed and the clients quarantined when there are any, then the
    round's finish on the simulated timeline, the served model's age there
    and the phase breakdown."""
    extra = ""
    if log.server_student_acc is not None:
        extra += f"  student={log.server_student_acc:.4f}"
    if log.participants is not None:
        extra += (f"  part={len(log.participants)}/{num_clients}"
                  f"  stale={log.mean_staleness:.2f}")
    if log.scrubbed_rows:
        extra += f"  scrubbed={log.scrubbed_rows}"
    if log.quarantined:
        extra += f"  quarantined={log.quarantined}"
    if log.phase_s:
        breakdown = " ".join(f"{PHASE_ABBREV.get(k, k)}={v:.3f}"
                             for k, v in log.phase_s.items())
        extra += (f"  sim={log.sim_finish_s:.2f}s"
                  f"  age={log.served_model_age_s:.2f}s  [{breakdown}]")
    print(f"round {log.round:3d}  acc={log.mean_acc:.4f}  "
          f"id={log.id_fraction:.2f}  local={log.local_loss:.3f}  "
          f"distill={log.distill_loss:.3f}  "
          f"up={log.bytes_up/1e6:.1f}MB{extra}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_config_args(ap)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the experiment runs; cuda raises on a host "
                         "without a CUDA device")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    def progress(log):
        if fed_mesh.world_rank() == 0:     # over a mesh, rank 0 speaks
            print_round(log, args.clients)
    res = simulator.run(cfg, args.dataset, n_train=args.n_train,
                        n_test=args.n_test, device=args.device,
                        progress=progress)
    if fed_mesh.world_rank() != 0:
        return res
    print(f"\n{args.method} / {args.scenario} / {args.dataset} on "
          f"{args.device}: final={res.final_acc:.4f} best={res.best_acc:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"method": res.method, "scenario": res.scenario,
                       "device": args.device, "final": res.final_acc,
                       "best": res.best_acc,
                       "rounds": [vars(r) for r in res.rounds]}, f, indent=2)
    return res


if __name__ == "__main__":
    main()
