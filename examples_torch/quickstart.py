"""Quickstart: EdgeFD through the PyTorch port's public API.

Five clients, strong non-IID synthetic data, KMeans-DRE client filtering
(the Lloyd-step and min-distance kernels on the card), five
federated-distillation rounds, the fused KL loss in every distill step.
Run (on a CUDA card by default):

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Every knob of the reference's quickstart is a ``FedConfig`` field of the
same name here (``repro_torch.common.types.FedConfig`` copies it field for
field); ``python -m repro_torch.launch.fed_train --help`` spells them as
flags, and ``python -m repro_torch.launch.fed_serve`` runs the same
experiment as a checkpointed, resumable service.
"""
import argparse

from repro_torch.common.types import FedConfig
from repro_torch.fed import simulator

CONFIG = dict(
    num_clients=5,
    rounds=5,
    method="edgefd",          # or fedmd, selective-fd, fkd, indlearn,
                              # server_distill, ...: Table III's nine
    scenario="strong",        # strong | weak | iid
    proxy_fraction=0.2,       # alpha: 20% of private data shared as proxy
    proxy_batch=300,          # |I_r| proxy samples a round
    id_threshold=None,        # None: per-client quantile calibration
    lr=1e-2,
    engine="cohort",          # stacked clients; "loop": same results
    zoo="auto",
    concurrent_cohorts=False,
    num_devices=0,            # a mesh needs a launcher: see fed_train
    model_shards=0,
    wave_size=0,
    num_edge_aggregators=1,
    arrival_process="static",
    arrival_spread=0.0,
    churn_prob=0.0,
    dropout_prob=0.0,
    participation_fraction=1.0,
    participation_policy="uniform",
    staleness_decay=0.0,
    round_mode="auto",
    max_inflight=2,
    straggler_factor=4.0,
    max_pending_reports=0,
    fault_mode="none",
    byzantine_frac=0.0,
    robust_aggregation="mean",
    sanitize_reports=True,
    quarantine_threshold=0.0,
    watchdog=False,
    kernel_backend="auto",    # the CUDA kernels on the card, plain
                              # PyTorch for tensors on the CPU
)
DATASET = "mnist_feat"
N_TRAIN, N_TEST = 2000, 500


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    result = simulator.run(FedConfig(**CONFIG), dataset_name=DATASET,
                           n_train=N_TRAIN, n_test=N_TEST,
                           device=args.device,
                           progress=lambda log: print(
                               f"round {log.round}: acc={log.mean_acc:.3f} "
                               f"id_frac={log.id_fraction:.2f}"))
    print(f"\nEdgeFD final accuracy: {result.final_acc:.3f}")
    print(f"bytes uploaded (ID logits only): "
          f"{result.rounds[-1].bytes_up / 1e6:.2f} MB")
    return result


if __name__ == "__main__":
    main()
