"""Scenario: the paper's headline comparison (Table III, strong non-IID),
EdgeFD against the unfiltered ensemble (FedMD) and no collaboration, on
the PyTorch port.

Also prints the last round's ID fraction: the client filter admits mostly
own-class proxy samples, which is why the aggregated teacher stays clean
under extreme heterogeneity. Run (on a CUDA card by default):

    PYTHONPATH=src python examples_torch/edgefd_vs_baselines.py [--device cpu]
"""
import argparse

from repro_torch.common.types import FedConfig
from repro_torch.fed import simulator

ROUNDS = 6
METHODS = ("indlearn", "fedmd", "edgefd")
CONFIG = dict(num_clients=5, rounds=ROUNDS, scenario="strong",
              proxy_batch=300, lr=1e-2)
DATASET = "mnist_feat"
N_TRAIN, N_TEST = 2000, 500


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    finals = {}
    for method in METHODS:
        res = simulator.run(FedConfig(method=method, **CONFIG), DATASET,
                            n_train=N_TRAIN, n_test=N_TEST,
                            device=args.device)
        accs = " ".join(f"{r.mean_acc:.3f}" for r in res.rounds)
        idf = res.rounds[-1].id_fraction
        print(f"{method:10s} | accs: {accs} | final id_frac={idf:.2f}")
        finals[method] = res.final_acc
    print("\nExpected ordering (paper Table III): edgefd > fedmd >> indlearn")
    return finals


if __name__ == "__main__":
    main()
