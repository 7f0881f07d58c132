"""Experiment assembly: dataset → non-IID partition → proxy → clients/server.

KMeans-DRE centroid count per the paper (§IV-A/B):
  strong non-IID → 1 centroid;
  weak non-IID   → one per held label;
  IID            → one per class.

``build_experiment`` also accepts injected dataset arrays, per-client
initial parameters and per-client k-means seeds: handed the reference's,
it builds the same experiment the JAX package builds, which is how the
tests hold the port against a live reference run.

Only the ported slice runs: feature-mode datasets, the shared MLP zoo,
the loop engine with sync rounds and full participation, the flat server
with the mean aggregate, and EdgeFD. ``check_slice`` refuses everything
else with ``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.types import FedConfig
from repro_torch.core.methods import get_method
from repro_torch.core.protocol import ExperimentResult, run_experiment
from repro_torch.data.partition import partition
from repro_torch.data.proxy import build_proxy
from repro_torch.data.synthetic import Dataset, check_dataset, make_dataset
from repro_torch.fed.client import Client
from repro_torch.fed.scheduler import resolve_round_mode
from repro_torch.fed.server import Server
from repro_torch.kernels import dispatch
from repro_torch.models.cnn import MLPClassifier
from repro_torch.optim.optimizers import sgd

ZOOS = ("shared", "mixed")


def resolve_zoo(zoo: str) -> str:
    """``"auto"`` defers to ``REPRO_ZOO``; no opinion means ``"shared"``."""
    if zoo == "auto":
        zoo = os.environ.get("REPRO_ZOO", "").strip() or "auto"
        if zoo == "auto":
            zoo = "shared"
    if zoo not in ZOOS:
        raise ValueError(f"zoo must be one of {ZOOS} or 'auto', got {zoo!r}")
    return zoo


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA request on a host without
    a CUDA device raises: the port never moves itself to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; ask for the CPU "
                           "explicitly (--device cpu) to run there")
    return dev


def check_slice(cfg: FedConfig, dataset_name: str) -> None:
    """Raise ``NotImplementedError`` for any setting outside the ported
    slice, naming the ROADMAP queue A item that will bring it."""
    get_method(cfg.method)
    check_dataset(dataset_name)
    refused = [
        (cfg.engine != "loop", f"engine={cfg.engine!r}",
         "5 (the cohort engine)"),
        (cfg.num_devices != 0 or cfg.model_shards != 0,
         "num_devices/model_shards", "10 (multi-device)"),
        (cfg.wave_size != 0, "wave_size", "5 (the cohort engine)"),
        (resolve_zoo(cfg.zoo) != "shared", "zoo='mixed'",
         "5 (the cohort engine)"),
        (resolve_round_mode(cfg.round_mode) != "sync", "round_mode='overlap'",
         "6 (the full scheduler)"),
        (cfg.participation_fraction < 1.0, "participation_fraction < 1",
         "6 (the full scheduler)"),
        (cfg.churn_prob > 0.0 or cfg.dropout_prob > 0.0,
         "churn/dropout > 0", "6 (the full scheduler)"),
        (cfg.max_pending_reports > 0, "max_pending_reports > 0",
         "6 (the full scheduler)"),
        (cfg.concurrent_cohorts, "concurrent_cohorts",
         "6 (the full scheduler)"),
        (cfg.fault_mode != "none", f"fault_mode={cfg.fault_mode!r}",
         "7 (server scale and robustness)"),
        (cfg.num_edge_aggregators > 1, "num_edge_aggregators > 1",
         "7 (server scale and robustness)"),
        (cfg.robust_aggregation != "mean",
         f"robust_aggregation={cfg.robust_aggregation!r}",
         "7 (server scale and robustness)"),
        (cfg.quarantine_threshold > 0.0, "quarantine_threshold > 0",
         "7 (server scale and robustness)"),
        (cfg.watchdog, "watchdog", "7 (server scale and robustness)"),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP queue A item {item}")


def _centroids_for(scenario: str, num_labels: int, num_classes: int) -> int:
    if scenario == "strong":
        return 1
    if scenario == "weak":
        return max(1, num_labels)
    return num_classes


def build_experiment(cfg: FedConfig, dataset_name: str = "mnist_feat", *,
                     n_train: int = 5000, n_test: int = 1000,
                     mlp_hidden: Tuple[int, ...] = (256, 128),
                     device="cuda", dataset: Optional[Dataset] = None,
                     init_params: Optional[Sequence[list]] = None,
                     kmeans_inits: Optional[Sequence[np.ndarray]] = None
                     ) -> Tuple[List[Client], Server, np.ndarray, np.ndarray]:
    """Build clients and server on ``device``.

    ``dataset`` replaces the generated one; ``init_params[cid]`` (the
    reference's ``[{'w', 'b'}, …]`` per layer) replaces client ``cid``'s
    random init; ``kmeans_inits[cid]`` (k, d) replaces its k-means++
    seeding."""
    device = torch.device(device)
    ds = (dataset if dataset is not None
          else make_dataset(dataset_name, n_train=n_train, n_test=n_test,
                            seed=cfg.seed))
    clients_data = partition(ds.x, ds.y, num_clients=cfg.num_clients,
                             num_classes=ds.num_classes,
                             scenario=cfg.scenario,
                             labels_per_client=cfg.labels_per_client,
                             seed=cfg.seed)
    proxy = build_proxy(clients_data, cfg.proxy_fraction, seed=cfg.seed)
    server = Server(proxy, seed=cfg.seed, sanitize=cfg.sanitize_reports,
                    device=device)
    method = get_method(cfg.method)
    d_in = ds.x.shape[-1]
    # one optimizer and one init stream shared by the whole population
    shared_opt = sgd(cfg.lr)
    init_gen = torch.Generator().manual_seed(cfg.seed)
    clients: List[Client] = []
    for cid, cd in enumerate(clients_data):
        mlp = MLPClassifier(d_in, tuple(mlp_hidden), ds.num_classes,
                            generator=init_gen, device=device)
        if init_params is not None:
            mlp.load_jax_params(init_params[cid])
        dre = method.make_dre(
            num_centroids=_centroids_for(cfg.scenario, len(cd.labels),
                                         ds.num_classes),
            threshold=cfg.id_threshold, kernel_backend=cfg.kernel_backend)
        clients.append(Client(
            cid, mlp, shared_opt, cd.x, cd.y, dre,
            num_classes=ds.num_classes, temperature=cfg.temperature,
            seed=cfg.seed, kernel_backend=cfg.kernel_backend,
            dre_init=None if kmeans_inits is None else kmeans_inits[cid]))
    return clients, server, ds.x_test, ds.y_test


def run(cfg: FedConfig, dataset_name: str = "mnist_feat", *,
        n_train: int = 5000, n_test: int = 1000, device="cuda",
        progress=None) -> ExperimentResult:
    # fail fast on a config outside the slice, a bad backend or a missing
    # device, before any client is built
    check_slice(cfg, dataset_name)
    dispatch.resolve(cfg.kernel_backend)
    device = resolve_device(device)
    clients, server, x_test, y_test = build_experiment(
        cfg, dataset_name, n_train=n_train, n_test=n_test, device=device)
    return run_experiment(clients, server, cfg.method, cfg, x_test, y_test,
                          progress=progress)
