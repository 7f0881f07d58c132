"""Experiment assembly: dataset → non-IID partition → proxy → clients/server.

KMeans-DRE centroid count per the paper (§IV-A/B):
  strong non-IID → 1 centroid;
  weak non-IID   → one per held label;
  IID            → one per class.

An image dataset (``mnist_like``, ``fashion_like``, ``cifar_like``: NHWC
arrays) gets the Tables I/II CNN zoo, client ``cid`` the architecture of
slot ``cid % 10`` (``models.cnn.get_client_model``; 28-pixel images take
Table I, others Table II), and the FedDF student client 0's; every
convolution runs in fp32 (``pin_fp32``). A feature dataset gets the
shared MLP zoo; a token dataset (``lm_tokens``:
(n, S) integer sequences) gets one transformer client per cid,
``core.fd_trainer.TransformerClientModel``: by default the reference's
reduced granite backbone (``reduced(get_arch("granite-8b"), layers=2,
d_model=64, vocab=K)``, vocab = the label space, the last-position sample
logit convention); ``transformer_cfg`` replaces it, for example with
granite-8b's published widths. Transformer weights are drawn on the target
device from a generator of that device.

``build_experiment`` also accepts injected dataset arrays, per-client
initial parameters (CNN or MLP layer lists, or transformer pytrees),
per-client k-means seeds and KuLSIF auxiliary samples, and the FedDF student's
initial parameters: handed the reference's, it builds the same experiment
the JAX package builds, which is how the tests hold the port against a
live reference run.

Only the ported slice runs: every method of Table III on the image,
feature and token datasets, the CNN zoo and the shared and mixed MLP zoos
(``zoo="mixed"``: three widths by ``cid % 3``, one optimizer and one
``arch_key`` a width), the loop engine and, on image and feature data,
the cohort engine (with wave streaming), every scheduler knob (sync and
overlapping rounds, partial participation with its three policies and the
staleness buffer, churn, dropout, arrival traces, admission under
``max_pending_reports``, concurrent cohorts), and the server at full
size: two-tier edge aggregators, the robust reducers, the payload-fault
injector, the sanitize pass and trust/quarantine. ``run`` first refuses a
malformed config with ``ValueError``, as the reference's does
(``participation.validate_config``, then ``scheduler.validate_config``);
``check_slice`` then refuses the rest (the watchdog, the multi-device
mesh, token data on the cohort engine) with ``NotImplementedError``
naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.types import ArchConfig, FedConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.core.fd_trainer import TransformerClientModel
from repro_torch.core.methods import get_method
from repro_torch.core.protocol import ExperimentResult, run_experiment
from repro_torch.data.partition import partition
from repro_torch.data.proxy import build_proxy
from repro_torch.data.synthetic import (SPECS, Dataset, check_dataset,
                                        make_dataset)
from repro_torch.fed import participation, scheduler
from repro_torch.fed.client import Client
from repro_torch.fed.server import Server
from repro_torch.kernels import dispatch
from repro_torch.models.cnn import MLPClassifier, get_client_model
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


def pin_fp32() -> None:
    """Keep convolutions in IEEE fp32 on the card, as the reference's f32
    computes them: PyTorch lets cuDNN convolutions use TF32 by default,
    which moves a CNN's logits far beyond the parity tolerances (its
    matmul default is already fp32). This sets a process-wide flag: every
    later convolution of the process, the caller's too, runs in fp32."""
    torch.backends.cudnn.allow_tf32 = False


def hw_guess(x) -> int:
    return np.asarray(x).shape[1]


def check_slice(cfg: FedConfig, dataset_name: str) -> None:
    """Raise ``NotImplementedError`` for any setting outside the ported
    slice, naming the ROADMAP queue A item that will bring it (and
    ``KeyError`` for an unknown method)."""
    get_method(cfg.method)
    check_dataset(dataset_name)
    resolve_zoo(cfg.zoo)
    refused = [
        (cfg.num_devices != 0 or cfg.model_shards != 0,
         "num_devices/model_shards", "10 (multi-device)"),
        (cfg.engine == "cohort" and SPECS[dataset_name].seq_len > 0,
         "token data on engine='cohort'", "5 (the cohort engine)"),
        (cfg.watchdog, "watchdog",
         "8 (state and service: the watchdog rolls back to a snapshot)"),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP queue A item {item}")


def _mixed_hidden(mlp_hidden: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """Three MLP widths for the mixed feature-mode zoo: the configured
    hidden stack, a half-width and a double-width variant (clients cycle
    through them by ``cid % 3``, giving three cohorts)."""
    return [tuple(mlp_hidden),
            tuple(max(4, v // 2) for v in mlp_hidden),
            tuple(v * 2 for v in mlp_hidden)]


def _centroids_for(scenario: str, num_labels: int, num_classes: int) -> int:
    if scenario == "strong":
        return 1
    if scenario == "weak":
        return max(1, num_labels)
    return num_classes


def default_transformer_cfg(num_classes: int) -> ArchConfig:
    """The reference's token-mode backbone: granite-8b reduced to 2 layers
    and d_model 64, with vocab = the dataset's label space."""
    return reduced(get_arch("granite-8b"), layers=2, d_model=64,
                   vocab=num_classes)


def build_experiment(cfg: FedConfig, dataset_name: str = "mnist_feat", *,
                     n_train: int = 5000, n_test: int = 1000,
                     mlp_hidden: Tuple[int, ...] = (256, 128),
                     transformer_cfg: Optional[ArchConfig] = None,
                     device="cuda", dataset: Optional[Dataset] = None,
                     init_params: Optional[Sequence] = None,
                     kmeans_inits: Optional[Sequence[np.ndarray]] = None,
                     kulsif_aux: Optional[Sequence[np.ndarray]] = None,
                     student_params=None
                     ) -> Tuple[List[Client], Server, np.ndarray, np.ndarray]:
    """Build clients and server on ``device``.

    ``dataset`` replaces the generated one; ``transformer_cfg`` replaces
    the token mode's default backbone; ``init_params[cid]`` (the
    reference's parameter list of a CNN or an MLP, or its transformer
    pytree) replaces client ``cid``'s random init; ``kmeans_inits[cid]``
    (k, d) replaces its k-means++ seeding and ``kulsif_aux[cid]``
    (num_aux, d) its KuLSIF auxiliary draw; ``student_params`` replaces the
    FedDF student's random init."""
    device = torch.device(device)
    pin_fp32()
    ds = (dataset if dataset is not None
          else make_dataset(dataset_name, n_train=n_train, n_test=n_test,
                            seed=cfg.seed))
    clients_data = partition(ds.x, ds.y, num_clients=cfg.num_clients,
                             num_classes=ds.num_classes,
                             scenario=cfg.scenario,
                             labels_per_client=cfg.labels_per_client,
                             seed=cfg.seed)
    proxy = build_proxy(clients_data, cfg.proxy_fraction, seed=cfg.seed)
    server = Server(proxy, seed=cfg.seed,
                    num_edges=cfg.num_edge_aggregators,
                    max_pending_reports=cfg.max_pending_reports,
                    robust_aggregation=cfg.robust_aggregation,
                    trim_frac=cfg.trim_frac,
                    sanitize=cfg.sanitize_reports,
                    quarantine_threshold=cfg.quarantine_threshold,
                    trust_ewma=cfg.trust_ewma,
                    quarantine_rounds=cfg.quarantine_rounds,
                    # the watchdog ranks suspects by outlier distance
                    track_outliers=(cfg.watchdog
                                    or cfg.quarantine_threshold > 0),
                    device=device)
    method = get_method(cfg.method)
    # token mode: (n, S) integer sequences -> transformer clients
    token_mode = ds.x.ndim == 2 and np.issubdtype(ds.x.dtype, np.integer)
    if ds.x.ndim == 4:
        # image mode: the Tables I/II zoo, one slot a client, drawn on the
        # CPU from one generator and moved to the device
        img_ds = "mnist" if hw_guess(ds.x) == 28 else "cifar10"
        init_gen = torch.Generator().manual_seed(cfg.seed)

        def make_model(cid):
            spec, hw, ch = get_client_model(cid, img_ds)
            return spec.build(hw, ch, generator=init_gen, device=device)

        def arch_key(cid):
            return ("cnn", img_ds, cid % 10)           # Tables I/II slot
    elif token_mode:
        t_cfg = transformer_cfg or default_transformer_cfg(ds.num_classes)
        # drawn on the device: a full-width client is 436 M values
        init_gen = torch.Generator(device=device).manual_seed(cfg.seed)

        def make_model(cid):
            return TransformerClientModel(
                t_cfg, generator=init_gen, device=device,
                kernel_backend=cfg.kernel_backend)

        def arch_key(cid):
            return ("transformer", t_cfg.name)
    else:
        # "shared": one MLP width for everyone; "mixed": three widths
        # cycled by cid % 3, so the cohort engine sees three cohorts
        d_in = ds.x.shape[-1]
        init_gen = torch.Generator().manual_seed(cfg.seed)
        variants = ([tuple(mlp_hidden)] if resolve_zoo(cfg.zoo) == "shared"
                    else _mixed_hidden(tuple(mlp_hidden)))

        def make_model(cid):
            return MLPClassifier(d_in, variants[cid % len(variants)],
                                 ds.num_classes, generator=init_gen,
                                 device=device)

        def arch_key(cid):
            return ("mlp", d_in, *variants[cid % len(variants)],
                    ds.num_classes)
    # one optimizer and one init stream shared by the whole population
    shared_opt = sgd(cfg.lr)
    clients: List[Client] = []
    for cid, cd in enumerate(clients_data):
        model = make_model(cid)
        if init_params is not None:
            model.load_jax_params(init_params[cid])
        dre = method.make_dre(
            num_centroids=_centroids_for(cfg.scenario, len(cd.labels),
                                         ds.num_classes),
            threshold=cfg.id_threshold, kernel_backend=cfg.kernel_backend)
        clients.append(Client(
            cid, model, shared_opt, cd.x, cd.y, dre,
            num_classes=ds.num_classes, temperature=cfg.temperature,
            distill_loss=method.distill_loss, seed=cfg.seed,
            kernel_backend=cfg.kernel_backend,
            dre_init=None if kmeans_inits is None else kmeans_inits[cid],
            dre_aux=None if kulsif_aux is None else kulsif_aux[cid],
            arch_key=arch_key(cid)))
    if method.server_distill:
        # the FedDF student (client 0's architecture, the configured MLP
        # width on feature data) is drawn after the client loop, as in the
        # reference, so the clients' inits do not depend on the method
        student = make_model(0)
        if student_params is not None:
            student.load_jax_params(student_params)
        server.attach_student(student, shared_opt,
                              temperature=cfg.temperature,
                              kernel_backend=cfg.kernel_backend)
    return clients, server, ds.x_test, ds.y_test


def run(cfg: FedConfig, dataset_name: str = "mnist_feat", *,
        n_train: int = 5000, n_test: int = 1000, device="cuda",
        transformer_cfg: Optional[ArchConfig] = None,
        progress=None,
        sim_phase_costs: Optional[Dict[str, float]] = None
        ) -> ExperimentResult:
    """Build the experiment of ``cfg`` on ``device`` and run it;
    ``sim_phase_costs`` prices the simulated timeline with fixed phase
    costs (``fed.scheduler.RoundScheduler``)."""
    # fail fast on a bad participation/scheduler config (the reference's
    # checks, in its order), a config outside the slice, a bad backend or a
    # missing device, before any client is built
    participation.validate_config(cfg)
    scheduler.validate_config(cfg)
    check_slice(cfg, dataset_name)
    dispatch.resolve(cfg.kernel_backend)
    device = resolve_device(device)
    clients, server, x_test, y_test = build_experiment(
        cfg, dataset_name, n_train=n_train, n_test=n_test, device=device,
        transformer_cfg=transformer_cfg)
    return run_experiment(clients, server, cfg.method, cfg, x_test, y_test,
                          progress=progress, sim_phase_costs=sim_phase_costs)
