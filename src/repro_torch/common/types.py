"""Configuration of a federated-distillation experiment.

``FedConfig`` copies the reference ``repro.common.types.FedConfig`` field
for field, with the same names and defaults, so one set of keyword
arguments configures both packages. Fields whose feature is not ported yet
are still present; ``repro_torch.launch.fed_train`` refuses values that
would need them (see ``fed.simulator.check_slice``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Configuration of a federated-distillation experiment (Algorithm 1)."""
    num_clients: int = 10
    rounds: int = 20
    local_epochs: int = 1
    distill_epochs: int = 1
    # server-side student epochs per ensemble-distillation round
    # (method="server_distill" only); 0 = same as distill_epochs
    server_distill_epochs: int = 0
    proxy_fraction: float = 0.2      # alpha — fraction of private data shared
    proxy_batch: int = 256           # |I_r| proxy indices per round
    id_threshold: Optional[float] = None  # T^ID; None = per-client calibration
    temperature: float = 3.0         # distillation temperature
    distill_weight: float = 1.0      # lambda on the KL term
    scenario: str = "strong"         # strong | weak | iid
    labels_per_client: int = 3       # weak non-IID overlap degree
    method: str = "edgefd"
    lr: float = 1e-2
    batch_size: int = 64
    feature_extractor: bool = False  # CIFAR10*-style pre-extracted features
    seed: int = 0
    # execution engine: "loop" drives clients one by one; "cohort" (stacked
    # homogeneous clients) is not ported yet
    engine: str = "loop"
    # device mesh over the cohort client axis (cohort engine only)
    num_devices: int = 0
    mesh_axis: str = "clients"
    # model shards per client (cohort engine with a mesh only)
    model_shards: int = 0
    # partial participation: fraction of clients that train/report each
    # round; 1.0 = every client (the paper's setting)
    participation_fraction: float = 1.0
    participation_policy: str = "uniform"
    staleness_decay: float = 0.0
    # round scheduling: "sync" = lockstep Algorithm-1 phase order; "overlap"
    # pipelines rounds (not ported yet); "auto" = sync unless the
    # REPRO_ROUND_MODE env var says otherwise
    round_mode: str = "auto"
    max_inflight: int = 2
    # simulated straggler clock (pure accounting in the reference)
    straggler_factor: float = 4.0
    # client-axis wave streaming (cohort engine only)
    wave_size: int = 0
    # two-tier hierarchical server; 1 = flat single-tier server
    num_edge_aggregators: int = 1
    # trace-driven arrival processes on the simulated timeline
    arrival_process: str = "static"
    arrival_spread: float = 0.0
    arrival_bursts: int = 4
    # per-round churn and mid-round dropout probabilities
    churn_prob: float = 0.0
    dropout_prob: float = 0.0
    # admission/backpressure cap on in-flight reports; 0 = unbounded
    max_pending_reports: int = 0
    # kernel backend for the round hot paths (repro_torch.kernels.dispatch):
    # "auto" = hand-written CUDA kernels for tensors on a CUDA device, the
    # plain PyTorch version for tensors on the CPU (also honors the
    # REPRO_KERNEL_BACKEND env var / kernel_backend() context manager);
    # "cuda" forces the kernels wherever the tensors are on a CUDA device;
    # "torch" forces the plain PyTorch version. The reference's "pallas"
    # and "jnp" are accepted as aliases of "cuda" and "torch".
    kernel_backend: str = "auto"
    # client model zoo: "shared" = one MLP architecture for every client;
    # "mixed" (not ported yet); "auto" = shared unless REPRO_ZOO says so
    zoo: str = "auto"
    # per-cohort phase nodes in the scheduler (not ported yet)
    concurrent_cohorts: bool = False
    # -- payload-fault injection (not ported yet) ----------------------------
    fault_mode: str = "none"
    fault_prob: float = 0.0
    byzantine_frac: float = 0.0
    fault_start: int = 0
    fault_duration: int = 0
    # -- robust knowledge aggregation ----------------------------------------
    # "mean" is ported; trimmed_mean | median | krum_row are not yet
    robust_aggregation: str = "mean"
    trim_frac: float = 0.2
    # server sanitize pass: scrub non-finite report rows at ingest and
    # account them per client (RoundLog.scrubbed_rows). On by default — an
    # exact no-op on finite reports.
    sanitize_reports: bool = True
    # -- trust & quarantine (not ported yet) ---------------------------------
    quarantine_threshold: float = 0.0
    trust_ewma: float = 0.5
    quarantine_rounds: int = 2
    # -- divergence watchdog (not ported yet) --------------------------------
    watchdog: bool = False
    watchdog_acc_drop: float = 0.2
    watchdog_loss_factor: float = 10.0
    watchdog_max_rollbacks: int = 3
