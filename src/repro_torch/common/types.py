"""Typed configuration objects: architectures and federated experiments.

``ArchConfig`` (with ``AttentionKind``, ``MoEConfig`` and ``InputShape``)
copies the reference ``repro.common.types`` records field for field: the
model zoo (``repro_torch.models.transformer``) builds its modules from it
and ``repro_torch.configs`` holds the published architectures.

``FedConfig`` copies the reference ``repro.common.types.FedConfig`` field
for field, with the same names and defaults, so one set of keyword
arguments configures both packages. Fields whose feature is not ported yet
are still present; ``repro_torch.launch.fed_train`` refuses values that
would need them (see ``fed.simulator.check_slice``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class AttentionKind(str, enum.Enum):
    FULL = "full"                  # causal full attention
    SLIDING = "sliding"            # sliding-window causal attention
    LOCAL_HYBRID = "local_hybrid"  # RG-LRU blocks interleaved w/ local attn
    RECURRENT = "recurrent"        # attention-free (xLSTM)
    ENCODER = "encoder"            # bidirectional, encoder-only (audio)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor used for fixed-shape expert dispatch (TPU-friendly)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    moe: Optional[MoEConfig] = None
    attention: AttentionKind = AttentionKind.FULL
    qkv_bias: bool = False                  # qwen2.5 style
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # vlm: every `cross_attn_every` layers one cross-attention layer is
    # inserted (llama-3.2-vision style); the vision tokens come in as a
    # stubbed precomputed embedding input.
    cross_attn_every: int = 0
    num_vision_tokens: int = 0
    # hybrid (recurrentgemma): pattern period, e.g. 3 => (rglru, rglru, attn)
    hybrid_period: int = 0
    local_window: int = 2048                # local/sliding attn window
    # ssm (xlstm): ratio of mLSTM blocks (rest sLSTM)
    slstm_every: int = 0
    # audio: encoder-only, frontend stubbed; inputs are frame embeddings
    frontend_stub_dim: int = 0
    dtype: str = "bfloat16"
    # citation for the config (source paper / model card)
    source: str = ""
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_decoder(self) -> bool:
        return self.attention != AttentionKind.ENCODER

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D roofline term)."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * h
        if self.moe is not None:
            ffn = self.moe.num_experts * 3 * d * self.d_ff + d * self.moe.num_experts
        elif self.d_ff > 0:
            ffn = 3 * d * self.d_ff  # gate/up/down (SwiGLU)
        else:
            ffn = 0
        if self.attention == AttentionKind.RECURRENT:
            # xLSTM block ~ 4 gate projections + cell params, approx 8*d*d
            attn = 8 * d * d
            ffn = 0 if self.d_ff == 0 else ffn
        per_layer = attn + ffn + 2 * d  # two RMSNorm scales
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            per_cross = 2 * d * (nq * h) + 2 * d * (nkv * h) + 2 * d
            cross = n_cross * per_cross
        else:
            cross = 0
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return self.num_layers * per_layer + cross + emb + head + d

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        ffn_all = self.num_layers * self.moe.num_experts * 3 * self.d_model * self.d_ff
        ffn_act = self.num_layers * self.moe.top_k * 3 * self.d_model * self.d_ff
        return full - ffn_all + ffn_act


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str    # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


# ----------------------------------------------------------------------------
# Federated (paper-scale) configs
# ----------------------------------------------------------------------------

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
