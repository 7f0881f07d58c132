"""Algorithm 1 — the federated-distillation round protocol over a client
engine, for every method of Table III.

``run_experiment`` fits every client's DRE once (methods with a client
filter only), then drives the rounds through the sync phase scheduler
(``repro_torch.fed.scheduler``: ``local_train → report → aggregate →
[server_distill →] distill → eval``, or ``local_train → eval`` for
independent learning) and returns the per-round logs. ``LoopEngine``
drives clients one at a time through the scheduler's per-phase entry
points, as the reference's loop engine does; ``CohortEngine``
(``repro_torch.fed.cohort``) stacks clients of one architecture and runs
each phase as batched steps, and ``run_experiment`` writes its state back
onto the clients at the end.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional,
                    Sequence)

import numpy as np
import torch

from repro_torch.common.types import FedConfig
from repro_torch.core.methods import get_method
from repro_torch.data.synthetic import sample_tensor

if TYPE_CHECKING:  # avoid a core <-> fed import cycle at runtime
    from repro_torch.fed.client import Client
    from repro_torch.fed.server import Server


@dataclasses.dataclass
class RoundLog:
    round: int
    mean_acc: float
    accs: List[float]
    local_loss: float
    distill_loss: float
    id_fraction: float          # fraction of (client, sample) pairs kept ID
    bytes_up: int
    bytes_down: int
    wall_s: float
    # partial participation: the client ids that trained/reported this
    # round (None = every client) and the mean report age (0.0 = all fresh)
    participants: Optional[List[int]] = None
    mean_staleness: float = 0.0
    # per-phase host wall-clock breakdown (wall_s is their sum)
    phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the simulated straggler timeline (repro.fed.clock) is not ported
    # yet: these stay 0.0
    sim_finish_s: float = 0.0
    served_model_age_s: float = 0.0
    # FedDF ensemble server (method="server_distill")
    server_distill_loss: float = 0.0
    server_student_acc: Optional[float] = None
    # defense stack: report rows the sanitize pass scrubbed this round;
    # quarantine and watchdog rollbacks are not ported yet
    scrubbed_rows: int = 0
    quarantined: Optional[List[int]] = None
    rollbacks: int = 0


@dataclasses.dataclass
class ExperimentResult:
    method: str
    scenario: str
    rounds: List[RoundLog]

    @property
    def final_acc(self) -> float:
        return self.rounds[-1].mean_acc if self.rounds else 0.0

    @property
    def best_acc(self) -> float:
        return max(r.mean_acc for r in self.rounds) if self.rounds else 0.0


def client_generator(seed: int, i: int) -> torch.Generator:
    """A CPU generator for client ``i`` derived from ``(seed, i)`` — the
    counterpart of the reference's ``jax.random.fold_in(PRNGKey(seed), i)``
    (the streams differ; the derivation is the same in kind)."""
    state = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


class LoopEngine:
    """Reference engine: drives clients one by one.

    The ``phase_*`` methods are the scheduler's per-phase entry points;
    every client takes part in every phase (partial participation comes
    with ROADMAP queue A item 6). Inputs may be numpy arrays or tensors;
    each is moved to the clients' device once per phase, not once per
    client, and a tensor already there is not copied."""

    def __init__(self, clients: Sequence["Client"]):
        self.clients = list(clients)
        self.device = self.clients[0].device

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def learn_dres(self, seed: int) -> None:
        for i, c in enumerate(self.clients):
            c.learn_dre(client_generator(seed, i))

    # ------------------------------------------------ per-phase entry points
    def phase_local_train(self, epochs: int, batch_size: int) -> List[float]:
        return [c.local_train(epochs, batch_size) for c in self.clients]

    def phase_classwise_report(self):
        """FKD/PLS: every client's (per-class mean logits (K_cls, K),
        per-class counts (K_cls,)) over its private data, on its device."""
        return [c.classwise_means() for c in self.clients]

    def phase_report(self, px, powner):
        """Returns (logits (C, t, K), masks (C, t) bool) as tensors on the
        clients' device; nothing is read back to the host."""
        px_d = sample_tensor(px, self.device)
        owner_d = self._dev(powner)
        logits, masks = [], []
        for c in self.clients:                             # lines 20–25
            logits.append(c.proxy_logits(px_d))
            masks.append(c.filter_mask(px_d, owner_d).mask)
        return torch.stack(logits), torch.stack(masks)

    def phase_distill(self, px, teacher, weight, epochs: int,
                      batch_size: int) -> List[float]:
        px_d = sample_tensor(px, self.device)
        teacher_d = self._dev(teacher, torch.float32)
        weight_d = self._dev(weight, torch.float32)
        return [c.distill(px_d, teacher_d, weight_d, epochs, batch_size)
                for c in self.clients]

    def phase_distill_private(self, teacher_by_class, valid_by_class,
                              epochs: int, batch_size: int) -> List[float]:
        """FKD/PLS: each client distills on its own private data, against
        the fused class-wise teacher looked up by its labels."""
        teacher_d = self._dev(teacher_by_class, torch.float32)
        valid_d = self._dev(valid_by_class)
        return [c.distill(c._x, teacher_d[c._y],
                          valid_d[c._y].to(torch.float32), epochs,
                          batch_size)
                for c in self.clients]

    def phase_eval(self, x_test, y_test) -> List[float]:
        x_d = sample_tensor(x_test, self.device)
        y_d = self._dev(y_test, torch.int64)
        return [c.evaluate(x_d, y_d) for c in self.clients]


def as_engine(clients: Sequence["Client"], engine: str = "loop", *,
              num_devices: int = 0, wave_size: int = 0,
              model_shards: int = 0):
    """A client list as the engine ``engine`` names. ``wave_size`` streams
    the cohort engine's client axis in waves (0: the whole axis on the
    device); the device mesh (``num_devices``, ``model_shards``) is not
    ported yet."""
    if num_devices or model_shards:
        raise NotImplementedError(
            "num_devices/model_shards is not ported yet: ROADMAP queue A "
            "item 10 (multi-device)")
    if engine == "cohort":
        # lazy import: core must not import fed at load time
        from repro_torch.fed.cohort import CohortEngine
        return CohortEngine(clients, wave_size=wave_size)
    if engine != "loop":
        raise ValueError(f"unknown engine {engine!r}; known: loop, cohort")
    if wave_size:
        raise ValueError("wave_size requires engine='cohort' (the loop "
                         "engine never stacks a client axis to stream)")
    return LoopEngine(clients)


def engine_from_config(clients: Sequence["Client"], cfg: FedConfig):
    """``as_engine`` with every engine-relevant ``FedConfig`` field."""
    return as_engine(clients, cfg.engine,
                     num_devices=cfg.num_devices, wave_size=cfg.wave_size,
                     model_shards=cfg.model_shards)


def run_experiment(clients, server: "Server", method_name: str,
                   cfg: FedConfig, x_test, y_test,
                   progress: Optional[Callable[[RoundLog], None]] = None
                   ) -> ExperimentResult:
    # lazy import, as in the reference: core must not import fed at load
    from repro_torch.fed.scheduler import RoundScheduler
    method = get_method(method_name)
    engine = engine_from_config(clients, cfg)
    if method.client_filter != "none":                     # Initialization
        engine.learn_dres(cfg.seed)
    # the test set is copied to the device once, not every round
    x_test = sample_tensor(x_test, engine.device)
    y_test = torch.tensor(y_test, dtype=torch.int64, device=engine.device)
    logs = RoundScheduler(engine, server, method, cfg, x_test, y_test
                          ).run_rounds(0, cfg.rounds, progress=progress)
    if hasattr(engine, "sync_to_clients"):
        # an engine that trains stacked state hands it back to the clients
        engine.sync_to_clients()
    return ExperimentResult(method=method_name, scenario=cfg.scenario,
                            rounds=logs)
