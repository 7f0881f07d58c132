"""Algorithm 1 — the EdgeFD round protocol over a client engine.

``run_experiment`` fits every client's DRE once, then drives the rounds
through the sync phase scheduler (``repro_torch.fed.scheduler``:
``local_train → report → aggregate → distill → eval``) and returns the
per-round logs. ``LoopEngine`` drives clients one at a time through the
scheduler's per-phase entry points, as the reference's loop engine does.
The cohort engine (``repro.fed.cohort``) is not ported yet (ROADMAP queue
A item 5).
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional,
                    Sequence)

import numpy as np
import torch

from repro_torch.common.types import FedConfig
from repro_torch.core.methods import get_method

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
    # FedDF ensemble server (not ported yet)
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

    def phase_report(self, px, powner):
        """Returns (logits (C, t, K), masks (C, t) bool) as tensors on the
        clients' device; nothing is read back to the host."""
        px_d = self._dev(px, torch.float32)
        owner_d = self._dev(powner)
        logits, masks = [], []
        for c in self.clients:                             # lines 20–25
            logits.append(c.proxy_logits(px_d))
            masks.append(c.filter_mask(px_d, owner_d).mask)
        return torch.stack(logits), torch.stack(masks)

    def phase_distill(self, px, teacher, weight, epochs: int,
                      batch_size: int) -> List[float]:
        px_d = self._dev(px, torch.float32)
        teacher_d = self._dev(teacher, torch.float32)
        weight_d = self._dev(weight, torch.float32)
        return [c.distill(px_d, teacher_d, weight_d, epochs, batch_size)
                for c in self.clients]

    def phase_eval(self, x_test, y_test) -> List[float]:
        x_d = self._dev(x_test, torch.float32)
        y_d = self._dev(y_test, torch.int64)
        return [c.evaluate(x_d, y_d) for c in self.clients]


def engine_from_config(clients: Sequence["Client"], cfg: FedConfig):
    """The engine ``cfg.engine`` names, around a client list."""
    if cfg.engine != "loop":
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported yet: ROADMAP queue A "
            "item 5 (the cohort engine)")
    return LoopEngine(clients)


def run_experiment(clients, server: "Server", method_name: str,
                   cfg: FedConfig, x_test, y_test,
                   progress: Optional[Callable[[RoundLog], None]] = None
                   ) -> ExperimentResult:
    # lazy import, as in the reference: core must not import fed at load
    from repro_torch.fed.scheduler import RoundScheduler
    get_method(method_name)          # refuses methods outside the slice
    engine = engine_from_config(clients, cfg)
    engine.learn_dres(cfg.seed)                            # Initialization
    # the test set is copied to the device once, not every round
    x_test = torch.tensor(x_test, dtype=torch.float32, device=engine.device)
    y_test = torch.tensor(y_test, dtype=torch.int64, device=engine.device)
    logs = RoundScheduler(engine, server, cfg, x_test, y_test
                          ).run_rounds(0, cfg.rounds, progress=progress)
    return ExperimentResult(method=method_name, scenario=cfg.scenario,
                            rounds=logs)
