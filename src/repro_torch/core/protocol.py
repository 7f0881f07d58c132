"""Algorithm 1 — the federated-distillation round protocol over a client
engine, for every method of Table III.

``run_experiment`` fits every client's DRE once (methods with a client
filter only), then drives the rounds through the phase-graph scheduler
(``repro_torch.fed.scheduler``: ``local_train → report → aggregate →
[server_distill →] distill → eval``, or ``local_train → eval`` for
independent learning; lockstep or overlapping rounds, partial
participation, concurrent cohorts) and returns the per-round logs.
``LoopEngine`` drives clients one at a time through the scheduler's
per-phase and per-cohort entry points, as the reference's loop engine
does; ``CohortEngine`` (``repro_torch.fed.cohort``) stacks clients of one
architecture and runs each phase as batched steps and writes its state
back onto the clients at the end of a run. Both engines' ``state_dict``
is the per-client checkpoint format of ``repro_torch.fed.state``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional,
                    Sequence, Tuple)

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
    # when the round retired on the simulated straggler timeline
    # (fed.clock), and how long the model it replaces had served there
    # (simulated seconds since the previous retirement)
    sim_finish_s: float = 0.0
    served_model_age_s: float = 0.0
    # FedDF ensemble server (method="server_distill")
    server_distill_loss: float = 0.0
    server_student_acc: Optional[float] = None
    # defense stack: report rows the sanitize pass scrubbed this round and
    # the clients quarantined on its evidence (None: nobody), and the
    # divergence watchdog's rollbacks so far in the run
    scrubbed_rows: int = 0
    quarantined: Optional[List[int]] = None
    rollbacks: int = 0


@dataclasses.dataclass
class ExperimentResult:
    method: str
    scenario: str
    rounds: List[RoundLog]
    # the scheduler's node keys, (phase, round[, cohort]), in host order
    trace: List[Tuple] = dataclasses.field(default_factory=list)

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

    The ``phase_*`` methods are the scheduler's per-phase entry points and
    the ``cohort_*`` methods its per-cohort ones (concurrent cohorts). A
    sampled-out client (``participants`` False) is skipped entirely: no
    training, no report, no draw from its private rng. Inputs may be
    numpy arrays or tensors; each is moved to the clients' device once per
    phase, not once per client, and a tensor already there is not
    copied."""

    def __init__(self, clients: Sequence["Client"]):
        self.clients = list(clients)
        self.device = self.clients[0].device
        self._cohort_pos: Optional[List[np.ndarray]] = None

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _part(self, participants) -> np.ndarray:
        """A participation mask as (C,) bool (None = every client)."""
        if participants is None:
            return np.ones((len(self.clients),), bool)
        part = np.asarray(participants, bool)
        if part.shape != (len(self.clients),):
            raise ValueError(
                f"participation mask shape {part.shape} != "
                f"({len(self.clients)},)")
        return part

    def learn_dres(self, seed: int) -> None:
        for i, c in enumerate(self.clients):
            c.learn_dre(client_generator(seed, i))

    # ------------------------------------------- the per-client phase bodies
    def _skipped_classwise(self):
        """A sampled-out client's class-wise report: zero counts, which
        drop it from the fusion."""
        k = self.clients[0].num_classes
        return (torch.zeros((k, k), dtype=torch.float32, device=self.device),
                torch.zeros((k,), dtype=torch.float32, device=self.device))

    def _classwise(self, positions, part):
        return [self.clients[p].classwise_means() if part[p]
                else self._skipped_classwise() for p in positions]

    def _report(self, positions, part, px, powner):
        """(logits (m, t, K), masks (m, t) bool) of the clients at
        ``positions`` on the device; sampled-out rows are zero and
        all-False (the staleness buffer replaces them)."""
        px_d = sample_tensor(px, self.device)
        owner_d = self._dev(powner)
        t, k = len(px_d), self.clients[0].num_classes
        logits = torch.zeros((len(positions), t, k), dtype=torch.float32,
                             device=self.device)
        masks = torch.zeros((len(positions), t), dtype=torch.bool,
                            device=self.device)
        for j, p in enumerate(positions):                  # lines 20–25
            if not part[p]:
                continue
            c = self.clients[p]
            logits[j] = c.proxy_logits(px_d)
            masks[j] = c.filter_mask(px_d, owner_d).mask
        return logits, masks

    def _distill(self, positions, part, px, teacher, weight, epochs,
                 batch_size):
        px_d = sample_tensor(px, self.device)
        teacher_d = self._dev(teacher, torch.float32)
        weight_d = self._dev(weight, torch.float32)
        return [self.clients[p].distill(px_d, teacher_d, weight_d, epochs,
                                        batch_size) if part[p] else 0.0
                for p in positions]

    def _distill_private(self, positions, part, teacher_by_class,
                         valid_by_class, epochs, batch_size):
        """FKD/PLS: each client distills on its own private data, against
        the fused class-wise teacher looked up by its labels."""
        teacher_d = self._dev(teacher_by_class, torch.float32)
        valid_d = self._dev(valid_by_class)
        out = []
        for p in positions:
            c = self.clients[p]
            out.append(c.distill(c._x, teacher_d[c._y],
                                 valid_d[c._y].to(torch.float32), epochs,
                                 batch_size) if part[p] else 0.0)
        return out

    # ------------------------------------------------ per-phase entry points
    def phase_local_train(self, epochs: int, batch_size: int,
                          participants=None) -> List[float]:
        part = self._part(participants)
        return [c.local_train(epochs, batch_size) if part[i] else 0.0
                for i, c in enumerate(self.clients)]

    def phase_classwise_report(self, participants=None):
        """FKD/PLS: every client's (per-class mean logits (K_cls, K),
        per-class counts (K_cls,)) over its private data, on its device;
        zero counts for a sampled-out client."""
        return self._classwise(range(self.num_clients),
                               self._part(participants))

    def phase_report(self, px, powner, participants=None):
        """Returns (logits (C, t, K), masks (C, t) bool) as tensors on the
        clients' device; nothing is read back to the host."""
        return self._report(range(self.num_clients),
                            self._part(participants), px, powner)

    def phase_distill(self, px, teacher, weight, epochs: int,
                      batch_size: int, participants=None) -> List[float]:
        return self._distill(range(self.num_clients),
                             self._part(participants), px, teacher, weight,
                             epochs, batch_size)

    def phase_distill_private(self, teacher_by_class, valid_by_class,
                              epochs: int, batch_size: int,
                              participants=None) -> List[float]:
        return self._distill_private(range(self.num_clients),
                                     self._part(participants),
                                     teacher_by_class, valid_by_class,
                                     epochs, batch_size)

    def phase_eval(self, x_test, y_test) -> List[float]:
        x_d = sample_tensor(x_test, self.device)
        y_d = self._dev(y_test, torch.int64)
        return [c.evaluate(x_d, y_d) for c in self.clients]

    # ------------------------------------------------ per-cohort entry points
    # Concurrent cohorts key the client-side phase nodes per cohort. The
    # loop engine groups clients by arch_key as CohortEngine does, so the
    # two engines' round logs agree node for node; each cohort_* call
    # returns values aligned to that cohort's positions.
    def cohort_positions(self) -> List[np.ndarray]:
        """Client positions per cohort, grouped by ``arch_key`` in
        first-appearance order (a client without one is a cohort of its
        own), the ``CohortEngine``'s rule."""
        if self._cohort_pos is None:
            groups: Dict = {}
            for pos, c in enumerate(self.clients):
                key = c.arch_key if c.arch_key is not None else ("solo", pos)
                groups.setdefault(key, []).append(pos)
            self._cohort_pos = [np.asarray(p, int) for p in groups.values()]
        return self._cohort_pos

    def cohort_local_train(self, ci: int, epochs: int, batch_size: int,
                           participants=None) -> List[float]:
        part = self._part(participants)
        return [self.clients[p].local_train(epochs, batch_size)
                if part[p] else 0.0
                for p in self.cohort_positions()[ci]]

    def cohort_classwise_report(self, ci: int, participants=None):
        return self._classwise(self.cohort_positions()[ci],
                               self._part(participants))

    def cohort_report(self, ci: int, px, powner, participants=None):
        """(logits (m, t, K), masks (m, t)) for cohort ``ci``'s m clients,
        on the device; sampled-out rows zero and all-False."""
        return self._report(self.cohort_positions()[ci],
                            self._part(participants), px, powner)

    def cohort_distill(self, ci: int, px, teacher, weight, epochs: int,
                       batch_size: int, participants=None) -> List[float]:
        return self._distill(self.cohort_positions()[ci],
                             self._part(participants), px, teacher, weight,
                             epochs, batch_size)

    def cohort_distill_private(self, ci: int, teacher_by_class,
                               valid_by_class, epochs: int, batch_size: int,
                               participants=None) -> List[float]:
        return self._distill_private(self.cohort_positions()[ci],
                                     self._part(participants),
                                     teacher_by_class, valid_by_class,
                                     epochs, batch_size)

    # ------------------------------------------------- resumable service
    def state_dict(self) -> Dict:
        """Per-client parameters, optimizer state and rng streams
        (``repro_torch.fed.state.clients_state_dict``)."""
        from repro_torch.fed.state import clients_state_dict
        return clients_state_dict(self.clients)

    def load_state_dict(self, sd: Dict) -> None:
        from repro_torch.fed.state import load_clients_state_dict
        load_clients_state_dict(self.clients, sd)


def as_engine(clients_or_engine, engine: str = "loop", *,
              num_devices: int = 0, wave_size: int = 0,
              model_shards: int = 0):
    """A client list as the engine ``engine`` names. ``wave_size`` streams
    the cohort engine's client axis in waves (0: the whole axis on the
    device); ``num_devices`` (0: no mesh, -1: the whole world) and
    ``model_shards`` lay the cohort engine over a device mesh of ranks
    (``repro_torch.fed.mesh.build_client_mesh``; its device is the
    clients' device). A pre-built engine runs as it was built, with a
    warning when the config asks for a mesh it lacks."""
    if hasattr(clients_or_engine, "phase_local_train"):
        if num_devices and getattr(clients_or_engine, "mesh", None) is None:
            warnings.warn(
                f"num_devices={num_devices} requested but a pre-built "
                "engine without a device mesh was supplied; it will run "
                "as constructed — pass the raw client list to honor the "
                "config")
        return clients_or_engine
    clients = clients_or_engine
    if engine == "cohort":
        # lazy imports: core must not import fed at load time
        from repro_torch.fed.cohort import CohortEngine
        from repro_torch.fed.mesh import build_client_mesh
        mesh = build_client_mesh(
            num_devices, model_shards=model_shards,
            device=clients[0].device if clients else None)
        return CohortEngine(clients, wave_size=wave_size, mesh=mesh)
    if engine != "loop":
        raise ValueError(f"unknown engine {engine!r}; known: loop, cohort")
    if num_devices:
        raise ValueError("num_devices requires engine='cohort' (the loop "
                         "engine drives one client at a time)")
    if wave_size:
        raise ValueError("wave_size requires engine='cohort' (the loop "
                         "engine never stacks a client axis to stream)")
    if model_shards:
        raise ValueError("model_shards requires engine='cohort' (the loop "
                         "engine holds each client's params on one device)")
    return LoopEngine(clients)


def engine_from_config(clients: Sequence["Client"], cfg: FedConfig):
    """``as_engine`` with every engine-relevant ``FedConfig`` field."""
    return as_engine(clients, cfg.engine, num_devices=cfg.num_devices,
                     wave_size=cfg.wave_size, model_shards=cfg.model_shards)


def make_scheduler(engine, server: "Server", method, cfg: FedConfig, x_test,
                   y_test, sim_phase_costs=None):
    """The ``RoundScheduler`` over ``engine``, with the test set copied to
    the engine's device once, not every round."""
    # lazy import, as in the reference: core must not import fed at load
    from repro_torch.fed.scheduler import RoundScheduler
    x_test = sample_tensor(x_test, engine.device)
    y_test = (y_test.to(engine.device, torch.int64)
              if isinstance(y_test, torch.Tensor)
              else torch.tensor(y_test, dtype=torch.int64,
                                device=engine.device))
    return RoundScheduler(engine, server, method, cfg, x_test, y_test,
                          sim_phase_costs=sim_phase_costs)


def run_experiment(clients, server: "Server", method_name: str,
                   cfg: FedConfig, x_test, y_test,
                   progress: Optional[Callable[[RoundLog], None]] = None, *,
                   sim_phase_costs: Optional[Dict[str, float]] = None,
                   sync_clients: bool = True) -> ExperimentResult:
    """Fit the DREs, then run ``cfg.rounds`` rounds of the client list
    ``clients`` through one scheduler. ``sim_phase_costs`` prices the
    simulated timeline with fixed phase costs instead of the measured ones
    (``RoundScheduler``). ``sync_clients``: hand the engine's final state
    back to the clients (the cohort engine's; over a mesh a gather of
    every rank's rows and slices to every rank's host); a caller that
    drops the clients (``simulator.run``) skips it."""
    method = get_method(method_name)
    engine = engine_from_config(clients, cfg)
    if method.client_filter != "none":                     # Initialization
        engine.learn_dres(cfg.seed)
    sched = make_scheduler(engine, server, method, cfg, x_test, y_test,
                           sim_phase_costs)
    logs = sched.run_rounds(0, cfg.rounds, progress=progress)
    if sync_clients and hasattr(engine, "sync_to_clients"):
        # the cohort engine hands its stacked state back to the clients
        engine.sync_to_clients()
    return ExperimentResult(method=method_name, scenario=cfg.scenario,
                            rounds=logs, trace=list(sched.trace))
