"""Parity harness: a method of Table III in the port against a live run of
the JAX reference.

The reference builds its experiment (``repro.fed.simulator``) and runs it
on the jnp backend; the port builds the same experiment from the
reference's dataset arrays (flat features, NHWC images or token ids),
initial parameters (clients' and, for FedDF, the server student's: CNN or
MLP layer lists, or transformer pytrees on the ``lm_tokens`` dataset),
k-means++ seeds and KuLSIF auxiliary samples (the things drawn with
``jax.random``) and runs on the CPU through its plain PyTorch versions.
The dataset and its sizes are arguments (``mnist_feat`` at N_TRAIN/N_TEST
by default; ``mnist_like``, ``fashion_like`` and ``cifar_like`` run the
Tables I/II CNN zoo); the client count and the rounds come from the
config. Everything else — partition, proxy set, batch order,
proxy draws — comes from numpy streams both packages share.

The engine is the config's: ``engine="cohort"`` runs the reference's
cohort engine and the port's (``zoo="mixed"``: three MLP widths, three
cohorts on each side, each client's parameters at its own width). The
reference's cohort fits its uniform cohorts' KMeans-DREs from the seeds
``jax.random.fold_in(key, pos)`` draws (``repro/fed/cohort.py:495``), the
same seeds its loop engine draws for client ``pos``: the harness exports
them once, and the port fits every client, stacked or not, from them.
``assert_params_match`` holds each client's final parameters, written
back from the cohort's stacked state, to the reference's.

Tolerances, per round (``assert_logs_match``):
  * local, distill and server-student distill losses within rtol 1e-4
    (float32 matmuls in two libraries, a few SGD steps apart);
  * per-client and server-student accuracy off by at most one test sample;
  * ``id_fraction``, ``bytes_up`` and ``bytes_down`` exact, except for ID
    mask flips on (client, sample) pairs outside stage 1 whose DRE
    statistic lies within 1e-5 relative of the client's threshold (the
    KMeans-DRE distance, or the KuLSIF-DRE ratio): such pairs are counted,
    and each may move ``bytes_up`` by K·4 bytes per round and
    ``id_fraction`` by one pair;
  * with a scheduler knob set: ``participants`` and ``mean_staleness``
    exact; under fixed phase costs (``sim_phase_costs``: the reference's
    ``RoundScheduler`` built here, the port's through its
    ``run_experiment``) ``sim_finish_s`` and ``served_model_age_s``
    exact; and always the schedulers' node-for-node ``trace`` equal;
  * ``scrubbed_rows`` and ``quarantined`` equal (0 and None without a
    fault mode).

``assert_server_state_match`` holds the servers' defense state after the
run to the reference's: strikes, ``quarantined_until`` and
``scrub_clients`` equal, trust within rtol 1e-3 (an EWMA of distances
between two libraries' logits), and the fault injectors' replay caches
(each scheduler's ``faults``) with equal client ids and masks and logits
within the loss tolerance.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.common.types import FedConfig as RefFedConfig
from repro.core.kmeans import kmeans_plus_plus as ref_kmeans_plus_plus
from repro.core.methods import get_method as ref_get_method
from repro.core.protocol import engine_from_config as ref_engine_from_config
from repro.fed.scheduler import RoundScheduler as RefRoundScheduler
from repro.data.synthetic import make_dataset as ref_make_dataset
from repro.fed import simulator as ref_simulator
from repro_torch.common.types import FedConfig
from repro_torch.core import protocol
from repro_torch.data.synthetic import dataset_from_arrays
from repro_torch.fed import simulator

# The suite runs on several test workers that share the host's cores;
# torch's default of one intra-op thread a core has their parallel
# regions contend (six processes of a parity file ran 1.7x slower on eight
# cores than at two threads each). Importing this harness, as collection
# does in every worker, caps the worker at two.
torch.set_num_threads(min(2, torch.get_num_threads()))

N_TRAIN, N_TEST, CLIENTS, ROUNDS = 800, 200, 4, 2
LOSS_RTOL = 1e-4
# fixed phase costs (simulated seconds) that make the timeline
# deterministic: benchmarks/async_rounds.py's per phase, and
# benchmarks/hetero_zoo.py's per cohort of the mixed zoo ("phase@cohort")
FIXED_COSTS = {"local_train": 1.0, "report": 0.1, "aggregate": 0.3,
               "distill": 1.0, "eval": 0.0}
HETERO_COSTS = {"local_train@0": 3.0, "local_train@1": 1.0,
                "local_train@2": 0.5, "report@0": 0.1, "report@1": 0.1,
                "report@2": 0.1, "aggregate": 0.3, "distill@0": 0.5,
                "distill@1": 1.0, "distill@2": 3.0, "eval": 0.0}
NEAR_THRESHOLD_REL = 1e-5
MAX_NEAR_PAIRS = 2


def config(method: str, scenario: str, **overrides) -> dict:
    kw = dict(num_clients=CLIENTS, rounds=ROUNDS, method=method,
              scenario=scenario, seed=0, kernel_backend="jnp",
              round_mode="sync", zoo="shared")
    kw.update(overrides)
    return kw


def _numpy_params(params):
    """A parameter pytree (CNN or MLP layer list, or transformer dict) as
    numpy."""
    return jax.tree.map(np.asarray, params)


@dataclasses.dataclass
class Run:
    result: Any                      # the round logs (``_Result``)
    clients: List[Any]
    server: Any
    trace: Optional[list] = None     # the scheduler's node keys, host order
    faults: Any = None               # the scheduler's FaultInjector, if any


@dataclasses.dataclass
class Reference(Run):
    dataset: Any = None
    params: Optional[list] = None              # per client
    kmeans_inits: Optional[list] = None        # per client, kmeans filter
    kulsif_aux: Optional[list] = None          # per client, kulsif filter
    student_params: Optional[list] = None      # FedDF only


class _Result:
    """Round logs as the protocol's ``ExperimentResult`` holds them."""

    def __init__(self, rounds):
        self.rounds = rounds

    @property
    def final_acc(self):
        return self.rounds[-1].mean_acc


def run_reference(kw: dict, dataset: str = "mnist_feat",
                  n_train: int = N_TRAIN, n_test: int = N_TEST,
                  sim_phase_costs=None) -> Reference:
    cfg = RefFedConfig(**kw)
    method = ref_get_method(cfg.method)
    ds = ref_make_dataset(dataset, n_train=n_train, n_test=n_test,
                          seed=cfg.seed)
    clients, server, x_test, y_test = ref_simulator.build_experiment(
        cfg, dataset, n_train=n_train, n_test=n_test)
    params = [_numpy_params(c.params) for c in clients]
    student = (None if server.student is None
               else _numpy_params(server.student.params))
    inits = None
    if method.client_filter == "kmeans":
        # the seeds the reference's jnp fit draws: fold_in(PRNGKey(seed), i)
        # per client (LoopEngine.learn_dres), k-means++ under jit as in
        # _kmeans_fit_jnp, on the flattened samples (images in NHWC order,
        # as the port's client flattens them)
        kpp = jax.jit(ref_kmeans_plus_plus, static_argnums=2)
        key = jax.random.PRNGKey(cfg.seed)
        inits = [np.asarray(kpp(jax.random.fold_in(key, i),
                                jnp.asarray(c.x.reshape(len(c.x), -1),
                                            jnp.float32),
                                c.dre.num_centroids))
                 for i, c in enumerate(clients)]
    # run_experiment, with the scheduler built here so that fixed phase
    # costs and the trace are at hand
    engine = ref_engine_from_config(clients, cfg)
    if method.client_filter != "none":
        engine.learn_dres(jax.random.PRNGKey(cfg.seed))
    sched = RefRoundScheduler(engine, server, method, cfg, x_test, y_test,
                              sim_phase_costs=sim_phase_costs)
    res = _Result(sched.run_rounds(0, cfg.rounds))
    if engine is not clients and hasattr(engine, "sync_to_clients"):
        engine.sync_to_clients()
    aux = (None if method.client_filter != "kulsif"
           else [np.asarray(c.dre.aux) for c in clients])
    return Reference(res, clients, server, trace=list(sched.trace),
                     faults=sched.faults, dataset=ds, params=params,
                     kmeans_inits=inits, kulsif_aux=aux,
                     student_params=student)


def run_port(kw: dict, ref: Reference, sim_phase_costs=None) -> Run:
    cfg = FedConfig(**kw)
    ds = ref.dataset
    dataset = dataset_from_arrays(ds.x, ds.y, ds.x_test, ds.y_test,
                                  ds.num_classes)
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, device="cpu", dataset=dataset, init_params=ref.params,
        kmeans_inits=ref.kmeans_inits, kulsif_aux=ref.kulsif_aux,
        student_params=ref.student_params)
    with _keep_scheduler() as made:
        res = protocol.run_experiment(clients, server, cfg.method, cfg,
                                      x_test, y_test,
                                      sim_phase_costs=sim_phase_costs)
    return Run(res, clients, server, trace=res.trace, faults=made[0].faults)


@contextlib.contextmanager
def _keep_scheduler():
    """Collect the schedulers ``protocol.run_experiment`` builds, so that a
    test can read the port's fault injector after the run."""
    made, build = [], protocol._scheduler

    def keep(*args, **kwargs):
        made.append(build(*args, **kwargs))
        return made[-1]

    protocol._scheduler = keep
    try:
        yield made
    finally:
        protocol._scheduler = build


def _statistic(dre, px):
    """(the DRE's per-sample filter statistic, its threshold), as numpy."""
    if hasattr(dre, "distances"):
        return np.asarray(dre.distances(px)), float(dre.threshold)
    return np.asarray(dre.estimate(px)), float(dre.threshold)


def near_threshold_pairs(ref: Reference, port: Run) -> int:
    """(client, proxy sample) pairs outside stage 1 whose filter statistic
    lies within NEAR_THRESHOLD_REL of the client's threshold in either
    run; 0 for methods without a client filter."""
    proxy = port.server.proxy
    px = proxy.x.reshape(len(proxy.x), -1)
    total = 0
    for i, (rc, pc) in enumerate(zip(ref.clients, port.clients)):
        if rc.dre is None:
            continue
        s_r, t_r = _statistic(rc.dre, jnp.asarray(px))
        s_p, t_p = _statistic(pc.dre, torch.as_tensor(px))
        near = ((np.abs(s_r - t_r) <= NEAR_THRESHOLD_REL * abs(t_r))
                | (np.abs(s_p - t_p) <= NEAR_THRESHOLD_REL * abs(t_p)))
        total += int((near & (proxy.owner != i)).sum())
    return total


def cohort_config(method: str, scenario: str, **overrides) -> dict:
    """``config`` on the cohort engine."""
    return config(method, scenario, engine="cohort", **overrides)


def assert_params_match(ref: Reference, port: Run, rtol: float = 1e-3,
                        atol: float = 1e-4) -> None:
    """Every MLP client's final weights and biases (the reference's layer
    list against the port's ``MLPClassifier``), within float32 noise of
    two libraries over the run's SGD steps."""
    for rc, pc in zip(ref.clients, port.clients):
        layers = rc.params
        assert len(layers) == len(pc.model.weights)
        for p, w, b in zip(layers, pc.model.weights, pc.model.biases):
            np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]),
                                       rtol=rtol, atol=atol)
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(p["b"]),
                                       rtol=rtol, atol=atol)


def assert_logs_match(kw: dict, dataset: str = "mnist_feat",
                      n_train: int = N_TRAIN, n_test: int = N_TEST,
                      sim_phase_costs=None) -> tuple:
    """Run ``kw``'s method in both packages on ``dataset`` and hold the
    port's round logs to the reference's within the tolerances above
    (``sim_phase_costs``: both timelines priced with these fixed costs).
    Returns (reference, port) for further checks."""
    ref = run_reference(kw, dataset, n_train, n_test, sim_phase_costs)
    port = run_port(kw, ref, sim_phase_costs)
    check_logs(kw, ref, port, n_test, sim_phase_costs)
    return ref, port


def check_logs(kw: dict, ref: Reference, port: Run, n_test: int = N_TEST,
               sim_phase_costs=None) -> None:
    """Hold a port run's round logs to a reference run's (the tolerances
    above). ``kw`` is the port's config: it may differ from the
    reference's in the engine and the wave size only, which the reference
    holds bit for bit equal."""
    np.testing.assert_array_equal(port.server.proxy.x, ref.server.proxy.x)
    near = near_threshold_pairs(ref, port)
    assert near <= MAX_NEAR_PAIRS, (
        f"{near} near-threshold pairs: the case is too fragile")
    k = ref.dataset.num_classes
    t = min(kw.get("proxy_batch", FedConfig.proxy_batch),
            len(port.server.proxy.y))
    acc_tol = 1.0 / n_test + 1e-9
    p_rounds, q_rounds = port.result.rounds, ref.result.rounds
    assert len(p_rounds) == len(q_rounds) == kw["rounds"]
    for r, (p, q) in enumerate(zip(p_rounds, q_rounds)):
        assert set(p.phase_s) == set(q.phase_s), (p.phase_s, q.phase_s)
        for f in ("local_loss", "distill_loss", "server_distill_loss"):
            np.testing.assert_allclose(getattr(p, f), getattr(q, f),
                                       rtol=LOSS_RTOL, err_msg=f)
        np.testing.assert_allclose(p.accs, q.accs, atol=acc_tol)
        if q.server_student_acc is None:
            assert p.server_student_acc is None
        else:
            assert abs(p.server_student_acc - q.server_student_acc) <= acc_tol
        assert p.participants == q.participants
        assert p.mean_staleness == q.mean_staleness
        reporting = (kw["num_clients"] if q.participants is None
                     else len(q.participants))
        assert abs(p.id_fraction - q.id_fraction) <= (
            near / max(reporting * t, 1) + 1e-12)
        assert abs(p.bytes_up - q.bytes_up) <= (r + 1) * near * k * 4
        assert p.bytes_down == q.bytes_down
        assert p.scrubbed_rows == q.scrubbed_rows
        assert p.quarantined == q.quarantined
        if kw.get("fault_mode", "none") == "none":
            assert q.scrubbed_rows == 0 and q.quarantined is None
        if sim_phase_costs is not None:
            assert p.sim_finish_s == q.sim_finish_s
            assert p.served_model_age_s == q.served_model_age_s
    assert port.trace == [tuple(k) for k in ref.trace]



def assert_server_state_match(ref: Reference, port: Run) -> None:
    """The defense state after the run: strikes, quarantine and scrub
    counts equal, trust within rtol 1e-3, the replay caches alike."""
    rs, ps = ref.server, port.server
    for name in ("strikes", "quarantined_until", "scrub_clients"):
        a, b = getattr(rs, name), getattr(ps, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert (rs.trust is None) == (ps.trust is None)
    if rs.trust is not None:
        np.testing.assert_allclose(ps.trust, rs.trust, rtol=1e-3, atol=1e-9)
    assert ps.scrub_total == rs.scrub_total
    assert (ref.faults is None) == (port.faults is None)
    if ref.faults is None:
        return
    r_sd, p_sd = ref.faults.state_dict(), port.faults.state_dict()
    assert [c for c, _, _ in p_sd["replay"]] == [
        c for c, _, _ in r_sd["replay"]]
    for (_, pa, pb), (_, ra, rb) in zip(p_sd["replay"], r_sd["replay"]):
        np.testing.assert_array_equal(pb, np.asarray(rb))
        np.testing.assert_allclose(pa, np.asarray(ra), rtol=LOSS_RTOL,
                                   atol=1e-5)
