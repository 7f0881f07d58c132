"""The port's EdgeFD slice against a live run of the JAX reference.

The reference builds its experiment (``repro.fed.simulator``) and runs it
on the jnp backend; the port builds the same experiment from the
reference's dataset arrays, initial parameters and k-means++ seeds (the
three things drawn with ``jax.random``) and runs on the CPU through its
plain PyTorch versions. Everything else — partition, proxy set, batch
order, proxy draws — comes from numpy streams both packages share.

Tolerances, per round:
  * local and distill losses within rtol 1e-4 (float32 matmuls in two
    libraries, a few SGD steps apart);
  * per-client accuracy off by at most one test sample;
  * ``id_fraction``, ``bytes_up`` and ``bytes_down`` exact, except for ID
    mask flips on samples whose DRE distance lies within 1e-5 relative of
    the client's threshold: such samples are counted, and each may move
    ``bytes_up`` by K·4 bytes and ``id_fraction`` by one pair.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import FedConfig as RefFedConfig
from repro.core.kmeans import kmeans_plus_plus as ref_kmeans_plus_plus
from repro.core.protocol import run_experiment as ref_run_experiment
from repro.data.synthetic import make_dataset as ref_make_dataset
from repro.fed import simulator as ref_simulator
from repro_torch.common.types import FedConfig
from repro_torch.core.protocol import run_experiment
from repro_torch.data.synthetic import dataset_from_arrays
from repro_torch.fed import simulator

N_TRAIN, N_TEST, CLIENTS, ROUNDS = 800, 200, 4, 2
LOSS_RTOL = 1e-4
NEAR_THRESHOLD_REL = 1e-5


def _config(scenario):
    return dict(num_clients=CLIENTS, rounds=ROUNDS, method="edgefd",
                scenario=scenario, seed=0, kernel_backend="jnp",
                round_mode="sync", zoo="shared")


def _reference(kw):
    cfg = RefFedConfig(**kw)
    ds = ref_make_dataset("mnist_feat", n_train=N_TRAIN, n_test=N_TEST,
                          seed=cfg.seed)
    clients, server, x_test, y_test = ref_simulator.build_experiment(
        cfg, "mnist_feat", n_train=N_TRAIN, n_test=N_TEST)
    params = [[{k: np.asarray(v) for k, v in layer.items()}
               for layer in c.params] for c in clients]
    # the seeds the reference's jnp fit draws: fold_in(PRNGKey(seed), i)
    # per client (LoopEngine.learn_dres), k-means++ under jit as in
    # _kmeans_fit_jnp
    kpp = jax.jit(ref_kmeans_plus_plus, static_argnums=2)
    key = jax.random.PRNGKey(cfg.seed)
    inits = [np.asarray(kpp(jax.random.fold_in(key, i),
                            jnp.asarray(c.x.reshape(len(c.x), -1),
                                        jnp.float32),
                            c.dre.num_centroids))
             for i, c in enumerate(clients)]
    res = ref_run_experiment(clients, server, "edgefd", cfg, x_test, y_test)
    return ds, params, inits, res, clients, server


def _near_threshold_pairs(ref_clients, port_clients, proxy):
    """(client, proxy sample) pairs outside stage 1 whose distance lies
    within NEAR_THRESHOLD_REL of the client's threshold in either run."""
    px = proxy.x.reshape(len(proxy.x), -1)
    total = 0
    for i, (rc, pc) in enumerate(zip(ref_clients, port_clients)):
        d_r = np.asarray(rc.dre.distances(jnp.asarray(px)))
        t_r = float(rc.dre.threshold)
        d_p = pc.dre.distances(torch.as_tensor(px)).numpy()
        t_p = float(pc.dre.threshold)
        near = ((np.abs(d_r - t_r) <= NEAR_THRESHOLD_REL * t_r)
                | (np.abs(d_p - t_p) <= NEAR_THRESHOLD_REL * t_p))
        total += int((near & (proxy.owner != i)).sum())
    return total


@pytest.mark.parametrize("scenario", ["strong", "weak"])
def test_edgefd_round_logs_match_live_reference(scenario):
    kw = _config(scenario)
    ds, params, inits, ref, ref_clients, ref_server = _reference(kw)

    cfg = FedConfig(**kw)
    dataset = dataset_from_arrays(ds.x, ds.y, ds.x_test, ds.y_test,
                                  ds.num_classes)
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, device="cpu", dataset=dataset, init_params=params,
        kmeans_inits=inits)
    port = run_experiment(clients, server, "edgefd", cfg, x_test, y_test)

    np.testing.assert_array_equal(server.proxy.x, ref_server.proxy.x)
    near = _near_threshold_pairs(ref_clients, clients, server.proxy)
    assert near <= 2, f"{near} near-threshold pairs: the case is too fragile"
    k = ds.num_classes
    pairs = CLIENTS * min(cfg.proxy_batch, len(server.proxy.y))
    assert len(port.rounds) == len(ref.rounds) == ROUNDS
    for r, (p, q) in enumerate(zip(port.rounds, ref.rounds)):
        np.testing.assert_allclose(p.local_loss, q.local_loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(p.distill_loss, q.distill_loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(p.accs, q.accs,
                                   atol=1.0 / N_TEST + 1e-9)
        assert abs(p.id_fraction - q.id_fraction) <= near / pairs + 1e-12
        assert abs(p.bytes_up - q.bytes_up) <= (r + 1) * near * k * 4
        assert p.bytes_down == q.bytes_down
        assert p.scrubbed_rows == q.scrubbed_rows == 0
