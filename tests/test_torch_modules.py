"""The port's main-path modules against their JAX-package counterparts.

Inputs come from numpy with a seed. Numpy-only modules (partition, proxy,
batching) must match bit for bit; tensor modules hold to float32
tolerances stated per test (two libraries' matmuls differ in the last
bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import FedConfig as RefFedConfig
from repro.core import aggregation as ref_agg
from repro.core import distill as ref_distill
from repro.core.dre import KMeansDRE as RefKMeansDRE
from repro.core.filtering import two_stage_filter as ref_two_stage_filter
from repro.core.kmeans import kmeans_fit as ref_kmeans_fit
from repro.core.kmeans import kmeans_plus_plus as ref_kmeans_plus_plus
from repro.core.kmeans import min_dist_to_centroids as ref_min_dist
from repro.data import proxy as ref_proxy
from repro.data.partition import partition as ref_partition
from repro.fed import batching as ref_batching
from repro.fed.server import Server as RefServer
from repro.models.cnn import MLPClassifier as RefMLP
from repro.optim.optimizers import apply_updates as ref_apply_updates
from repro.optim.optimizers import sgd as ref_sgd
from repro_torch.common.types import FedConfig
from repro_torch.core import aggregation, distill
from repro_torch.core.dre import KMeansDRE
from repro_torch.core.filtering import two_stage_filter
from repro_torch.core.kmeans import (kmeans_fit, kmeans_plus_plus,
                                     min_dist_to_centroids)
from repro_torch.core.methods import get_method
from repro_torch.data import partition, proxy
from repro_torch.fed import batching
from repro_torch.fed.server import Server
from repro_torch.kernels import dispatch
from repro_torch.models.cnn import MLPClassifier
from repro_torch.optim.optimizers import apply_updates, sgd

F32 = dict(rtol=1e-5, atol=1e-6)


def _labelled(n=600, d=6, k=10, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.int32)
    x = (rng.standard_normal((n, d)) + y[:, None]).astype(np.float32)
    return x, y


def _blobs(n_per=80, d=5, centers=3, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((centers, d)) * 6
    return np.concatenate([m + rng.standard_normal((n_per, d))
                           for m in mu]).astype(np.float32)


# ------------------------------------------------ numpy modules: bit for bit

@pytest.mark.parametrize("scenario", ["strong", "weak", "iid"])
def test_partition_and_proxy_match_bit_for_bit(scenario):
    x, y = _labelled()
    kw = dict(num_clients=5, num_classes=10, scenario=scenario,
              labels_per_client=3, seed=4)
    got = partition.partition(x, y, **kw)
    want = ref_partition(x, y, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    p_got = proxy.build_proxy(got, 0.2, seed=4)
    p_want = ref_proxy.build_proxy(want, 0.2, seed=4)
    for a, b in zip(p_got, p_want):
        np.testing.assert_array_equal(a, b)
    r_got, r_want = np.random.default_rng(11), np.random.default_rng(11)
    for batch in (16, 64, 10_000):
        np.testing.assert_array_equal(
            proxy.select_round_indices(r_got, p_got, batch),
            ref_proxy.select_round_indices(r_want, p_want, batch))


@pytest.mark.parametrize("n,bs", [(0, 4), (3, 4), (64, 64), (130, 64),
                                  (1000, 7)])
def test_epoch_batches_match_bit_for_bit(n, bs):
    perm = np.random.default_rng(n).permutation(n)
    got = batching.epoch_batches(perm, bs)
    want = ref_batching.epoch_batches(perm, bs)
    assert len(got) == len(want) == batching.steps_per_epoch(n, bs)
    assert batching.steps_per_epoch(n, bs) == ref_batching.steps_per_epoch(
        n, bs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fedconfig_fields_match_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(FedConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(RefFedConfig)]
    assert got == want


# ------------------------------------------------------------ model + optim

def test_mlp_forward_matches_after_loading_jax_params():
    ref = RefMLP(d_in=50, hidden=(256, 128), num_classes=10)
    params = ref.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(0).standard_normal((33, 50)).astype(np.float32)
    mlp = MLPClassifier(50, (256, 128), 10).load_jax_params(
        [{k: np.asarray(v) for k, v in p.items()} for p in params])
    assert mlp.dims == ref.dims
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(params, x)), **F32)


def test_mlp_init_is_seeded_and_lecun_scaled():
    a = MLPClassifier(50, (64,), 10, generator=torch.Generator().manual_seed(1))
    b = MLPClassifier(50, (64,), 10, generator=torch.Generator().manual_seed(1))
    for u, v in zip(a.parameters(), b.parameters()):
        assert torch.equal(u, v)
    assert abs(float(a.weights[0].detach().std()) - 50 ** -0.5) < 0.02
    assert float(a.biases[0].detach().abs().max()) == 0.0


def test_sgd_param_trajectory_matches_reference():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (3, 2)]
    params0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    r_opt = ref_sgd(1e-2)
    r_params = [jnp.asarray(p) for p in params0]
    r_state = r_opt.init(r_params)
    opt = sgd(1e-2)
    params = [torch.tensor(p) for p in params0]
    state = opt.init(params)
    for g in grads:
        upd, r_state = r_opt.update([jnp.asarray(a) for a in g], r_state,
                                    r_params)
        r_params = ref_apply_updates(r_params, upd)
        upd, state = opt.update([torch.from_numpy(a) for a in g], state,
                                params)
        apply_updates(params, upd)
        for p, q in zip(params, r_params):
            np.testing.assert_allclose(p.numpy(), np.asarray(q),
                                       rtol=1e-6, atol=1e-7)
        for m, q in zip(state["mu"], r_state["mu"]):
            np.testing.assert_allclose(m.numpy(), np.asarray(q),
                                       rtol=1e-6, atol=1e-7)
    assert state["step"] == int(r_state["step"]) == len(grads)


# --------------------------------------------------------- KMeans + filter

@pytest.mark.parametrize("k", [1, 3])
def test_kmeans_fit_with_reference_seeds_matches(k):
    x = _blobs(seed=k)
    key = jax.random.PRNGKey(5)
    ref = ref_kmeans_fit(key, jnp.asarray(x), k, backend="jnp")
    init = np.array(jax.jit(ref_kmeans_plus_plus, static_argnums=2)(
        key, jnp.asarray(x), k))
    res = kmeans_fit(torch.from_numpy(x), k, init=torch.from_numpy(init))
    np.testing.assert_allclose(res.centroids.numpy(),
                               np.asarray(ref.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(res.assignments.numpy(),
                                  np.asarray(ref.assignments))
    assert res.n_iter == int(ref.n_iter)
    np.testing.assert_allclose(float(res.inertia), float(ref.inertia),
                               rtol=1e-5)
    # matmul-form distances cancel terms of |x|² (~400 here) in float32
    np.testing.assert_allclose(
        min_dist_to_centroids(torch.from_numpy(x), res.centroids).numpy(),
        np.asarray(ref_min_dist(jnp.asarray(x), ref.centroids)),
        rtol=1e-5, atol=1e-4)


def test_kmeans_plus_plus_is_seeded_and_picks_rows():
    x = torch.from_numpy(_blobs(seed=9))
    a = kmeans_plus_plus(x, 3, generator=torch.Generator().manual_seed(2))
    b = kmeans_plus_plus(x, 3, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    for row in a:      # every seed is a data row, and they are distinct
        assert bool((x == row).all(-1).any())
    assert len({tuple(r.tolist()) for r in a}) == 3


def test_kmeans_dre_threshold_and_two_stage_filter_match():
    x = _blobs(n_per=100, seed=7)
    rng = np.random.default_rng(7)
    proxy_x = np.concatenate([x[::7], rng.standard_normal((40, 5)) * 8
                              ]).astype(np.float32)
    owner = rng.integers(0, 3, len(proxy_x)).astype(np.int32)
    key = jax.random.PRNGKey(1)
    ref = RefKMeansDRE(num_centroids=3, kernel_backend="jnp").learn(
        key, jnp.asarray(x))
    init = np.array(jax.jit(ref_kmeans_plus_plus, static_argnums=2)(
        key, jnp.asarray(x), 3))
    dre = KMeansDRE(num_centroids=3).learn(torch.from_numpy(x),
                                           init=torch.from_numpy(init))
    np.testing.assert_allclose(float(dre.threshold), float(ref.threshold),
                               rtol=1e-5)
    got = two_stage_filter(dre, torch.from_numpy(proxy_x),
                           torch.from_numpy(owner), 1)
    want = ref_two_stage_filter(ref, jnp.asarray(proxy_x),
                                jnp.asarray(owner), 1)
    for a, b in zip(got[:3], want[:3]):          # mask, stage1, stage2
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)
    fixed = KMeansDRE(num_centroids=1, threshold=2.5).learn(
        torch.from_numpy(x))
    assert fixed.threshold == 2.5


# --------------------------------------------------- aggregation + server

def _reports(c=4, t=32, k=10, seed=0, poison=True):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((c, t, k)) * 3).astype(np.float32)
    masks = rng.random((c, t)) > 0.4
    masks[:, 0] = False                 # a position no client claims
    if poison:
        logits[1, 3, 2] = np.nan
        logits[2, 5, :] = np.inf
        masks[1, 3] = masks[2, 5] = True
    return logits, masks


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("guard", [True, False])
def test_masked_mean_logits_matches(seed, guard):
    logits, masks = _reports(seed=seed, poison=guard)
    t, v = aggregation.masked_mean_logits(
        torch.from_numpy(logits), torch.from_numpy(masks),
        guard_finite=guard)
    t_w, v_w = ref_agg.masked_mean_logits(
        jnp.asarray(logits), jnp.asarray(masks), guard_finite=guard)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_w), **F32)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_w))


@pytest.mark.parametrize("poison", [True, False])
def test_scrub_nonfinite_matches(poison):
    logits, masks = _reports(poison=poison)
    lo_t, mk_t = torch.from_numpy(logits), torch.from_numpy(masks)
    got = aggregation.scrub_nonfinite(lo_t, mk_t)
    want = ref_agg.scrub_nonfinite(logits, masks)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    if not poison:   # clean reports come back as the same objects
        assert got[0] is lo_t and got[1] is mk_t


def test_server_round_matches_reference_and_ledger():
    logits, masks = _reports(c=3, t=16, seed=2)
    x, y = _labelled(n=90, d=4, seed=2)
    px = ref_proxy.ProxyData(x, y, (np.arange(90) % 3).astype(np.int32))
    ref = RefServer(px, seed=0)
    port = Server(proxy.ProxyData(*px), seed=0, device="cpu")
    np.testing.assert_array_equal(port.select_indices(16),
                                  ref.select_indices(16))
    port.ingest_reports(0, logits, masks)
    ref.ingest_reports(0, None, np.arange(16), logits, masks, decay=0.0)
    t, v, stale = port.aggregate_round(0)
    t_w, v_w, stale_w = ref.aggregate_round(0)
    np.testing.assert_allclose(t.numpy(), t_w, **F32)
    np.testing.assert_array_equal(v.numpy(), v_w)
    assert stale == stale_w == 0.0
    assert port.bytes_received == ref.bytes_received
    assert port.bytes_broadcast == ref.bytes_broadcast
    assert port.pop_scrubbed(0) == ref.pop_scrubbed(0) == 2
    assert port.scrub_total == ref.scrub_total
    np.testing.assert_array_equal(port.scrub_clients, ref.scrub_clients)
    with pytest.raises(ValueError, match="no ingested reports"):
        port.aggregate_round(0)


# ------------------------------------------------------------------ losses

def test_losses_match_reference():
    rng = np.random.default_rng(3)
    s = (rng.standard_normal((48, 10)) * 3).astype(np.float32)
    t = (rng.standard_normal((48, 10)) * 3).astype(np.float32)
    w = (rng.random(48) > 0.3).astype(np.float32)
    y = rng.integers(0, 10, 48).astype(np.int32)
    st, tt, wt = (torch.from_numpy(a) for a in (s, t, w))
    for got, want in (
            (distill.kd_kl_loss(st, tt, 3.0, wt),
             ref_distill.kd_kl_loss(s, t, 3.0, w, backend="jnp")),
            (distill.kd_kl_loss(st, tt, 1.0),
             ref_distill.kd_kl_loss(s, t, 1.0, backend="jnp")),
            (distill.kd_mse_loss(st, tt, wt),
             ref_distill.kd_mse_loss(s, t, w)),
            (distill.ce_loss(st, torch.from_numpy(y)),
             ref_distill.ce_loss(s, y))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# -------------------------------------------------------- dispatch + methods

def test_resolve_explicit_wins_and_aliases_map():
    assert dispatch.resolve("cuda") == "cuda"
    assert dispatch.resolve("torch") == "torch"
    assert dispatch.resolve("pallas") == "cuda"
    assert dispatch.resolve("jnp") == "torch"


def test_resolve_auto_is_torch_without_a_card(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dispatch.resolve("auto") == "torch"
    assert dispatch.resolve(None) == "torch"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert dispatch.resolve("auto") == "cuda"


def test_resolve_env_overrides_auto(monkeypatch):
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    assert dispatch.resolve("auto") == "cuda"
    assert dispatch.resolve(None) == "cuda"
    assert dispatch.resolve("torch") == "torch"   # explicit still wins
    monkeypatch.setenv(dispatch.ENV_VAR, "jnp")
    assert dispatch.resolve(None) == "torch"


def test_context_manager_overrides_env(monkeypatch):
    monkeypatch.setenv(dispatch.ENV_VAR, "torch")
    with dispatch.kernel_backend("cuda"):
        assert dispatch.resolve(None) == "cuda"
        assert dispatch.resolve("torch") == "torch"   # explicit still wins
        with dispatch.kernel_backend("jnp"):          # innermost wins
            assert dispatch.resolve(None) == "torch"
        assert dispatch.resolve(None) == "cuda"
    assert dispatch.resolve(None) == "torch"


def test_unknown_backend_rejected(monkeypatch):
    with pytest.raises(ValueError, match="unknown kernel backend"):
        dispatch.resolve("mosaic")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        with dispatch.kernel_backend("triton"):
            pass
    monkeypatch.setenv(dispatch.ENV_VAR, "nope")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        dispatch.resolve(None)


def test_methods_outside_the_slice_raise():
    assert get_method("edgefd").client_filter == "kmeans"
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 4"):
        get_method("fedmd")
    with pytest.raises(KeyError, match="unknown method"):
        get_method("nope")
