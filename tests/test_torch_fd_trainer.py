"""The port's FD trainer for the large backbones (``core.fd_trainer``)
against the JAX package's, set up as ``tests/test_fd_trainer.py`` sets it
up: granite-8b (and granite-moe-1b-a400m for ``fd_loss``; xlstm-350m and
recurrentgemma-2b for ``fd_round_local``) reduced to 2 layers (3 for
recurrentgemma's period), d_model 64, vocab 64; three clients whose private tokens come
from distinct vocab bands, each with a one-centroid KMeans-DRE on pooled
embeddings (threshold 1.5 times its largest private distance), a proxy of
one row from each client, SGD at 1e-2.

The reference's weights, tokens, centroids and thresholds are exported as
numpy and loaded into the port. ``fd_loss`` holds within rtol 1e-5 (with
``distill_weight`` on a zero teacher weight equal to ``train_loss``);
``fd_round_local`` on three clients gives the reference's ID fraction
exactly and its losses and updated parameters within rtol 1e-5, atol
1e-6; ``make_fd_train_step`` on two gloo ranks, one client a rank (the
teacher one all-reduce), gives two clients' ``fd_round_local`` within
rtol 1e-6, atol 1e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_prog
import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro import configs as RC
from repro.core import fd_trainer as RFD
from repro.core.kmeans import kmeans_fit, min_dist_to_centroids
from repro.models import transformer as RT
from repro.optim.optimizers import sgd as ref_sgd
from repro_torch import configs as C
from repro_torch.core import fd_trainer as FD
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import sgd

LR = 1e-2
TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    return _setup("granite-8b")


def _setup(arch):
    cfg_r = RC.reduced(RC.get_arch(arch), d_model=64, vocab=64)
    cfg = C.reduced(C.get_arch(arch), d_model=64, vocab=64)
    key = jax.random.PRNGKey(0)
    n_clients, B, S = 3, 2, 16
    opt = ref_sgd(LR)
    states, cents, thrs, batches = [], [], [], []
    # compiled, as the reference's callers run them: the same values
    init = jax.jit(RT.init_params, static_argnums=0)
    fit = jax.jit(kmeans_fit, static_argnums=2)
    for c in range(n_clients):
        kc = jax.random.fold_in(key, c)
        params = init(cfg_r, kc)
        states.append((params, opt.init(params)))
        lo = c * cfg_r.vocab_size // n_clients
        hi = (c + 1) * cfg_r.vocab_size // n_clients
        toks = jax.random.randint(kc, (B, S), lo, hi)
        batches.append({"tokens": toks, "labels": toks})
        feats = RFD.proxy_features(params, cfg_r, toks)
        res = fit(kc, feats, 1)
        cents.append(res.centroids)
        thrs.append(float(jnp.max(min_dist_to_centroids(
            feats, res.centroids))) * 1.5)
    proxy = jnp.concatenate([b["tokens"][:1] for b in batches])
    owner = jnp.arange(n_clients, dtype=jnp.int32)
    arrays = dict(params=[_np_tree(s[0]) for s in states],
                  batches=[_np_tree(b) for b in batches],
                  proxy=np.asarray(proxy), owner=np.asarray(owner),
                  centroids=[np.asarray(c) for c in cents], thresholds=thrs)
    ref = (cfg_r, opt, states, batches, proxy, owner, cents, thrs)
    return ref, cfg, arrays


def _port_states(cfg, arrays, n=None):
    opt = sgd(LR)
    models = [T.Transformer(cfg).load_jax_params(p)
              for p in arrays["params"][:n]]
    return opt, [(m, opt.init(list(m.parameters()))) for m in models]


def _t(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def _port_round(cfg, arrays, n=3):
    opt, states = _port_states(cfg, arrays, n)
    return FD.fd_round_local(
        opt, states, [_t(b) for b in arrays["batches"][:n]],
        torch.as_tensor(arrays["proxy"][:n]).long(),
        torch.as_tensor(arrays["owner"][:n]),
        [torch.as_tensor(c) for c in arrays["centroids"][:n]],
        arrays["thresholds"][:n])


@pytest.fixture(autouse=True)
def compiled_reference(monkeypatch):
    """The reference's loss and forward compiled (as its jitted callers
    run them) instead of op by op: the same functions, faster."""
    monkeypatch.setattr(RFD, "fd_loss", jax.jit(
        RFD.fd_loss, static_argnums=1,
        static_argnames=("temperature", "distill_weight", "remat")))
    monkeypatch.setattr(RT, "forward", jax.jit(
        RT.forward, static_argnums=1,
        static_argnames=("remat", "window_override")))


def test_fd_round_local_matches_the_reference(setup):
    _round_matches_the_reference(setup)


@pytest.mark.parametrize("arch", ["xlstm-350m", "recurrentgemma-2b"])
def test_fd_round_local_on_the_recurrent_families(arch):
    """The same round on three clients of the recurrent families: every
    backbone runs through ``T.forward`` in the reference and
    ``forward_aux`` in the port, unchanged."""
    _round_matches_the_reference(_setup(arch))


def _round_matches_the_reference(setup):
    (cfg_r, opt, states, batches, proxy, owner, cents, thrs), cfg, arrays \
        = setup
    ref_states, ref_metrics, ref_frac = RFD.fd_round_local(
        cfg_r, opt, states, batches, proxy, owner, cents, thrs)
    new_states, metrics, frac = _port_round(cfg, arrays)
    assert frac == pytest.approx(ref_frac, abs=1e-7)
    assert 1.0 / 3 - 1e-6 <= frac < 1.0        # the bands filter
    for m, rm in zip(metrics, ref_metrics):
        for k in ("loss", "kl", "ce", "aux", "ce_local"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert float(m["kl"]) >= -1e-5
    for (model, _), (rp, _) in zip(new_states, ref_states):
        for a, b in zip(jax.tree.leaves(model.jax_params()),
                        jax.tree.leaves(_np_tree(rp))):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-1b-a400m"])
def test_fd_loss_matches_the_reference(setup, arch):
    (_, _, _, batches, proxy, _, _, _), _, arrays = setup
    cfg_r = RC.reduced(RC.get_arch(arch), d_model=64, vocab=64)
    cfg = C.reduced(C.get_arch(arch), d_model=64, vocab=64)
    params = RT.init_params(cfg_r, jax.random.PRNGKey(7))
    model = T.Transformer(cfg).load_jax_params(_np_tree(params))
    rng = np.random.default_rng(1)
    teacher = rng.standard_normal((3, 64)).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    want, wm = RFD.fd_loss(params, cfg_r, batches[0], proxy,
                           jnp.asarray(teacher), jnp.asarray(w),
                           distill_weight=0.5)
    got, gm = FD.fd_loss(model, _t(arrays["batches"][0]),
                         torch.as_tensor(arrays["proxy"]).long(),
                         torch.tensor(teacher), torch.tensor(w),
                         distill_weight=0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ("kl", "ce", "aux"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5,
                                   atol=1e-7)
    # distill weight on a zero teacher weight: the CE alone
    zero = torch.zeros((3, 64))
    loss, _ = FD.fd_loss(model, _t(arrays["batches"][0]),
                         torch.as_tensor(arrays["proxy"]).long(), zero,
                         torch.zeros(3), distill_weight=1.0)
    ce_only, _ = T.train_loss(model, _t(arrays["batches"][0]))
    np.testing.assert_allclose(float(loss), float(ce_only), rtol=1e-5)


def test_psum_step_on_two_ranks_equals_the_local_round(setup, tmp_path):
    _, cfg, arrays = setup
    arch = dataclasses.asdict(cfg)
    arch["attention"] = cfg.attention
    two = {k: (v[:2] if isinstance(v, (list, np.ndarray)) else v)
           for k, v in arrays.items()}
    ranks = _torch_mesh_prog.spawn(2, "fd_step", dict(
        arch=arch, params=two["params"], batches=two["batches"],
        proxy=two["proxy"], owner=two["owner"], centroids=two["centroids"],
        thresholds=two["thresholds"], lr=LR), tmp_path, timeout=120)
    new_states, metrics, _ = _port_round(cfg, arrays, n=2)
    for r, got in enumerate(ranks):
        want = new_states[r][0].jax_params()
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for k in ("loss", "kl", "ce"):
            np.testing.assert_allclose(got["metrics"][k],
                                       float(metrics[r][k]), rtol=1e-6)
        assert 0.0 < got["metrics"]["id_fraction"] <= 1.0
