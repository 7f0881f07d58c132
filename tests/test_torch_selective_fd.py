"""The Selective-FD baseline in the port against the JAX reference: the
whole method against a live reference run (strong and weak), and its two
pieces on their own — the KuLSIF density-ratio estimator (learn and
estimate with the reference's auxiliary samples, and the two-stage filter
over it) and the server-side entropy filter.

The harness and its tolerances are in ``tests/_torch_parity.py``; here the
near-threshold pairs are those whose KuLSIF ratio lies within 1e-5
relative of ``kulsif_threshold``. Module tolerances: the ratio within
rtol 1e-5, atol 1e-6 (float32 Gram matrices and a 256×256 solve in two
libraries); masks equal away from the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_logs_match, config
from repro.core.filtering import server_entropy_filter as ref_entropy_filter
from repro.core.filtering import two_stage_filter as ref_two_stage_filter
from repro.core.methods import METHODS as REF_METHODS
from repro_torch.core.dre import KuLSIFDRE, make_dre, rbf_kernel
from repro_torch.core.filtering import server_entropy_filter, two_stage_filter
from repro_torch.core.methods import METHODS

RATIO_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scenario", ["strong", "weak"])
def test_selective_fd_round_logs_match_live_reference(scenario):
    ref, port = assert_logs_match(config("selective-fd", scenario))
    for pc, rc in zip(port.clients, ref.clients):
        np.testing.assert_array_equal(pc.dre.aux.numpy(),
                                      np.asarray(rc.dre.aux))
    # the filter kept something and dropped something
    assert 0.0 < port.result.rounds[0].id_fraction < 1.0


def _private_and_probe(seed=0, n=300, d=8):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) + 2.0).astype(np.float32)
    probe = np.concatenate([x[::9] + 0.1 * rng.standard_normal((34, d)),
                            rng.standard_normal((30, d)) * 4 - 3]
                           ).astype(np.float32)
    return x, probe


def _kulsif_pair(x, seed=0):
    """The reference's KuLSIF fit under PRNGKey(seed), and the port's fit
    with the reference's auxiliary samples."""
    m = REF_METHODS["selective-fd"].make_dre(num_centroids=1, threshold=None,
                                             kernel_backend="jnp")
    ref = m.learn(jax.random.PRNGKey(seed), jnp.asarray(x))
    port = METHODS["selective-fd"].make_dre(
        num_centroids=1, threshold=None).learn(
        torch.from_numpy(x), aux=torch.tensor(np.asarray(ref.aux)))
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
def test_kulsif_learn_and_estimate_match_with_injected_aux(seed):
    x, probe = _private_and_probe(seed)
    ref, port = _kulsif_pair(x, seed)
    assert isinstance(port, KuLSIFDRE)
    assert (port.sigma, port.lam, port.num_aux, port.threshold) == (
        ref.sigma, ref.lam, ref.num_aux, ref.threshold)
    np.testing.assert_allclose(port.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=1e-4, atol=1e-6)
    r = port.estimate(torch.from_numpy(probe)).numpy()
    r_w = np.asarray(ref.estimate(jnp.asarray(probe)))
    np.testing.assert_allclose(r, r_w, **RATIO_TOL)
    away = np.abs(r_w - ref.threshold) > 1e-4 * ref.threshold
    np.testing.assert_array_equal(
        port.is_id(torch.from_numpy(probe)).numpy()[away],
        np.asarray(ref.is_id(jnp.asarray(probe)))[away])
    # the probe straddles the threshold: a real test of the filter
    assert int(away.sum()) > 0
    assert 0 < int((r_w >= ref.threshold).sum()) < len(r_w)


def test_kulsif_two_stage_filter_matches():
    x, probe = _private_and_probe(2)
    ref, port = _kulsif_pair(x, 2)
    owner = (np.arange(len(probe)) % 3).astype(np.int32)
    got = two_stage_filter(port, torch.from_numpy(probe),
                           torch.from_numpy(owner), 1)
    want = ref_two_stage_filter(ref, jnp.asarray(probe), jnp.asarray(owner), 1)
    for a, b in zip(got[:3], want[:3]):          # mask, stage1, stage2
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), **RATIO_TOL)


def test_kulsif_learns_its_own_aux_in_the_bounding_box():
    x, _ = _private_and_probe(3)
    g = torch.Generator().manual_seed(5)
    a = KuLSIFDRE(num_aux=64).learn(torch.from_numpy(x), generator=g)
    b = KuLSIFDRE(num_aux=64).learn(torch.from_numpy(x),
                                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.aux, b.aux) and a.aux.shape == (64, x.shape[1])
    lo, hi = torch.from_numpy(x.min(0)), torch.from_numpy(x.max(0))
    assert bool(((a.aux >= lo) & (a.aux <= hi)).all())
    assert torch.isfinite(a.alpha).all()
    with pytest.raises(RuntimeError, match="learn"):
        KuLSIFDRE().estimate(torch.from_numpy(x))


def test_make_dre_and_rbf_kernel():
    assert isinstance(make_dre("kulsif", sigma=2.0), KuLSIFDRE)
    assert make_dre("kmeans", num_centroids=3).num_centroids == 3
    with pytest.raises(ValueError, match="unknown DRE kind"):
        make_dre("knn")
    a = torch.zeros((2, 3))
    np.testing.assert_allclose(rbf_kernel(a, a + 1.0, 1.0).numpy(),
                               np.exp(-1.5), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_server_entropy_filter_matches(seed):
    rng = np.random.default_rng(seed)
    # logits from confident to flat, so the filter drops some rows
    scale = rng.choice([0.05, 0.5, 5.0], (4, 40, 1))
    logits = (rng.standard_normal((4, 40, 10)) * scale).astype(np.float32)
    mask = rng.random((4, 40)) > 0.3
    got = server_entropy_filter(torch.from_numpy(logits),
                                torch.from_numpy(mask)).numpy()
    want = np.asarray(ref_entropy_filter(jnp.asarray(logits),
                                         jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert 0 < int(got.sum()) < int(mask.sum())
