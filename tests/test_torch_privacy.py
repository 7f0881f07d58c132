"""The port's proxy privatization (``repro_torch.core.privacy``) against the
JAX package's ``repro.core.privacy``.

``gaussian_sigma``/``make_dp`` equal the reference's (pure float
arithmetic); ``privatize_proxy_np`` (numpy on both sides) bit for bit from
the same rng state; ``clip_samples`` within 1e-6 of the reference's on
the same numpy rows (float32 norms summed in another order), every
clipped row's norm at most ``clip_norm`` + 1e-4 as the reference's test
holds; ``privatize_proxy`` draws its noise from a ``torch.Generator``
(the reference's from a JAX key: other numbers), so its noise is held to
the distribution, its std on a zero input within 10% of σ as the
reference's test holds, and to repeat bit for bit from one seed. The
reference's privacy/accuracy trade-off is rebuilt with numpy inputs and
the port's KMeans-DRE: balanced accuracy above 0.8 at ε = 100, and no
better at ε = 0.05.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro.core import privacy as RP
from repro_torch import core
from repro_torch.core import privacy as P
from repro_torch.core.dre import KMeansDRE


@pytest.mark.parametrize("eps,delta,clip", [(0.5, 1e-5, 1.0),
                                            (2.0, 1e-3, 10.0),
                                            (100.0, 1e-5, 0.3)])
def test_sigma_and_params_equal_the_references(eps, delta, clip):
    assert P.gaussian_sigma(eps, delta, clip) == \
        RP.gaussian_sigma(eps, delta, clip)
    assert tuple(P.make_dp(eps, delta, clip)) == \
        tuple(RP.make_dp(eps, delta, clip))
    assert P.make_dp(eps) == RP.make_dp(eps)
    assert core.make_dp is P.make_dp and core.privatize_proxy is \
        P.privatize_proxy and core.gaussian_sigma is P.gaussian_sigma
    with pytest.raises(ValueError, match="epsilon"):
        P.gaussian_sigma(0.0, delta, clip)
    assert P.gaussian_sigma(0.5, 1e-5, 1.0) > P.gaussian_sigma(2.0, 1e-5,
                                                               1.0)


@pytest.mark.parametrize("shape", [(500, 6), (7, 3, 4), (1, 1)])
def test_privatize_proxy_np_is_the_references_bit_for_bit(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(
        np.float32) * 3
    dp = P.make_dp(epsilon=2.0, clip_norm=2.5)
    got = P.privatize_proxy_np(np.random.default_rng(7), x, dp)
    want = RP.privatize_proxy_np(np.random.default_rng(7), x,
                                 RP.make_dp(epsilon=2.0, clip_norm=2.5))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,d,c,scale", [(32, 16, 0.1, 10.0),
                                         (9, 5, 5.0, 10.0),
                                         (20, 8, 1.0, 0.05)])
def test_clip_samples_holds_to_the_reference(n, d, c, scale):
    x = (np.random.default_rng(n).standard_normal((n, d)) * scale).astype(
        np.float32)
    x[0] = 0.0                                   # a zero row stays zero
    got = P.clip_samples(torch.from_numpy(x), c).numpy()
    want = np.asarray(RP.clip_samples(jnp.asarray(x), c))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.linalg.norm(got, axis=1).max() <= c + 1e-4
    assert not got[0].any()


def test_privatize_proxy_noise_scale_and_seed():
    dp = P.make_dp(epsilon=1.0, delta=1e-5, clip_norm=1.0)
    x = torch.zeros((2000, 8))
    out = P.privatize_proxy(torch.Generator().manual_seed(0), x, dp)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert abs(float(out.std()) - dp.sigma) / dp.sigma < 0.1
    again = P.privatize_proxy(torch.Generator().manual_seed(0), x, dp)
    assert torch.equal(out, again)
    # rows past the clip norm are clipped before the noise
    big = torch.full((4, 8), 3.0)
    quiet = P.make_dp(epsilon=1e9, clip_norm=1.0)
    norms = P.privatize_proxy(torch.Generator().manual_seed(1), big,
                              quiet).norm(dim=1)
    assert torch.allclose(norms, torch.ones(4), atol=1e-4)


def test_privacy_accuracy_tradeoff():
    """The reference test's construction, its inputs from numpy: 300
    private rows N(0, 1) in 8 dimensions, 100 OOD rows shifted by 8, a
    one-centroid KMeans-DRE on the private rows, and the privatized rows
    filtered by it at ε = 100, 1, 0.05 (clip 10)."""
    rng = np.random.default_rng(5)
    private = torch.from_numpy(rng.standard_normal((300, 8)).astype(
        np.float32))
    ood = torch.from_numpy(rng.standard_normal((100, 8)).astype(
        np.float32) + 8.0)
    dre = KMeansDRE(num_centroids=1).learn(
        private, generator=torch.Generator().manual_seed(2))
    accs = []
    for i, eps in enumerate((100.0, 1.0, 0.05)):
        dp = P.make_dp(epsilon=eps, clip_norm=10.0)
        noisy_id = P.privatize_proxy(torch.Generator().manual_seed(3 + i),
                                     private, dp)
        noisy_ood = P.privatize_proxy(torch.Generator().manual_seed(13 + i),
                                      ood, dp)
        accs.append((float(dre.is_id(noisy_id).float().mean())
                     + 1 - float(dre.is_id(noisy_ood).float().mean())) / 2)
    assert accs[0] > 0.8
    assert accs[0] >= accs[-1]
