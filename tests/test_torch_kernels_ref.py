"""Plain PyTorch versions of the ported kernels against the JAX package.

Each case makes its inputs with numpy from a seed and runs them through
the reference's Pallas kernel (interpret mode, as the JAX tests run it on
the CPU) and its jnp reference, and through the port's plain version —
the function the port's CUDA kernels are held to on the card.

Tolerances: Lloyd ``assign`` and ``counts`` equal, ``min_d2``/``sums``
within rtol 1e-5, atol 1e-5 (float32 matmuls in two libraries); the
temperature-KL forward and both gradients within rtol 1e-5, atol 1e-6.
The min-distance step and the RBF Gram matrix take their error from the
matmul form's cancelled terms, so their tolerances scale with them:
|Δdist²| ≤ 1e-5·(x² + c²) + 1e-5 and |ΔK| ≤ K·1e-5·(a² + b²)/(2σ²) +
1e-6; the ID masks agree wherever the distance is not within that error
of the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as ref_dispatch
from repro.kernels.distill_kl import ops as ref_kl_ops
from repro.kernels.distill_kl import ref as ref_kl_ref
from repro.kernels.kmeans_dist import ops as ref_kd_ops
from repro.kernels.kulsif_rbf import ops as ref_rbf_ops
from repro.kernels.kulsif_rbf import ref as ref_rbf_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.distill_kl import ops as kl_ops
from repro_torch.kernels.distill_kl import ref as kl_ref
from repro_torch.kernels.kmeans_dist import ops as kd_ops
from repro_torch.kernels.kmeans_dist import ref as kd_ref
from repro_torch.kernels.kulsif_rbf import ops as rbf_ops
from repro_torch.kernels.kulsif_rbf import ref as rbf_ref

LLOYD_TOL = dict(rtol=1e-5, atol=1e-5)
KL_TOL = dict(rtol=1e-5, atol=1e-6)
SCALED_RTOL = 1e-5      # relative to the terms the matmul form cancels
DIST2_ATOL = 1e-5
RBF_ATOL = 1e-6


def _lloyd_inputs(shape_x, k, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape_x) + 1.0).astype(np.float32)
    c = (rng.standard_normal(shape_x[:-2] + (k, shape_x[-1])) * 2
         ).astype(np.float32)
    return x, c


def _assert_lloyd_equal(got, want):
    a, m, s, c = (o.numpy() for o in got)
    a_w, m_w, s_w, c_w = (np.asarray(o) for o in want)
    np.testing.assert_array_equal(a, a_w)
    np.testing.assert_array_equal(c, c_w)
    np.testing.assert_allclose(m, m_w, **LLOYD_TOL)
    np.testing.assert_allclose(s, s_w, **LLOYD_TOL)


# ragged n: none is a multiple of the reference's 256-row block
@pytest.mark.parametrize("n,d,k", [(300, 50, 1), (300, 50, 3),
                                   (257, 50, 10), (131, 7, 3)])
def test_lloyd_step_plain_matches_pallas_and_jnp(n, d, k):
    x, c = _lloyd_inputs((n, d), k, seed=n + d + k)
    got = kd_ref.lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    assert got[0].dtype == torch.int32
    _assert_lloyd_equal(got, ref_kd_ops.lloyd_step(x, c, interpret=True))
    _assert_lloyd_equal(got, ref_dispatch._lloyd_step_jnp(jnp.asarray(x),
                                                          jnp.asarray(c)))


def test_lloyd_step_plain_batched_matches_pallas():
    x, c = _lloyd_inputs((3, 130, 9), 4, seed=0)
    got = kd_ref.lloyd_step(torch.from_numpy(x), torch.from_numpy(c))
    _assert_lloyd_equal(got, ref_kd_ops.lloyd_step(x, c, interpret=True))


def test_pairwise_sq_dists_matches_reference():
    x, c = _lloyd_inputs((40, 7), 5, seed=1)
    got = kd_ref.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c))
    want = ref_dispatch.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LLOYD_TOL)
    assert float(got.min()) >= 0.0


# ragged t: none is a multiple of the reference's 256-row block
@pytest.mark.parametrize("t,d,k", [(512, 50, 1), (300, 50, 3),
                                   (257, 50, 10), (131, 7, 3)])
def test_min_dist_and_mask_plain_matches_pallas_and_jnp(t, d, k):
    x, c = _lloyd_inputs((t, d), k, seed=t + d + k)
    got_d, got_m = kd_ref.min_dist_and_mask(torch.from_numpy(x),
                                            torch.from_numpy(c), 9.0)
    assert got_d.dtype == torch.float32 and got_m.dtype == torch.bool
    thr = float(np.median(got_d.numpy()))        # half the rows are ID
    got_m = kd_ref.min_dist_and_mask(torch.from_numpy(x),
                                     torch.from_numpy(c), thr)[1]
    scale = (np.sum(x * x, -1)
             + np.min(np.sum(c * c, -1)) + np.max(np.sum(c * c, -1)))
    tol2 = SCALED_RTOL * scale + DIST2_ATOL
    pallas_d, pallas_m = ref_kd_ops.min_dist_and_mask(x, c, thr,
                                                      interpret=True)
    jnp_d = np.asarray(ref_dispatch.pairwise_sq_dists(
        jnp.asarray(x), jnp.asarray(c)).min(-1)) ** 0.5
    for want_d in (np.asarray(pallas_d), jnp_d):
        err2 = np.abs(got_d.numpy() ** 2 - want_d ** 2)
        assert (err2 <= tol2).all(), float(err2.max())
    clear = np.abs(got_d.numpy() ** 2 - thr ** 2) > tol2
    np.testing.assert_array_equal(got_m.numpy()[clear],
                                  np.asarray(pallas_m).astype(bool)[clear])
    assert 0 < int(got_m.sum()) < t


def test_min_dist_and_mask_plain_is_the_old_distance_op_for_op():
    """The filter's distances stay bit for bit what ``core.kmeans``
    computes (so the parity runs of the first slice do not move), the mask
    is their threshold test, and a tensor threshold works as a float."""
    from repro_torch.core.kmeans import min_dist_to_centroids
    x, c = _lloyd_inputs((200, 50), 3, seed=5)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    d, m = kd_ref.min_dist_and_mask(xt, ct, 7.5)
    assert torch.equal(d, min_dist_to_centroids(xt, ct))
    assert torch.equal(m, d <= 7.5)
    d_t, m_t = kd_ref.min_dist_and_mask(xt, ct, torch.tensor(7.5))
    assert torch.equal(d_t, d) and torch.equal(m_t, m)
    assert bool(kd_ref.min_dist_and_mask(xt, ct, float("inf"))[1].all())


def _rbf_inputs(n, m, d, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, d)) + 0.5).astype(np.float32)
    b = (rng.standard_normal((m, d)) + 0.5).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n,m,d,sigma", [(256, 256, 50, 4.0),
                                         (300, 700, 50, 4.0),
                                         (37, 513, 8, 1.5), (5, 3, 2, 0.7)])
def test_rbf_matrix_plain_matches_pallas_and_jnp(n, m, d, sigma):
    a, b = _rbf_inputs(n, m, d, seed=n + m + d)
    got = rbf_ref.rbf_matrix(torch.from_numpy(a), torch.from_numpy(b),
                             sigma).numpy()
    assert got.shape == (n, m) and got.dtype == np.float32
    scale = np.sum(a * a, -1)[:, None] + np.sum(b * b, -1)[None, :]
    for want in (ref_rbf_ops.rbf_matrix(a, b, sigma, interpret=True),
                 ref_dispatch.rbf_matrix(jnp.asarray(a), jnp.asarray(b),
                                         sigma, backend="jnp")):
        want = np.asarray(want)
        tol = want * SCALED_RTOL * scale / (2 * sigma * sigma) + RBF_ATOL
        err = np.abs(got - want)
        assert (err <= tol).all(), float(err.max())
    # the direct-difference oracle agrees too, away from cancellation
    np.testing.assert_allclose(
        got, np.asarray(ref_rbf_ref.rbf_matrix(jnp.asarray(a),
                                               jnp.asarray(b), sigma)),
        rtol=1e-4, atol=RBF_ATOL)


def _kl_inputs(n, k, seed, scale=3.0):
    """Logits at ``scale`` (the temperature, so s/T ~ N(0, 1) as on the
    main path): at |s/T| near 10 the reference kernel's d_teacher formula
    cancels and drifts past 1e-5 relative from autograd's."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((n, k)) * scale).astype(np.float32)
    t = (rng.standard_normal((n, k)) * scale).astype(np.float32)
    g = rng.standard_normal((n,)).astype(np.float32)
    return s, t, g


@pytest.mark.parametrize("n,k,temp", [(64, 10, 3.0), (300, 10, 1.0),
                                      (37, 1000, 3.0)])
def test_kd_kl_plain_forward_and_grads_match_reference(n, k, temp):
    s, t, g = _kl_inputs(n, k, seed=n + k, scale=temp)
    s_ = torch.tensor(s, requires_grad=True)
    t_ = torch.tensor(t, requires_grad=True)
    out = kl_ref.kd_kl_per_sample(s_, t_, temp)
    ds, dt = torch.autograd.grad(out, (s_, t_), torch.from_numpy(g))
    oracles = (
        # the Pallas custom-VJP op: forward kernel + fused backward kernels
        lambda a, b: ref_kl_ops.kd_kl_per_sample_vjp(a, b, temp,
                                                     interpret=True),
        # the jnp oracle under jax.vjp
        lambda a, b: ref_kl_ref.kd_kl_per_sample(a, b, temp),
    )
    for fn in oracles:
        want, vjp = jax.vjp(fn, jnp.asarray(s), jnp.asarray(t))
        ds_w, dt_w = vjp(jnp.asarray(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **KL_TOL)
        np.testing.assert_allclose(ds.numpy(), np.asarray(ds_w), **KL_TOL)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dt_w), **KL_TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    """On a CPU tensor the wrappers take the plain version — also when the
    kernel backend is requested explicitly — and count no launch."""
    x, c = _lloyd_inputs((70, 5), 2, seed=3)
    s, t, _ = _kl_inputs(8, 10, seed=3)
    before = (kd_ops.lloyd_step_cuda.launches,
              kl_ops.kd_kl_fwd_cuda.launches,
              kd_ops.min_dist_and_mask_cuda.launches,
              rbf_ops.rbf_matrix_cuda.launches)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    for got in (kd_ops.lloyd_step(xt, ct),
                dispatch.lloyd_step(xt, ct, backend="cuda")):
        for u, v in zip(got, kd_ref.lloyd_step(xt, ct)):
            assert torch.equal(u, v)
    st, tt = torch.from_numpy(s), torch.from_numpy(t)
    want = kl_ref.kd_kl_per_sample(st, tt, 3.0)
    assert torch.equal(kl_ops.kd_kl_per_sample(st, tt, 3.0), want)
    assert torch.equal(dispatch.kd_kl_per_sample(st, tt, 3.0,
                                                 backend="pallas"), want)
    for got in (kd_ops.min_dist_and_mask(xt, ct, 1.0),
                dispatch.min_dist_and_mask(xt, ct, 1.0, backend="cuda")):
        for u, v in zip(got, kd_ref.min_dist_and_mask(xt, ct, 1.0)):
            assert torch.equal(u, v)
    want = rbf_ref.rbf_matrix(xt, ct, 2.0)
    assert torch.equal(rbf_ops.rbf_matrix(xt, ct, 2.0), want)
    assert torch.equal(dispatch.rbf_matrix(xt, ct, 2.0, backend="pallas"),
                       want)
    assert before == (kd_ops.lloyd_step_cuda.launches,
                      kl_ops.kd_kl_fwd_cuda.launches,
                      kd_ops.min_dist_and_mask_cuda.launches,
                      rbf_ops.rbf_matrix_cuda.launches)


def test_wrappers_refuse_tensors_they_have_no_kernel_for():
    """Neither CPU nor CUDA: the wrappers raise, they never fall back."""
    x = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kd_ops.lloyd_step(x, torch.empty((2, 3), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        kl_ops.kd_kl_per_sample(x, x, 3.0)
    with pytest.raises(ValueError, match="no kernel"):
        kd_ops.min_dist_and_mask(x, torch.empty((2, 3), device="meta"), 1.0)
    with pytest.raises(ValueError, match="no kernel"):
        rbf_ops.rbf_matrix(x, x, 1.0)
    # the launching wrappers take CUDA tensors only
    with pytest.raises(ValueError, match="no kernel"):
        kd_ops.lloyd_step_cuda(torch.zeros((1, 4, 3)), torch.zeros((1, 2, 3)))
    with pytest.raises(ValueError, match="no kernel"):
        kl_ops.kd_kl_fwd_cuda(torch.zeros((4, 3)), torch.zeros((4, 3)), 3.0)
    with pytest.raises(ValueError, match="no kernel"):
        kd_ops.min_dist_and_mask_cuda(torch.zeros((4, 3)),
                                      torch.zeros((2, 3)), torch.ones(1))
    with pytest.raises(ValueError, match="no kernel"):
        rbf_ops.rbf_matrix_cuda(torch.zeros((4, 3)), torch.zeros((2, 3)),
                                1.0)
