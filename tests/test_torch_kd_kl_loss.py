"""The fused temperature-KL loss's plain version against the JAX package.

The port runs one distill step's loss, the weighted mean of the
per-sample T²·KL, as one launch of a fused kernel on the card
(``distill_kl.ops.kd_kl_loss``); its plain version is
``distill_kl.ref.kd_kl_loss``, which the CPU route and the card's checks
use. Each case makes its inputs with numpy from a seed and holds the plain
version, and ``dispatch.kd_kl_loss`` on the plain route, to the live
``repro.core.distill.kd_kl_loss`` under its jnp backend and under its
Pallas backend (interpret mode, as the JAX tests run it on the CPU): the
loss and the gradients for the student and the teacher (``jax.grad``
against torch autograd), within rtol 1e-5, atol 1e-6. Logits are drawn at
the temperature's scale: at |logit/T| near 10 the reference kernel's
d_teacher formula cancels (ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as ref_distill
from repro_torch.core import distill
from repro_torch.kernels import dispatch
from repro_torch.kernels.distill_kl import ops as kl_ops
from repro_torch.kernels.distill_kl import ref as kl_ref

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(64, 10), (64, 32), (300, 10), (7, 1000)]
WEIGHTS = ["random", "with_zeros", "all_zero", "none"]


def _inputs(n, k, temp, weights, seed):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((n, k)) * temp).astype(np.float32)
    t = (rng.standard_normal((n, k)) * temp).astype(np.float32)
    w = {"random": rng.random(n),
         "with_zeros": rng.random(n) * (rng.random(n) > 0.4),
         "all_zero": np.zeros(n),
         "none": None}[weights]
    return s, t, None if w is None else w.astype(np.float32)


def _reference(s, t, temp, w, backend):
    """Loss and (d_student, d_teacher) of the reference's loss."""
    wj = None if w is None else jnp.asarray(w)

    def f(a, b):
        return ref_distill.kd_kl_loss(a, b, temp, wj, backend=backend)

    loss, grads = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(s),
                                                        jnp.asarray(t))
    return np.asarray(loss), tuple(np.asarray(g) for g in grads)


def _port(fn, s, t, temp, w):
    st = torch.tensor(s, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    wt = None if w is None else torch.from_numpy(w)
    loss = fn(st, tt, temp, wt)
    ds, dt = torch.autograd.grad(loss, (st, tt))
    return loss.detach().numpy(), (ds.numpy(), dt.numpy())


def _check_against_reference(n, k, temp, weights, backend):
    s, t, w = _inputs(n, k, temp, weights, seed=n * 7 + k)
    want_loss, (want_ds, want_dt) = _reference(s, t, temp, w, backend)
    routes = (kl_ref.kd_kl_loss,
              lambda a, b, T, v: dispatch.kd_kl_loss(a, b, T, v,
                                                     backend="torch"))
    for route in routes:
        loss, (ds, dt) = _port(route, s, t, temp, w)
        np.testing.assert_allclose(loss, want_loss, **TOL)
        np.testing.assert_allclose(ds, want_ds, **TOL)
        np.testing.assert_allclose(dt, want_dt, **TOL)
    if weights == "all_zero":
        # max(sum w, 1) keeps the mean finite: a zero loss and gradients
        assert float(loss) == 0.0 and not ds.any() and not dt.any()


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("temp", [1.0, 3.0])
@pytest.mark.parametrize("n,k", SHAPES)
def test_plain_fused_loss_matches_reference(n, k, temp, weights, backend):
    _check_against_reference(n, k, temp, weights, backend)


@pytest.mark.parametrize("weights", ["with_zeros", "none"])
@pytest.mark.parametrize("n,k,temp", [(4, 1025, 1.0), (4, 1025, 3.0),
                                      (4, 8193, 1.0), (4, 8193, 3.0),
                                      (2, 50304, 3.0)])
def test_plain_fused_loss_matches_reference_on_wide_rows(n, k, temp,
                                                         weights):
    """Rows past the register route's 1024 columns, which the card runs on
    the wide-row route: the first width past it, a row of two blocks and
    xlstm-350m's vocabulary at the FD trainers' temperature (the reference
    under jnp; its Pallas kernel in interpret mode costs seconds a case)."""
    _check_against_reference(n, k, temp, weights, "jnp")


@pytest.mark.parametrize("weights", ["random", "none"])
def test_core_loss_keeps_its_leading_axes(weights):
    """``core.distill.kd_kl_loss`` takes (..., K) logits and a weight of
    the leading shape, as the reference does."""
    s, t, w = _inputs(24, 10, 3.0, weights, seed=5)
    s3, t3 = s.reshape(4, 6, 10), t.reshape(4, 6, 10)
    w3 = None if w is None else w.reshape(4, 6)
    got = distill.kd_kl_loss(torch.from_numpy(s3), torch.from_numpy(t3), 3.0,
                             None if w3 is None else torch.from_numpy(w3))
    want = ref_distill.kd_kl_loss(s3, t3, 3.0, w3, backend="jnp")
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_cpu_tensors_take_the_plain_fused_loss_without_launching():
    """On CPU tensors the kernel route is the plain version, bit for bit,
    also when the kernel backend is asked for, and counts no launch."""
    s, t, w = _inputs(64, 10, 3.0, "with_zeros", seed=9)
    st, tt, wt = (torch.from_numpy(a) for a in (s, t, w))
    before = (kl_ops.kd_kl_loss_cuda.launches, kl_ops.kd_kl_fwd_cuda.launches,
              kl_ops.kd_kl_bwd_ds_cuda.launches)
    want = kl_ref.kd_kl_loss(st, tt, 3.0, wt)
    for got in (kl_ops.kd_kl_loss(st, tt, 3.0, wt),
                dispatch.kd_kl_loss(st, tt, 3.0, wt, backend="cuda"),
                dispatch.kd_kl_loss(st, tt, 3.0, wt, backend="pallas"),
                distill.kd_kl_loss(st, tt, 3.0, wt, backend="cuda")):
        assert torch.equal(got, want)
    assert before == (kl_ops.kd_kl_loss_cuda.launches,
                      kl_ops.kd_kl_fwd_cuda.launches,
                      kl_ops.kd_kl_bwd_ds_cuda.launches)


def test_fused_loss_refuses_tensors_it_has_no_kernel_for():
    """Neither CPU nor CUDA: the op raises and never falls back; the
    launching wrapper takes CUDA tensors only."""
    x = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kl_ops.kd_kl_loss(x, x, 3.0)
    with pytest.raises(ValueError, match="no kernel"):
        kl_ops.kd_kl_loss_cuda(torch.zeros((4, 3)), torch.zeros((4, 3)),
                               None, 3.0)
