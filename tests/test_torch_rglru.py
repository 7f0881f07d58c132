"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``).

Weights come from the reference's ``init_rglru``, inputs from numpy
seeds; B = 2, d = 24. The forward (the doubling scan against the
reference's ``associative_scan``) and its gradients at S = 16 and at S =
21 (not a power of two), the scan against a loop over time at lengths 1
to 33, the conv with and without its decode tail, and decode step by step
with the tail carried. Outputs and states within rtol 1e-5, atol 1e-5;
gradients within rtol 1e-5 and an atol of 1e-5 times the largest
gradient (float32 sums of cancelling terms in two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro.models import rglru as RR
from repro_torch.models import rglru as R

B, D = 2, 24
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    return RR.init_rglru(jax.random.PRNGKey(2), D)


def _port(params, grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                               requires_grad=grad), params)


def _x(seed, seq):
    return (np.random.default_rng(seed).standard_normal((B, seq, D))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("seq", [16, 21])
def test_rglru_forward_and_grads_match_the_reference(params, seq):
    x = _x(seq, seq)
    p = _port(params, grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = R.rglru_forward(p, xt)
    g = torch.autograd.grad(torch.sum(out ** 2), jax.tree.leaves(p) + [xt])
    want = RR.rglru_forward(params, jnp.asarray(x))
    wp, wx = jax.jit(jax.grad(
        lambda q, y: jnp.sum(RR.rglru_forward(q, y) ** 2),
        argnums=(0, 1)))(params, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    wl = [np.asarray(a) for a in jax.tree.leaves(wp)] + [np.asarray(wx)]
    atol = 1e-5 * max(float(np.abs(a).max()) for a in wl)
    for a, b in zip(g, wl):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("seq", [1, 2, 3, 7, 8, 16, 33])
def test_doubling_scan_is_the_recurrence(seq):
    """h_t = a_t h_{t-1} + b_t stepped in a loop, at lengths on and off
    the powers of two; a in (0, 1) as the gate makes it."""
    rng = np.random.default_rng(seq)
    a = torch.tensor(rng.uniform(0.05, 0.999, (B, seq, D)).astype(
        np.float32))
    b = torch.tensor(rng.standard_normal((B, seq, D)).astype(np.float32))
    h = torch.zeros((B, D))
    want = []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(R._scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), **TOL)


def test_conv_and_gates_match_the_reference(params):
    x = _x(3, 9)
    tail = np.random.default_rng(4).standard_normal(
        (B, R.CONV_W - 1, D)).astype(np.float32)
    p = _port(params)
    for t_r, t in ((None, None), (jnp.asarray(tail), torch.tensor(tail))):
        np.testing.assert_allclose(
            R._conv1d(p, torch.tensor(x), tail=t).numpy(),
            np.asarray(RR._conv1d(params, jnp.asarray(x), tail=t_r)), **TOL)
    a, bx = R._gates(p, torch.tensor(x))
    a_r, bx_r = RR._gates(params, jnp.asarray(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_r), **TOL)
    np.testing.assert_allclose(bx.numpy(), np.asarray(bx_r), **TOL)
    assert 0.0 < float(a.min()) and float(a.max()) < 1.0


def test_rglru_decode_with_its_conv_tail(params):
    seq = 12
    x = _x(5, seq)
    p = _port(params)
    st_r = RR.rglru_zero_state(B, D)
    st = R.rglru_zero_state(B, D)
    step = jax.jit(RR.rglru_decode)
    outs = []
    for t in range(seq):
        y_r, st_r = step(params, jnp.asarray(x[:, t:t + 1]), st_r)
        with torch.no_grad():
            y, st = R.rglru_decode(p, torch.tensor(x[:, t:t + 1]), st)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
        outs.append(y[:, 0])
    for a, b in zip(st, st_r):
        assert a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # stepped token by token, the forward over the whole sequence
    with torch.no_grad():
        whole = R.rglru_forward(p, torch.tensor(x))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), whole.numpy(),
                               **TOL)
