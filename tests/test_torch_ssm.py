"""The port's xLSTM blocks (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``).

Weights come from the reference's ``init_mlstm``/``init_slstm``, inputs
from numpy seeds; B = 2, d = 32, 2 heads. The mLSTM's chunkwise forward
at S = 20 with ``chunk=8`` (three chunks, the last padded) and at the
default chunk (one chunk of 20), its gradients, and its decode step by
step; the sLSTM's forward and gradients under both routes
(``set_slstm_custom_vjp(True)``: the ``torch.autograd.Function`` against
the reference's ``custom_vjp``; ``False``: plain autograd through the
time loop against the reference's plain scan), ``set_slstm_unroll``
leaving the bits unchanged, and its decode. Outputs and states hold
within rtol 1e-5, atol 1e-5; gradients within rtol 1e-5 and an atol of
1e-5 times the largest gradient (float32 sums of cancelling terms in two
libraries).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro.models import ssm as RS
from repro_torch.models import ssm as S

B, SEQ, D, N = 2, 20, 32, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _torch_tree(t):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                               requires_grad=True), t)


def _x(seed, scale=0.5, seq=SEQ):
    return (np.random.default_rng(seed).standard_normal((B, seq, D))
            * scale).astype(np.float32)


def _assert_grads(got, want):
    atol = 1e-5 * max(float(np.abs(np.asarray(w)).max())
                      for w in jax.tree.leaves(want))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=atol)


def _port_grads(fn, p, x):
    """fn's output, and the gradients of sum(out²) for the parameters
    ``p`` (a tree of leaf tensors) and for x, as numpy."""
    xt = torch.tensor(x, requires_grad=True)
    out = fn(p, xt)
    leaves = jax.tree.leaves(p)
    g = torch.autograd.grad(torch.sum(out ** 2), leaves + [xt])
    gp = jax.tree.unflatten(jax.tree.structure(p),
                            [t.numpy() for t in g[:-1]])
    return out.detach().numpy(), gp, g[-1].numpy()


def _ref_grads(fn, p, x):
    out = fn(p, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(lambda q, y: jnp.sum(fn(q, y) ** 2),
                              argnums=(0, 1)))(p, jnp.asarray(x))
    return np.asarray(out), gp, np.asarray(gx)


@pytest.fixture(scope="module")
def mlstm_params():
    return RS.init_mlstm(jax.random.PRNGKey(0), D, N)


@pytest.fixture(scope="module")
def slstm_params():
    return RS.init_slstm(jax.random.PRNGKey(1), D, N)


@contextlib.contextmanager
def _route(custom_vjp):
    """Both packages' sLSTM route set, restored after."""
    was = (RS.USE_SLSTM_CUSTOM_VJP, S.USE_SLSTM_CUSTOM_VJP)
    RS.set_slstm_custom_vjp(custom_vjp)
    S.set_slstm_custom_vjp(custom_vjp)
    try:
        yield
    finally:
        RS.set_slstm_custom_vjp(was[0])
        S.set_slstm_custom_vjp(was[1])


@pytest.mark.parametrize("chunk", [8, S.CHUNK])
def test_mlstm_forward_and_grads_match_the_reference(mlstm_params, chunk):
    """Chunk 8 crosses two chunk boundaries and pads the last chunk with
    zeros; the default chunk takes the sequence in one. The gradients
    stay finite through the clamped decay above the diagonal."""
    x = _x(2)
    p = _torch_tree(mlstm_params)
    got, gp, gx = _port_grads(
        lambda q, y: S.mlstm_forward(q, y, N, chunk=chunk), p, x)
    want, wp, wx = _ref_grads(
        lambda q, y: RS.mlstm_forward(q, y, N, chunk=chunk), mlstm_params,
        x)
    np.testing.assert_allclose(got, want, **TOL)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(gp))
    _assert_grads(gp, wp)
    np.testing.assert_allclose(gx, wx, rtol=1e-5,
                               atol=1e-5 * np.abs(wx).max())


def test_mlstm_padding_and_chunks_change_nothing_but_rounding(mlstm_params):
    """The chunkwise forward at chunks 8, 7 and 20 agree (the reference's
    chunkwise form against itself)."""
    x = torch.tensor(_x(3))
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), mlstm_params)
    with torch.no_grad():
        outs = [S.mlstm_forward(p, x, N, chunk=c) for c in (8, 7, 20)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), **TOL)


def test_mlstm_decode_step_by_step(mlstm_params):
    x = _x(4)
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), mlstm_params)
    h = 2 * D // N
    st_r = RS.mlstm_zero_state(B, N, h)
    st = S.mlstm_zero_state(B, N, h)
    step = jax.jit(RS.mlstm_decode, static_argnums=3)
    outs = []
    for t in range(SEQ):
        y_r, st_r = step(mlstm_params, jnp.asarray(x[:, t:t + 1]), st_r, N)
        with torch.no_grad():
            y, st = S.mlstm_decode(p, torch.tensor(x[:, t:t + 1]), st, N)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
        outs.append(y[:, 0])
    for a, b in zip(st, st_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the recurrence stepped token by token is the chunkwise forward (the
    # reference's own check, tests/test_recurrent_refs.py, same tolerance)
    with torch.no_grad():
        whole = S.mlstm_forward(p, torch.tensor(x), N, chunk=8)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), whole.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("custom_vjp", [True, False])
def test_slstm_forward_and_grads_match_the_reference(slstm_params,
                                                     custom_vjp):
    x = _x(5, scale=1.0)
    with _route(custom_vjp):
        p = _torch_tree(slstm_params)
        got, gp, gx = _port_grads(lambda q, y: S.slstm_forward(q, y, N), p,
                                  x)
        want, wp, wx = _ref_grads(lambda q, y: RS.slstm_forward(q, y, N),
                                  slstm_params, x)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_grads(gp, wp)
    np.testing.assert_allclose(gx, wx, rtol=1e-5,
                               atol=1e-5 * np.abs(wx).max())


def test_slstm_routes_agree_and_the_unroll_changes_no_bits(slstm_params):
    """The custom backward and plain autograd give the same loss bits and
    gradients within rounding; ``set_slstm_unroll`` (an XLA lever in the
    reference) leaves every bit of either route unchanged."""
    x = _x(6, scale=1.0)
    runs = {}
    try:
        for custom_vjp in (True, False):
            for unroll in (1, 4):
                S.set_slstm_unroll(unroll)
                with _route(custom_vjp):
                    p = _torch_tree(slstm_params)
                    runs[custom_vjp, unroll] = _port_grads(
                        lambda q, y: S.slstm_forward(q, y, N), p, x)
    finally:
        S.set_slstm_unroll(1)
    for route in (True, False):
        a, b = runs[route, 1], runs[route, 4]
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
        assert all(np.array_equal(u, v) for u, v in zip(
            jax.tree.leaves(a[1]), jax.tree.leaves(b[1])))
    assert np.array_equal(runs[True, 1][0], runs[False, 1][0])
    _assert_grads(runs[True, 1][1], runs[False, 1][1])


def test_slstm_decode_step_by_step(slstm_params):
    x = _x(7, scale=1.0)
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), slstm_params)
    st_r = RS.slstm_zero_state(B, D)
    st = S.slstm_zero_state(B, D)
    step = jax.jit(RS.slstm_decode, static_argnums=3)
    outs = []
    for t in range(SEQ):
        y_r, st_r = step(slstm_params, jnp.asarray(x[:, t:t + 1]), st_r, N)
        with torch.no_grad():
            y, st = S.slstm_decode(p, torch.tensor(x[:, t:t + 1]), st, N)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
        outs.append(y[:, 0])
    for a, b in zip(st, st_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    with torch.no_grad():
        whole = S.slstm_forward(p, torch.tensor(x), N)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), whole.numpy(),
                               **TOL)


@pytest.mark.parametrize("custom_vjp", [True, False])
def test_slstm_long_sequence_stays_finite(custom_vjp):
    """The reference's stability check at its sizes: 200 steps of inputs
    at scale 2, output and gradients finite under the stabilizer."""
    d = 16
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                            requires_grad=True),
                     RS.init_slstm(jax.random.PRNGKey(4), d, 2))
    x = torch.tensor(np.random.default_rng(8).standard_normal(
        (1, 200, d)).astype(np.float32) * 2.0)
    with _route(custom_vjp):
        out = S.slstm_forward(p, x, 2)
        g = torch.autograd.grad(torch.sum(out ** 2), jax.tree.leaves(p))
    assert bool(torch.isfinite(out).all())
    assert all(bool(torch.isfinite(t).all()) for t in g)
