"""The port's mixture-of-experts layer (``models.moe``) against the JAX
package's (``repro.models.moe``).

Parameters come from the reference's ``init_moe``, inputs from numpy with a
seed. Outputs, the load-balance loss and the gradients (of a numpy-drawn
projection of the output plus the aux loss, for x and every leaf) hold
within rtol 1e-5, atol 1e-6 (gradients: atol 1e-5 times the case's
largest gradient): float32 einsums in two libraries. The
routing is compared exactly: which (token, expert) slots the capacity
keeps, including a case where the capacity drops slots and the zero
router, where every probability ties and the lower expert index must win
(``lax.top_k``'s order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (two torch threads a test process)
from repro.models import moe as RM
from repro_torch.models import moe as M

TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's layer compiled, as its jitted callers run it
REF_MOE = jax.jit(RM.moe_forward, static_argnames=("top_k",
                                                   "capacity_factor"))
# a gradient element is a sum over every token of terms that cancel (the
# router's most: at top_k = 1 its gradient through the renormalised gate
# cancels exactly in exact arithmetic), so it carries the float32
# rounding of the objective's largest terms: its atol is 1e-5 times the
# case's largest gradient (measured: up to 1.2e-6 against 1e-6 of it)
GRAD_ATOL = 1e-5


def _params(d, f, e, seed=0):
    p = RM.init_moe(jax.random.PRNGKey(seed), d, f, e)
    return {k: np.asarray(v) for k, v in p.items()}



CASES = [
    # (b, s, d, f, e, top_k, capacity factor)
    (2, 16, 32, 48, 4, 2, 1.25),
    (1, 12, 16, 24, 8, 3, 1.25),
    (2, 16, 32, 48, 4, 2, 0.5),      # capacity 4 of 16 tokens: drops
    (3, 8, 16, 32, 4, 1, 4.0),       # capacity = S: nothing dropped
]


@pytest.mark.parametrize("b,s,d,f,e,k,cf", CASES)
def test_moe_forward_aux_and_grads(b, s, d, f, e, k, cf):
    p = _params(d, f, e)
    rng = np.random.default_rng(b * 100 + s)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    proj = rng.standard_normal((b, s, d)).astype(np.float32)

    def ref_obj(pp, xx):
        y, aux = RM.moe_forward(pp, xx, top_k=k, capacity_factor=cf)
        return jnp.sum(y * proj) + aux, (y, aux)
    (_, (yr, ar)), (gpr, gxr) = jax.jit(jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    pt = {n: torch.tensor(v, requires_grad=True) for n, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    yt, at = M.moe_forward(pt, xt, top_k=k, capacity_factor=cf)
    obj = torch.sum(yt * torch.as_tensor(proj)) + at
    grads = torch.autograd.grad(obj, [xt] + list(pt.values()))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(float(at), float(ar), rtol=1e-6)
    wants = [np.asarray(w) for w in [gxr] + [gpr[n] for n in pt]]
    atol = GRAD_ATOL * max(np.abs(w).max() for w in wants)
    for name, g, want in zip(["x"] + list(pt), grads, wants):
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL["rtol"],
                                   atol=atol, err_msg=name)



def _routing(p, x, k, cf, torch_side):
    """Each (token, slot) kept or dropped and its expert: read through
    an expert stack whose output marks the expert (wd maps the hidden
    units to one coordinate per expert) with silu(g)·u = 1."""
    e = p["router"].shape[-1]
    d = x.shape[-1]
    f = p["wg"].shape[-1]
    # g large so silu(g) = g; u = 1 / g so silu(g)·u = 1 on unit 0
    big = 30.0
    wg = np.zeros((e, d, f), np.float32)
    wu = np.zeros((e, d, f), np.float32)
    wd = np.zeros((e, f, d), np.float32)
    xx = np.concatenate([x[..., :-1], np.ones_like(x[..., :1])], -1)
    for j in range(e):
        wg[j, -1, 0] = big
        wu[j, -1, 0] = 1.0 / big
        wd[j, 0, j] = 1.0
    q = dict(p, wg=wg, wu=wu, wd=wd)
    if torch_side:
        y, _ = M.moe_forward({n: torch.tensor(v) for n, v in q.items()},
                             torch.tensor(xx), top_k=k, capacity_factor=cf)
        y = y.numpy()
    else:
        y, _ = REF_MOE(jax.tree.map(jnp.asarray, q), jnp.asarray(xx),
                       top_k=k, capacity_factor=cf)
        y = np.asarray(y)
    return y[..., :e]          # each token's summed gate per expert


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_routing_and_drops_equal_the_reference(cf):
    e, k, d = 4, 2, 8
    p = _params(d, 16, e, seed=3)
    x = np.random.default_rng(7).standard_normal((2, 16, d)).astype(
        np.float32)
    got = _routing(p, x, k, cf, True)
    want = _routing(p, x, k, cf, False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    nz = (got > 1e-6).sum(-1)
    if cf < 1:
        assert (nz < k).any()          # the capacity dropped slots
    else:
        assert (nz == k).all()


def test_zero_router_ties_to_the_lower_expert():
    """A zero router makes every probability equal: the top k are the
    experts 0..k-1 for every token, as ``lax.top_k`` orders ties, and
    the capacity then drops the same tokens in both packages."""
    e, k, d = 8, 3, 8
    p = _params(d, 16, e, seed=4)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(8).standard_normal((2, 12, d)).astype(
        np.float32)
    for cf in (1.25, 8.0):
        got = _routing(p, x, k, cf, True)
        want = _routing(p, x, k, cf, False)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert (got[..., k:] == 0).all()
    assert (got[..., :k] > 0).all()    # cf = E: no token dropped
    y, aux = M.moe_forward({n: torch.tensor(v) for n, v in p.items()},
                           torch.tensor(x), top_k=k)
    yr, ar = REF_MOE(jax.tree.map(jnp.asarray, p), jnp.asarray(x), top_k=k)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    assert float(aux) == pytest.approx(float(ar), rel=1e-6)
