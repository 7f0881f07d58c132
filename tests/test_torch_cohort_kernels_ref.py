"""The plain versions of the kernels over a client axis (the cohort
engine's routes) against the JAX package's vmapped functions, and against
a loop of the port's own 2-D plain versions.

Each case makes its inputs with numpy from a seed. Against the reference
the tolerances are those of ``tests/test_torch_kernels_ref.py`` (Lloyd
centroids within rtol 1e-5, atol 1e-5 and assignments and iteration
counts equal; distances by the matmul form's cancelled terms; the KL loss
and its gradient within rtol 1e-5, atol 1e-6). Against the port's 2-D
plain version, client by client, the results are equal bit for bit: on
the CPU each client's slice of a batched product is its own product.
Also: ``padded_epoch_plan`` bit for bit, the cohort's stacking and gated
step, and SGD's update on stacked tensors, elementwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as ref_distill
from repro.core.kmeans import kmeans_fit_batched as ref_kmeans_fit_batched
from repro.core.kmeans import kmeans_plus_plus as ref_kmeans_plus_plus
from repro.core.kmeans import min_dist_to_centroids as ref_min_dist
from repro.fed.batching import padded_epoch_plan as ref_padded_epoch_plan
from repro.kernels import dispatch as ref_dispatch
from repro.optim.optimizers import sgd as ref_sgd
from repro_torch.common.pytree import unstack_tree
from repro_torch.common.types import FedConfig
from repro_torch.core.distill import ce_loss, ce_loss_clients
from repro_torch.core.dre import KMeansDRE, learn_kmeans_batched
from repro_torch.core.kmeans import kmeans_fit, kmeans_fit_batched
from repro_torch.fed import simulator
from repro_torch.fed.cohort import CohortEngine
from repro_torch.fed.batching import padded_epoch_plan
from repro_torch.kernels import dispatch
from repro_torch.kernels.distill_kl import ref as kl_ref
from repro_torch.kernels.kmeans_dist import ref as kd_ref
from repro_torch.kernels.kulsif_rbf import ref as rbf_ref
from repro_torch.optim.optimizers import sgd

DIST_RTOL, DIST_ATOL = 1e-5, 1e-5
RBF_RTOL, RBF_ATOL = 1e-5, 1e-6
KL_TOL = dict(rtol=1e-5, atol=1e-6)
TEMP = 3.0


def _clusters(c, n, d, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, k, d)) * 4
    x = centers[:, np.arange(n) % k] + rng.standard_normal((c, n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("c,n,d,k", [(4, 300, 50, 1), (3, 200, 50, 3),
                                     (5, 120, 16, 10)])
def test_kmeans_fit_batched_matches_reference_and_a_loop(c, n, d, k):
    xs = _clusters(c, n, d, k, seed=c + n + k)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), i)
                      for i in range(c)])
    inits = [np.array(ref_kmeans_plus_plus(keys[i], jnp.asarray(xs[i]), k))
             for i in range(c)]
    want = ref_kmeans_fit_batched(keys, jnp.asarray(xs), k, backend="jnp")
    got = kmeans_fit_batched(torch.from_numpy(xs), k, inits=inits,
                             backend="torch")
    assert got.n_iter == [int(v) for v in np.asarray(want.n_iter)]
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    for i in range(c):      # a loop of one-client fits: the same bits
        one = kmeans_fit(torch.from_numpy(xs[i]), k, init=inits[i],
                         backend="torch")
        assert one.n_iter == got.n_iter[i]
        assert torch.equal(one.centroids, got.centroids[i])
        assert torch.equal(one.assignments, got.assignments[i])


def test_learn_kmeans_batched_equals_each_clients_learn():
    xs = torch.from_numpy(_clusters(4, 250, 50, 3, seed=3))
    inits = [xs[i, :3] + 0.5 for i in range(4)]
    dre = KMeansDRE(num_centroids=3, kernel_backend="torch")
    cents, thrs = learn_kmeans_batched(dre, xs, inits=inits)
    for i in range(4):
        own = dre.learn(xs[i], init=inits[i])
        assert torch.equal(own.centroids, cents[i])
        assert torch.equal(own.threshold.reshape(()), thrs[i])
    fixed = KMeansDRE(num_centroids=3, threshold=2.5, kernel_backend="torch")
    assert torch.equal(learn_kmeans_batched(fixed, xs, inits=inits)[1],
                       torch.full((4,), 2.5))


def _dist_inputs(c, t, d, k, shared, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, d) if shared else (c, t, d)) + 1.0
         ).astype(np.float32)
    cents = (rng.standard_normal((c, k, d)) * 2).astype(np.float32)
    return x, cents


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("c,t,d,k", [(4, 256, 50, 1), (3, 300, 50, 3),
                                     (2, 131, 16, 10)])
def test_min_dist_over_clients_matches_vmapped_reference(c, t, d, k, shared):
    x, cents = _dist_inputs(c, t, d, k, shared, seed=c + t + k)
    in_x = None if shared else 0
    want = np.asarray(jax.vmap(ref_min_dist, in_axes=(in_x, 0))(
        jnp.asarray(x), jnp.asarray(cents)))
    got_d, _ = kd_ref.min_dist_and_mask(torch.from_numpy(x),
                                        torch.from_numpy(cents),
                                        float("inf"))
    x2 = np.sum(x * x, -1)
    scale = x2 + np.max(np.sum(cents * cents, -1), -1)[:, None]
    err2 = np.abs(got_d.numpy() ** 2 - want ** 2)
    assert (err2 <= DIST_RTOL * scale + DIST_ATOL).all(), float(err2.max())
    thr = torch.from_numpy(np.median(want, axis=1).astype(np.float32))
    got_d, got_m = dispatch.min_dist_and_mask(
        torch.from_numpy(x), torch.from_numpy(cents), thr, backend="torch")
    for i in range(c):      # each client: the 2-D plain version's bits
        xi = torch.from_numpy(x if shared else x[i])
        d_i, m_i = kd_ref.min_dist_and_mask(xi, torch.from_numpy(cents[i]),
                                            thr[i])
        assert torch.equal(got_d[i], d_i) and torch.equal(got_m[i], m_i)


@pytest.mark.parametrize("n,c,m,d", [(128, 4, 96, 50), (37, 3, 19, 8)])
def test_rbf_over_clients_matches_vmapped_reference(n, c, m, d):
    rng = np.random.default_rng(n + m)
    a = (rng.standard_normal((n, d)) + 0.5).astype(np.float32)
    b = (rng.standard_normal((c, m, d)) + 0.5).astype(np.float32)
    b[:, -3:] = 1e6                  # a padded private set's sentinel rows
    sigma = 4.0
    want = np.asarray(jax.vmap(
        lambda bb: ref_dispatch.rbf_matrix(jnp.asarray(a), bb, sigma,
                                           backend="jnp"))(jnp.asarray(b)))
    got = rbf_ref.rbf_matrix(torch.from_numpy(a), torch.from_numpy(b), sigma)
    assert got.shape == (c, n, m)
    assert (got[:, :, -3:] == 0).all()
    scale = np.sum(a * a, -1)[None, :, None] + np.sum(b * b, -1)[:, None, :]
    tol = want * RBF_RTOL * scale / (2 * sigma * sigma) + RBF_ATOL
    assert (np.abs(got.numpy() - want) <= tol).all()
    for i in range(c):
        assert torch.equal(got[i], rbf_ref.rbf_matrix(
            torch.from_numpy(a), torch.from_numpy(b[i]), sigma))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("c,n,k", [(4, 64, 10), (3, 37, 32)])
def test_kd_kl_loss_over_clients_matches_vmapped_reference(c, n, k, backend):
    rng = np.random.default_rng(c + n + k)
    s = (rng.standard_normal((c, n, k)) * TEMP).astype(np.float32)
    t = (rng.standard_normal((c, n, k)) * TEMP).astype(np.float32)
    w = (rng.random((c, n)) * (rng.random((c, n)) > 0.3)).astype(np.float32)
    w[1] = 0.0                       # a lane with no valid row

    def ref_loss(ss):
        return jax.vmap(lambda a, b, ww: ref_distill.kd_kl_loss(
            a, b, TEMP, ww, backend=backend))(ss, jnp.asarray(t),
                                              jnp.asarray(w))
    want, vjp = jax.vjp(ref_loss, jnp.asarray(s))
    cot = rng.standard_normal(c).astype(np.float32)
    want_ds = np.asarray(vjp(jnp.asarray(cot))[0])
    st = torch.tensor(s, requires_grad=True)
    got = dispatch.kd_kl_loss(st, torch.from_numpy(t), TEMP,
                              torch.from_numpy(w), backend="torch")
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **KL_TOL)
    np.testing.assert_allclose(st.grad.numpy(), want_ds, **KL_TOL)
    assert float(got[1].detach()) == 0.0 and (st.grad[1] == 0).all()
    for i in range(c):
        one = kl_ref.kd_kl_loss(torch.from_numpy(s[i]), torch.from_numpy(t[i]),
                                TEMP, torch.from_numpy(w[i]))
        assert torch.equal(got[i].detach(), one)


def test_ce_loss_over_clients_is_each_clients_mean():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((3, 64, 10)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (3, 64)))
    w = torch.ones((3, 64))
    w[2, 40:] = 0.0                  # a short batch padded to 64
    got = ce_loss_clients(logits, y, w)
    for i, rows in ((0, 64), (1, 64), (2, 40)):
        torch.testing.assert_close(got[i], ce_loss(logits[i, :rows],
                                                   y[i, :rows]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,bs,epochs,steps", [(300, 64, 1, 4), (50, 64, 2, 3),
                                               (128, 64, 2, 5), (0, 64, 1, 2)])
def test_padded_epoch_plan_bit_for_bit(n, bs, epochs, steps):
    rng = np.random.default_rng(n + epochs)
    perms = [rng.permutation(n) for _ in range(epochs)]
    for got, want in zip(padded_epoch_plan(perms, bs, steps),
                         ref_padded_epoch_plan(perms, bs, steps)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def stack_trees(trees):
    """C lists of tensors -> one list of (C, ...) tensors."""
    return [torch.stack(leaves) for leaves in zip(*trees)]


def test_stack_helpers_round_trip_and_gate_per_client():
    """The cohort stacks its members' state leaf by leaf (the reference's
    ``_stack_trees``), ``unstack_tree`` reads a member's row back, and a
    gated step (its ``_where_tree``, leaf by leaf and in place) moves only
    the flagged lanes, releasing each gradient as it goes."""
    clients, *_ = simulator.build_experiment(
        FedConfig(num_clients=3, rounds=1, engine="cohort"), n_train=300,
        n_test=50, device="cpu")
    before = [[p.detach().clone() for p in c.params] for c in clients]
    cohort = CohortEngine(clients).cohorts[0]
    for i in range(3):
        assert all(torch.equal(a, b) for a, b in
                   zip(unstack_tree(cohort.params, i), before[i]))
    stacked = [p.detach().clone() for p in cohort.params]
    grads = [torch.ones_like(p) for p in stacked]
    flag = torch.tensor([True, False, True])
    cohort._apply(cohort.params, cohort.opt_state, grads, flag)
    assert grads == [None] * len(stacked)
    for i in range(3):
        moved = [not torch.equal(p[i], s[i])
                 for p, s in zip(cohort.params, stacked)]
        assert all(moved) if flag[i] else not any(moved)
    assert cohort.opt_state["step"].tolist() == [1, 0, 1]


def test_sgd_update_on_stacked_clients_is_each_clients_update():
    """The port's SGD is elementwise: on (C, ...) tensors it is C clients'
    updates side by side (the cohort's step counts a tensor), and each
    matches the reference's."""
    rng = np.random.default_rng(9)
    params = [[torch.from_numpy(rng.standard_normal((5, 3)).astype(
        np.float32))] for _ in range(4)]
    grads = [[torch.from_numpy(rng.standard_normal((5, 3)).astype(
        np.float32))] for _ in range(4)]
    opt = sgd(0.01)
    states = [opt.init(p) for p in params]
    for _ in range(2):      # a second step uses the momentum
        states = [opt.update(g, st, p)[1] for g, st, p
                  in zip(grads, states, params)]
    stacked = {"mu": stack_trees([st["mu"] for st in states]),
               "step": torch.tensor([st["step"] for st in states])}
    upd, new = opt.update(stack_trees(grads), stacked, stack_trees(params))
    ref_opt = ref_sgd(0.01)
    for i in range(4):
        upd_i, st_i = opt.update(grads[i], states[i], params[i])
        assert torch.equal(upd[0][i], upd_i[0])
        assert torch.equal(new["mu"][0][i], st_i["mu"][0])
        assert int(new["step"][i]) == st_i["step"] == 3
        ref_state = {"mu": [jnp.asarray(states[i]["mu"][0].numpy())],
                     "step": jnp.asarray(2, jnp.int32)}
        ref_upd, _ = ref_opt.update([jnp.asarray(grads[i][0].numpy())],
                                    ref_state)
        np.testing.assert_allclose(upd[0][i].numpy(), np.asarray(ref_upd[0]),
                                   rtol=1e-6, atol=1e-8)
