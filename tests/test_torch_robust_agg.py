"""The port's robust reducers, two-tier partial sums and outlier distance
against ``repro.core.aggregation`` on the same seeded numpy inputs.

Order statistics (median, Krum's pick) must agree exactly; sums over the
client axis (trimmed mean, partial sums, the fused mean) may differ in
summation order, so they agree within rtol 1e-6. The outlier distance
follows the reference's dtype path (float32 sums, a float64 division) and
agrees within rtol 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import aggregation as ref
from repro_torch.core import aggregation as agg

RTOL = 1e-6


def _inputs(c, t, k, seed, *, p_mask=0.7, nan_rows=0, empty=0):
    """Logits (C, t, K), masks (C, t) with ``nan_rows`` claimed rows set to
    NaN and the first ``empty`` positions masked out for every client."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(scale=3.0, size=(c, t, k)).astype(np.float32)
    mk = rng.random((c, t)) < p_mask
    mk[:, :empty] = False
    for i in range(nan_rows):
        ci, ti = i % c, empty + (3 * i) % (t - empty)
        lo[ci, ti, i % k] = np.nan
        mk[ci, ti] = True
    return lo, mk


def _port(fn, lo, mk, **kw):
    teacher, valid = fn(torch.as_tensor(lo), torch.as_tensor(mk), **kw)
    return teacher.numpy(), valid.numpy()


CASES = [  # (C, t, K, seed, nan rows, empty positions)
    (5, 12, 4, 0, 0, 0),      # odd count
    (6, 12, 4, 1, 0, 2),      # even count, empty positions
    (7, 16, 10, 2, 3, 1),     # NaN rows
    (4, 9, 3, 3, 2, 3),       # NaN rows and empty positions
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sharpen", [None, 0.5])
def test_median_matches_reference(case, sharpen):
    c, t, k, seed, nans, empty = case
    lo, mk = _inputs(c, t, k, seed, nan_rows=nans, empty=empty)
    want_t, want_v = ref.median_logits(lo, mk, temperature_sharpen=sharpen)
    got_t, got_v = _port(agg.median_logits, lo, mk,
                         temperature_sharpen=sharpen)
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    if sharpen is None:
        np.testing.assert_array_equal(got_t, np.asarray(want_t))
    else:
        np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("trim_frac", [0.0, 0.2, 0.45])
def test_trimmed_mean_matches_reference(case, trim_frac):
    c, t, k, seed, nans, empty = case
    lo, mk = _inputs(c, t, k, seed, nan_rows=nans, empty=empty)
    want_t, want_v = ref.trimmed_mean_logits(lo, mk, trim_frac=trim_frac)
    got_t, got_v = _port(agg.trimmed_mean_logits, lo, mk,
                         trim_frac=trim_frac)
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("trim_frac,c", [(0.45, 20), (0.3, 10), (0.2, 5),
                                         (0.29, 100), (0.42, 150)])
def test_trimmed_mean_trim_count_is_float32(trim_frac, c):
    """Every client valid, so n = C at each position: at 0.45·20, 0.3·10
    and 0.2·5 the product is an integer, and at 0.29·100 and 0.42·150 a
    float64 product floors one count away from the float32 one the
    reference takes (the last two cases fail with a float64 count)."""
    rng = np.random.default_rng(c)
    # distinct magnitudes a client, so a trim count off by one moves the
    # mean by far more than the summation order does
    lo = (rng.permuted(np.tile(np.arange(c, dtype=np.float32)[:, None, None]
                               * 10.0, (1, 3, 2)), axis=0)
          + rng.normal(size=(c, 3, 2)).astype(np.float32))
    mk = np.ones((c, 3), bool)
    want_t, _ = ref.trimmed_mean_logits(lo, mk, trim_frac=trim_frac)
    got_t, _ = _port(agg.trimmed_mean_logits, lo, mk, trim_frac=trim_frac)
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=RTOL)
    k32 = int(np.floor(np.float32(trim_frac) * np.float32(c)))
    xs = np.sort(lo, axis=0)
    np.testing.assert_allclose(got_t, xs[k32:c - k32].mean(axis=0),
                               rtol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_krum_row_matches_reference(case):
    c, t, k, seed, nans, empty = case
    lo, mk = _inputs(c, t, k, seed, nan_rows=nans, empty=empty)
    want_t, want_v = ref.krum_row_logits(lo, mk)
    got_t, got_v = _port(agg.krum_row_logits, lo, mk)
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    np.testing.assert_array_equal(got_t, np.asarray(want_t))


def test_krum_row_duplicated_rows_pick_the_lowest_id():
    """Clients 1 and 3 send the same rows, clients 2 and 4 the same rows a
    step away, client 0 far ones: clients 1–4 score exactly alike at every
    position (0 + 2 steps), and the lowest id, 1, wins."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(6, 4)).astype(np.float32)
    lo = np.stack([base + 40.0, base, base + 0.25, base, base + 0.25])
    mk = np.ones((5, 6), bool)
    want_t, _ = ref.krum_row_logits(lo, mk)
    got_t, _ = _port(agg.krum_row_logits, lo, mk)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_t, lo[1])


@pytest.mark.parametrize("mode", agg.ROBUST_AGGREGATIONS)
def test_robust_reduce_dispatch(mode):
    assert agg.ROBUST_AGGREGATIONS == ref.ROBUST_AGGREGATIONS
    lo, mk = _inputs(6, 10, 5, 11, nan_rows=2, empty=1)
    want_t, want_v = ref.robust_reduce(lo, mk, mode, trim_frac=0.3,
                                       temperature_sharpen=2.0)
    got_t, got_v = agg.robust_reduce(torch.as_tensor(lo), torch.as_tensor(mk),
                                     mode, trim_frac=0.3,
                                     temperature_sharpen=2.0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=RTOL,
                               atol=1e-6)


def test_robust_reduce_refuses_unknown_mode_and_trim():
    lo, mk = (torch.zeros((2, 3, 4)), torch.ones((2, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="robust_aggregation"):
        agg.robust_reduce(lo, mk, "geomedian")
    with pytest.raises(ValueError, match="trim_frac"):
        agg.trimmed_mean_logits(lo, mk, trim_frac=0.5)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("guard", [True, False])
def test_partial_sums_fuse_to_the_flat_mean(weighted, guard):
    """Each shard's partial against the reference's, and their fusion
    against the reference's fusion and the port's flat (weighted) mean
    (NaN rows only where the guard drops them)."""
    lo, mk = _inputs(7, 12, 5, 5, nan_rows=2 if guard else 0, empty=1)
    w = None
    if weighted:  # client 2 at weight 0 drops out
        w = np.random.default_rng(5).random(7).astype(np.float32)
        w[2] = 0.0
    shards = [slice(0, 3), slice(3, 5), slice(5, 7)]
    nums, dens = [], []
    for sl in shards:
        n_r, d_r = ref.partial_masked_sums(
            lo[sl], mk[sl], None if w is None else w[sl], guard_finite=guard)
        n_p, d_p = agg.partial_masked_sums(
            torch.as_tensor(lo[sl]), torch.as_tensor(mk[sl]),
            None if w is None else torch.as_tensor(w[sl]), guard_finite=guard)
        np.testing.assert_allclose(n_p.numpy(), np.asarray(n_r), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))
        nums.append(n_p)
        dens.append(d_p)
    want_t, want_v = ref.fuse_partial_sums(
        np.stack([n.numpy() for n in nums]),
        np.stack([d.numpy() for d in dens]), temperature_sharpen=0.7)
    got_t, got_v = agg.fuse_partial_sums(torch.stack(nums),
                                         torch.stack(dens),
                                         temperature_sharpen=0.7)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=RTOL,
                               atol=1e-6)
    flat_t, flat_v = agg.fuse_partial_sums(torch.stack(nums),
                                           torch.stack(dens))
    lo_t, mk_t = torch.as_tensor(lo), torch.as_tensor(mk)
    if w is None:
        mean_t, mean_v = agg.masked_mean_logits(lo_t, mk_t,
                                                guard_finite=guard)
    else:
        mean_t, mean_v = agg.weighted_masked_mean_logits(
            lo_t, mk_t, torch.as_tensor(w), guard_finite=guard)
    np.testing.assert_array_equal(flat_v.numpy(), mean_v.numpy())
    np.testing.assert_allclose(flat_t.numpy(), mean_t.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", [(6, 10, 4, 0, 0, 0), (5, 12, 10, 1, 2, 2)])
def test_client_outlier_distance_matches_reference(case):
    """Including NaN senders (inf), a NaN teacher row (skipped) and a
    client that claims nothing (not contributing, 0)."""
    c, t, k, seed, nans, empty = case
    lo, mk = _inputs(c, t, k, seed, nan_rows=nans, empty=empty)
    mk[c - 1] = False
    rng = np.random.default_rng(seed + 100)
    teacher = rng.normal(size=(t, k)).astype(np.float32)
    teacher[t - 1, 0] = np.nan
    want_d, want_c = ref.client_outlier_distance(lo, mk, teacher)
    got_d, got_c = agg.client_outlier_distance(
        torch.as_tensor(lo), torch.as_tensor(mk), torch.as_tensor(teacher))
    assert got_d.dtype == np.float64 and got_c.dtype == bool
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL)
    assert got_d[c - 1] == 0.0
    if nans:
        assert np.isinf(got_d).any()
