"""The KMeans-DRE and KuLSIF plain versions on non-finite and wide inputs,
against the JAX package.

Each case makes its inputs with numpy from a seed and runs them through
the reference's Pallas kernel (interpret mode, as the JAX tests run it on
the CPU), and through the port's plain versions (``kmeans_dist/ref.py``,
``kulsif_rbf/ref.py``) and ``dispatch``'s torch route: the functions the
port's CUDA kernels are held to on the card.

* Non-finite inputs: a NaN row, a ±inf row and a -inf row, or a NaN
  centroid. NaN and ±inf land at the same places in every output (the
  clamp and the minimum keep a NaN; the Lloyd sums are a one-hot product,
  so an infinite or NaN feature gives NaN in every other centroid's sum),
  and the masks and assignments are equal; the finite values hold to the
  tolerances of ``tests/test_torch_kernels_ref.py``.
* Flattened image widths (784, 3072) at k = 1, 3 and 10: the same
  tolerances, assignments and counts equal.

Also here: the kernel build's library name hashes every header a source
includes, so an edited header is never served by a stale library.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.kernels.kmeans_dist import ops as ref_kd_ops
from repro.kernels.kulsif_rbf import ops as ref_rbf_ops
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.kmeans_dist import ref as kd_ref
from repro_torch.kernels.kulsif_rbf import ref as rbf_ref

LLOYD_TOL = dict(rtol=1e-5, atol=1e-5)
SCALED_RTOL = 1e-5      # relative to the terms the matmul form cancels
DIST2_ATOL = 1e-5
RBF_ATOL = 1e-6


def _inputs(t, d, k, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, d)) + 1.0).astype(np.float32)
    c = (rng.standard_normal((k, d)) * 2).astype(np.float32)
    return x, c


def _poison(x, case):
    """``case`` "rows": a NaN feature in row 1, a +inf and a -inf feature
    in row 2, a -inf feature in row 3; "centroid": a NaN feature in row 1
    (row 0 of a single row)."""
    x = x.copy()
    if case == "rows":
        x[1, 3] = np.nan
        x[2, 0], x[2, 5] = np.inf, -np.inf
        x[3, 2] = -np.inf
    else:
        x[min(1, len(x) - 1), 4] = np.nan
    return x


def _nonfinite_inputs(t, d, k, case, seed):
    x, c = _inputs(t, d, k, seed)
    return (_poison(x, "rows"), c) if case == "rows" else (x, _poison(c, case))


def _assert_same_nonfinite(got, want):
    got, want = np.asarray(got), np.asarray(want)
    for f in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(f(got), f(want))


def _plain_lloyd(x, c):
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    return (kd_ref.lloyd_step(xt, ct),
            dispatch.lloyd_step(xt, ct, backend="torch"))


def _plain_min_dist(x, c, thr):
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    return (kd_ref.min_dist_and_mask(xt, ct, thr),
            dispatch.min_dist_and_mask(xt, ct, thr, backend="torch"))


@pytest.mark.parametrize("case", ["rows", "centroid"])
@pytest.mark.parametrize("t,d,k", [(300, 50, 3), (131, 16, 1), (70, 7, 33)])
def test_lloyd_step_nonfinite_matches_pallas(t, d, k, case):
    x, c = _nonfinite_inputs(t, d, k, case, seed=t + d + k)
    want = [np.asarray(o) for o in ref_kd_ops.lloyd_step(x, c,
                                                          interpret=True)]
    for got in _plain_lloyd(x, c):
        a, m, s, cnt = (o.numpy() for o in got)
        np.testing.assert_array_equal(a, want[0])
        np.testing.assert_array_equal(cnt, want[3])
        for g, w in ((m, want[1]), (s, want[2])):
            _assert_same_nonfinite(g, w)
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], **LLOYD_TOL)
    assert np.isnan(want[1]).any()
    if case == "rows":      # the one-hot product's 0 * x poisons the sums
        assert np.isnan(want[2]).any() and np.isneginf(want[2]).any()


@pytest.mark.parametrize("case", ["rows", "centroid"])
@pytest.mark.parametrize("t,d,k", [(300, 50, 3), (131, 16, 1), (70, 7, 33)])
def test_min_dist_and_mask_nonfinite_matches_pallas(t, d, k, case):
    x, c = _nonfinite_inputs(t, d, k, case, seed=t + d + k)
    for thr in (2.0 * d ** 0.5, float("inf")):
        want_d, want_m = (np.asarray(o) for o in ref_kd_ops.min_dist_and_mask(
            x, c, thr, interpret=True))
        want_m = want_m.astype(bool)
        bad = ~np.isfinite(want_d)
        assert bad.any()
        scale = np.sum(x * x, -1) + np.max(np.sum(c * c, -1))
        tol2 = SCALED_RTOL * scale + DIST2_ATOL
        for got_d, got_m in _plain_min_dist(x, c, thr):
            got_d, got_m = got_d.numpy(), got_m.numpy()
            _assert_same_nonfinite(got_d, want_d)
            np.testing.assert_array_equal(got_m[bad], want_m[bad])
            assert not got_m[np.isnan(got_d)].any()
            err2 = np.abs(got_d[~bad] ** 2 - want_d[~bad] ** 2)
            assert (err2 <= tol2[~bad]).all()
            clear = ~bad & (np.abs(want_d ** 2 - thr ** 2) > tol2)
            np.testing.assert_array_equal(got_m[clear], want_m[clear])


@pytest.mark.parametrize("case", ["rows", "centroid"])
@pytest.mark.parametrize("n,m,d,sigma", [(256, 300, 50, 4.0),
                                         (37, 19, 8, 1.5)])
def test_rbf_matrix_nonfinite_matches_pallas(n, m, d, sigma, case):
    a, b = _inputs(n, d, m, seed=n + m + d)
    if case == "rows":
        a = _poison(a, "rows")
    else:
        b = _poison(b, "centroid")
        b[2, 0] = np.inf
    want = np.asarray(ref_rbf_ops.rbf_matrix(a, b, sigma, interpret=True))
    bad = (~np.isfinite(a).all(-1))[:, None] | (~np.isfinite(b).all(-1))[None]
    scale = np.sum(a * a, -1)[:, None] + np.sum(b * b, -1)[None, :]
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for got in (rbf_ref.rbf_matrix(at, bt, sigma),
                dispatch.rbf_matrix(at, bt, sigma, backend="torch")):
        got = got.numpy()
        _assert_same_nonfinite(got, want)
        # a non-finite row's values are 0 (an infinite d2) or NaN
        sel = bad & ~np.isnan(want)
        np.testing.assert_array_equal(got[sel], want[sel])
        w, sc = want[~bad], scale[~bad]
        tol = w * SCALED_RTOL * sc / (2 * sigma * sigma) + RBF_ATOL
        assert (np.abs(got[~bad] - w) <= tol).all()
    assert np.isnan(want).any() and (want[bad] == 0).any()


# flattened images: mnist_like / fashion_like 784, cifar_like 3072
@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("t,d", [(1000, 784), (600, 3072)])
def test_lloyd_step_wide_matches_pallas(t, d, k):
    x, c = _inputs(t, d, k, seed=t + d + k)
    want = [np.asarray(o) for o in ref_kd_ops.lloyd_step(x, c,
                                                          interpret=True)]
    for got in _plain_lloyd(x, c):
        a, m, s, cnt = (o.numpy() for o in got)
        np.testing.assert_array_equal(a, want[0])
        np.testing.assert_array_equal(cnt, want[3])
        np.testing.assert_allclose(m, want[1], **LLOYD_TOL)
        np.testing.assert_allclose(s, want[2], **LLOYD_TOL)


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("t,d", [(1000, 784), (600, 3072)])
def test_min_dist_and_mask_wide_matches_pallas(t, d, k):
    x, c = _inputs(t, d, k, seed=t + d + k)
    got_d = kd_ref.min_dist_and_mask(torch.from_numpy(x),
                                     torch.from_numpy(c), 0.0)[0].numpy()
    thr = float(np.median(got_d))               # half the rows are ID
    want_d, want_m = (np.asarray(o) for o in ref_kd_ops.min_dist_and_mask(
        x, c, thr, interpret=True))
    scale = (np.sum(x * x, -1)
             + np.min(np.sum(c * c, -1)) + np.max(np.sum(c * c, -1)))
    tol2 = SCALED_RTOL * scale + DIST2_ATOL
    for got_d, got_m in _plain_min_dist(x, c, thr):
        got_d, got_m = got_d.numpy(), got_m.numpy()
        assert (np.abs(got_d ** 2 - want_d ** 2) <= tol2).all()
        clear = np.abs(got_d ** 2 - thr ** 2) > tol2
        np.testing.assert_array_equal(got_m[clear],
                                      want_m.astype(bool)[clear])
        assert 0 < int(got_m.sum()) < t


def test_library_path_hashes_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """Editing a header that a source includes, directly or through
    another header, gives that source a new library name; sources that do
    not include it keep theirs (no nvcc: only the names are computed)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "_build"))
    before = {name: build.library_path(name) for name in build.SOURCES}
    assert [p.name for p in build.source_files("kmeans_dist")] == [
        "kmeans_dist.cu", "kmeans_rows.cuh"]
    header = csrc / "kmeans_rows.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    changed = {name for name in build.SOURCES if after[name] != before[name]}
    assert changed == {"kmeans_dist", "lloyd_step"}
    # a header reached only through another header counts too
    (csrc / "extra.cuh").write_text("// one\n")
    header.write_text('#include "extra.cuh"\n' + header.read_text())
    mid = build.library_path("kmeans_dist")
    (csrc / "extra.cuh").write_text("// two\n")
    assert build.library_path("kmeans_dist") != mid
    assert build.library_path("kd_kl") == before["kd_kl"]
