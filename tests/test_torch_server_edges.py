"""The port's full-size server against ``repro.fed.server`` on seeded
reports: the two-tier edges (E = 1 is the flat robust reduce exactly,
more edges than clients are capped, subset rounds price fresh uploads
only), ingest and aggregation round by round in every reducer with
staleness, the entropy filter and non-finite rows, trust and quarantine,
and the constructor's refusals."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data.proxy import ProxyData as RefProxyData
from repro.fed.server import Server as RefServer
from repro_torch.common.types import FedConfig
from repro_torch.core import aggregation
from repro_torch.data.proxy import ProxyData
from repro_torch.fed import simulator
from repro_torch.fed.server import Server

TEACHER_RTOL = 1e-5


def _proxy(t):
    arrays = (np.zeros((t, 3), np.float32), np.zeros((t,), np.int64),
              np.zeros((t,), np.int32))
    return ProxyData(*arrays), RefProxyData(*arrays)


def _servers(t=32, **kw):
    p, r = _proxy(t)
    return Server(p, seed=0, device="cpu", **kw), RefServer(r, seed=0, **kw)


def test_robust_two_tier_e1_equals_flat():
    """num_edges=1 never takes the partial path: the server's robust
    aggregate is the flat robust reduce exactly, as in the reference."""
    rng = np.random.default_rng(0)
    lo = rng.normal(size=(6, 32, 5)).astype(np.float32)
    mk = rng.random((6, 32)) < 0.8
    port, ref = _servers(num_edges=1, robust_aggregation="median")
    teacher, valid = port.aggregate(lo, mk)
    t_flat, v_flat = aggregation.robust_reduce(
        torch.as_tensor(lo), torch.as_tensor(mk), "median")
    np.testing.assert_array_equal(teacher.numpy(), t_flat.numpy())
    np.testing.assert_array_equal(valid.numpy(), v_flat.numpy())
    t_ref, v_ref = ref.aggregate(lo, mk)
    np.testing.assert_array_equal(teacher.numpy(), t_ref)
    np.testing.assert_array_equal(valid.numpy(), v_ref)


def test_more_edges_than_clients_is_capped():
    port, ref = _servers(num_edges=64)
    assert port._shards(5) == ref._shards(5)
    assert len(port._shards(5)) == 5
    cfg = FedConfig(num_clients=5, rounds=2, method="edgefd",
                    scenario="strong", proxy_batch=96, batch_size=32,
                    num_edge_aggregators=64)
    res = simulator.run(cfg, n_train=500, n_test=200, device="cpu")
    assert len(res.rounds) == 2 and res.rounds[-1].mean_acc >= 0.0


@pytest.mark.parametrize("edges", [1, 2])
def test_two_tier_subset_prices_fresh_uploads_only(edges):
    """Uploads are priced from this round's reporters' pre-filter masks:
    stale reuse costs nothing, flat and two-tier alike."""
    rng = np.random.default_rng(0)
    c, t, k = 4, 6, 4
    part = np.array([True, False, True, False])
    idx = np.arange(t)
    logits = rng.normal(size=(c, t, k)).astype(np.float32)
    masks = rng.random((c, t)) < 0.7
    logits[~part] = 0.0
    masks[~part] = False
    expected = int(masks[part].sum()) * k * 4
    port, ref = _servers(t=t, num_edges=edges)
    for srv in (port, ref):
        srv.ingest_reports(0, part, idx, logits, masks, decay=0.5)
        srv.aggregate_round(0)
        assert srv.bytes_received == expected, type(srv)


def _round_reports(r, c, t, k, *, nan_client=None):
    rng = np.random.default_rng(100 + r)
    lo = rng.normal(scale=2.0, size=(c, t, k)).astype(np.float32)
    lo[c - 1] *= 20.0                       # one far-off client
    mk = rng.random((c, t)) < 0.75
    if nan_client is not None:
        lo[nan_client, 1, 0] = np.nan
        mk[nan_client, 1] = True
    return lo, mk


@pytest.mark.parametrize("mode", aggregation.ROBUST_AGGREGATIONS)
@pytest.mark.parametrize("edges", [1, 3])
@pytest.mark.parametrize("subset", [False, True])
def test_rounds_match_reference(mode, edges, subset):
    """Four rounds of ingest and aggregate, with outlier tracking and the
    quarantine rule, a non-finite row in round 1, sharpening, the entropy
    filter in round 2 and (subset) a changing participant set with
    staleness decay: teacher, valid, staleness, bytes, scrub counts, trust,
    strikes and quarantine against the reference's server."""
    c, t_all, t, k = 7, 40, 12, 6
    kw = dict(num_edges=edges, robust_aggregation=mode, trim_frac=0.3,
              quarantine_threshold=1.5, track_outliers=True)
    port, ref = _servers(t=t_all, **kw)
    rng = np.random.default_rng(5)
    for r in range(4):
        idx = np.sort(rng.choice(t_all, size=t, replace=False))
        lo, mk = _round_reports(r, c, t, k, nan_client=2 if r == 1 else None)
        part = None
        if subset:
            part = np.ones((c,), bool)
            part[(np.arange(c) + r) % 3 == 0] = False
            lo[~part], mk[~part] = 0.0, False
        ent = r == 2
        sharpen = 0.5 if r == 3 else None
        port.ingest_reports(r, part, idx, torch.as_tensor(lo),
                            torch.as_tensor(mk), decay=0.5,
                            entropy_filter=ent)
        ref.ingest_reports(r, part, idx, lo, mk, decay=0.5,
                           entropy_filter=ent)
        got = port.aggregate_round(r, sharpen=sharpen, entropy_filter=ent)
        want = ref.aggregate_round(r, sharpen=sharpen, entropy_filter=ent)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=TEACHER_RTOL, atol=1e-5)
        assert got[2] == want[2]
        assert port.bytes_received == ref.bytes_received
        assert port.bytes_broadcast == ref.bytes_broadcast
        assert port.pop_scrubbed(r) == ref.pop_scrubbed(r)
        assert port.pop_quarantined(r) == ref.pop_quarantined(r)
        a, b = port.pop_round_outlier(r), ref.pop_round_outlier(r)
        np.testing.assert_allclose(a, b, rtol=1e-5)
        for name in ("strikes", "quarantined_until", "scrub_clients"):
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name), err_msg=name)
        np.testing.assert_allclose(port.trust, ref.trust, rtol=1e-5)
        qa, qb = port.quarantine_mask(r + 1), ref.quarantine_mask(r + 1)
        assert (qa is None) == (qb is None)
        if qb is not None:
            np.testing.assert_array_equal(qa, qb)
    assert port.strikes.sum() > 0       # the far-off client was caught


@pytest.mark.parametrize("mode", ["mean", "trimmed_mean"])
@pytest.mark.parametrize("edges", [1, 3])
def test_classwise_matches_reference(mode, edges):
    """FKD/PLS fusion: a NaN class row scrubbed, the robust reduce over
    class slots, the edge-regrouped mean."""
    rng = np.random.default_rng(9)
    payload = []
    for cid in range(5):
        means = rng.normal(size=(4, 4)).astype(np.float32)
        counts = rng.integers(0, 4, size=4).astype(np.float32)
        if cid == 1:
            means[2, 1], counts[2] = np.nan, 3.0
        payload.append((means, counts))
    part = np.array([True, True, False, True, True])
    for weighted in (False, True):
        port, ref = _servers(num_edges=edges, robust_aggregation=mode)
        got = port.aggregate_classwise(
            [(torch.as_tensor(m), torch.as_tensor(c)) for m, c in payload],
            count_weighted=weighted, uploaded_rows=part, round_idx=0)
        want = ref.aggregate_classwise(payload, count_weighted=weighted,
                                       uploaded_rows=part, round_idx=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=TEACHER_RTOL, atol=1e-6)
        assert (port.bytes_received, port.bytes_broadcast) == (
            ref.bytes_received, ref.bytes_broadcast)
        assert port.pop_scrubbed(0) == ref.pop_scrubbed(0) == 1
        np.testing.assert_array_equal(port.scrub_clients, ref.scrub_clients)


def test_quarantine_escalates_like_the_reference():
    port, ref = _servers(quarantine_threshold=2.0, quarantine_rounds=2)
    for srv in (port, ref):
        assert srv.quarantine_mask(0) is None
        srv.quarantine([3, 1], 2)
        srv.quarantine([3], 5, event_round=4)
    for name in ("strikes", "quarantined_until", "trust"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    for r in range(10):
        a, b = port.quarantine_mask(r), ref.quarantine_mask(r)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert port.pop_quarantined(2) == ref.pop_quarantined(2) == [1, 3]
    assert port.pop_quarantined(4) == ref.pop_quarantined(4) == [3]


@pytest.mark.parametrize("kw", [
    dict(num_edges=0), dict(robust_aggregation="geomedian"),
    dict(trim_frac=0.5), dict(quarantine_threshold=-1.0),
    dict(trust_ewma=0.0), dict(quarantine_rounds=0),
    dict(max_pending_reports=-1)])
def test_constructor_refusals_match_reference(kw):
    p, r = _proxy(4)
    with pytest.raises(ValueError) as got:
        Server(p, device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        RefServer(r, **kw)
    assert str(got.value) == str(want.value)
