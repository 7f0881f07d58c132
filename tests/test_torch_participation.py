"""Partial participation in the port (``repro_torch.fed.participation``,
the staleness path of ``fed.server`` and ``core.aggregation``) against
the reference: the participant draw of every policy, ``cohort_size``'s
banker's rounding, ``StalenessBuffer`` merges over round sequences (decay
0, 0.5 and 1, a client that never reported, an out-of-order merge) exact;
``weighted_masked_mean_logits`` within rtol 1e-6; a subset round of the
server (scrub, merge, weighted aggregate, ledger, admission) against the
reference server."""
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.data.proxy import ProxyData as RefProxyData
from repro.fed import participation as ref
from repro.fed.server import Server as RefServer
from repro_torch.core import aggregation
from repro_torch.data.proxy import ProxyData
from repro_torch.fed import participation
from repro_torch.fed.server import Server


@pytest.mark.parametrize("policy", ["uniform", "weighted", "roundrobin"])
@pytest.mark.parametrize("c,frac,seed", [(8, 0.5, 0), (7, 0.3, 3),
                                         (20, 0.25, 12345), (5, 1.0, 1)])
def test_sample_participants_matches(policy, c, frac, seed):
    sizes = np.arange(1, c + 1) * 10
    for r in range(6):
        got = participation.sample_participants(r, c, frac, policy,
                                                seed=seed, data_sizes=sizes)
        want = ref.sample_participants(r, c, frac, policy, seed=seed,
                                       data_sizes=sizes)
        np.testing.assert_array_equal(got, want)


def test_cohort_size_bankers_rounding_and_refusals():
    for c, f, k in ((5, 0.5, 2), (7, 0.5, 4), (10, 0.25, 2), (6, 0.5, 3),
                    (3, 0.01, 1), (3, 1.0, 3), (9, 0.5, 4), (11, 0.5, 6)):
        assert participation.cohort_size(c, f) == ref.cohort_size(c, f) == k
    for args, kw in (((0, 4, 0.5, "bogus"), {}), ((0, 4, 0.0), {}),
                     ((0, 4, 0.5, "weighted"), {}),
                     ((0, 4, 0.5, "weighted"),
                      dict(data_sizes=np.array([5, 0, 0, 0])))):
        with pytest.raises(ValueError) as want:
            ref.sample_participants(*args, **kw)
        with pytest.raises(ValueError, match=str(want.value)[:16]):
            participation.sample_participants(*args, **kw)


def _round_reports(c, t, k, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((c, t, k)) * 2).astype(np.float32),
            rng.random((c, t)) > 0.3)


@pytest.mark.parametrize("decay", [0.0, 0.5, 1.0])
def test_staleness_buffer_sequence_matches(decay):
    """Five rounds over 5 clients and a 24-row proxy set: client 4 never
    reports, the others in and out; every merge's rows, weights, mean age
    and sums equal the reference's."""
    c, size, k, t = 5, 24, 3, 8
    parts = [[1, 1, 0, 1, 0], [0, 1, 1, 0, 0], [1, 1, 1, 1, 0],
             [0, 0, 0, 1, 0], [0, 0, 0, 0, 0]]
    a = participation.StalenessBuffer(c, size, k)
    b = ref.StalenessBuffer(c, size, k)
    rng = np.random.default_rng(7)
    for r, part in enumerate(parts):
        part = np.asarray(part, bool)
        idx = rng.choice(size, t, replace=False)
        logits, masks = _round_reports(c, t, k, r)
        logits[~part], masks[~part] = 0.0, False
        got = a.merge(r, part, idx, torch.from_numpy(logits),
                      torch.from_numpy(masks), decay)
        want = b.merge(r, part, idx, logits, masks, decay)
        np.testing.assert_array_equal(got.logits.numpy(), want.logits)
        np.testing.assert_array_equal(got.masks.numpy(), want.masks)
        np.testing.assert_array_equal(got.client_weights,
                                      want.client_weights)
        assert got.client_weights.dtype == want.client_weights.dtype
        assert (got.mean_staleness, got.ages_sum, got.num_contributing) == (
            want.mean_staleness, want.ages_sum, want.num_contributing)
        assert got.client_weights[4] == 0.0
    sd_a, sd_b = a.state_dict(), b.state_dict()
    for key in ("logits", "masks", "reported", "last_round"):
        np.testing.assert_array_equal(sd_a[key], sd_b[key])
    assert sd_a["last_merge_round"] == sd_b["last_merge_round"] == 4
    fresh = participation.StalenessBuffer(c, size, k)
    fresh.load_state_dict(sd_a)
    np.testing.assert_array_equal(fresh.logits.numpy(), sd_b["logits"])


def test_staleness_buffer_identity_and_order_guard():
    buf = participation.StalenessBuffer(2, 4, 2)
    idx = np.array([0, 1])
    logits = torch.ones((2, 2, 2))
    masks = torch.ones((2, 2), dtype=torch.bool)
    m = buf.merge(3, np.ones(2, bool), idx, logits, masks, 0.5)
    # every client fresh: the inputs come back as they are
    assert m.logits is logits and m.masks is masks
    assert m.mean_staleness == 0.0 and m.num_contributing == 2
    buf.merge(3, np.array([True, False]), idx, logits, masks, 0.5)
    with pytest.raises(ValueError, match="round order"):
        buf.merge(2, np.ones(2, bool), idx, logits, masks, 0.5)


@pytest.mark.parametrize("sharpen", [None, 0.5])
@pytest.mark.parametrize("guard", [True, False])
def test_weighted_masked_mean_logits_matches(sharpen, guard):
    logits, masks = _round_reports(6, 16, 10, 3)
    masks[:, 0] = False                 # no client claims row 0
    masks[:3, 1] = False                # only decayed clients claim row 1
    if guard:
        logits[2, 4, 1] = np.nan
        masks[2, 4] = True
    w = np.array([1.0, 0.5, 0.25, 0.0, 0.125, 1.0], np.float32)
    got = aggregation.weighted_masked_mean_logits(
        torch.from_numpy(logits), torch.from_numpy(masks),
        torch.from_numpy(w), temperature_sharpen=sharpen, guard_finite=guard)
    want = ref_agg.weighted_masked_mean_logits(
        logits, masks, w, temperature_sharpen=sharpen, guard_finite=guard)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert not bool(got[1][0])
    if sharpen is None:   # no weight at all: a zero teacher row
        assert bool((got[0][0] == 0).all())


def _servers(cap=0):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((60, 4)).astype(np.float32)
    y = rng.integers(0, 3, 60).astype(np.int32)
    owner = (np.arange(60) % 4).astype(np.int32)
    return (Server(ProxyData(x, y, owner), seed=0, max_pending_reports=cap,
                   device="cpu"),
            RefServer(RefProxyData(x, y, owner), seed=0,
                      max_pending_reports=cap))


@pytest.mark.parametrize("decay", [0.0, 0.5, 1.0])
def test_server_subset_rounds_match(decay):
    """Four overlapping-style rounds (ingest r+1 before aggregating r) with
    subsets, a non-finite row and the entropy filter: teachers, validity,
    staleness, scrub counts and the ledger equal the reference's."""
    port, refs = _servers()
    parts = [None, [1, 0, 1, 0], [0, 1, 1, 1], [1, 1, 0, 0]]
    pending = []
    for r, part in enumerate(parts):
        idx_p, idx_r = port.select_indices(16), refs.select_indices(16)
        np.testing.assert_array_equal(idx_p, idx_r)
        logits, masks = _round_reports(4, 16, 3, 10 + r)
        if r == 2:
            logits[1, 2, 0] = np.inf
            masks[1, 2] = True
        p = None if part is None else np.asarray(part, bool)
        if p is not None:
            logits[~p], masks[~p] = 0.0, False
        for srv in (port, refs):
            srv.ingest_reports(r, p, idx_p, logits, masks, decay=decay)
        pending.append(r)
        if r % 2:   # two rounds in flight, aggregated in round order
            for q in pending:
                got = port.aggregate_round(q, entropy_filter=q == 3,
                                           sharpen=0.5 if q == 1 else None)
                want = refs.aggregate_round(q, entropy_filter=q == 3,
                                            sharpen=0.5 if q == 1 else None)
                np.testing.assert_allclose(got[0].numpy(), want[0],
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_array_equal(got[1].numpy(), want[1])
                assert got[2] == want[2]
                assert port.pop_scrubbed(q) == refs.pop_scrubbed(q)
            pending = []
            assert port.bytes_received == refs.bytes_received
            assert port.bytes_broadcast == refs.bytes_broadcast


def test_admission_and_classwise_ledger_match():
    port, refs = _servers(cap=5)
    order = np.array([3, 0, 2, 1])
    for r in range(3):
        got = port.admit_reports(r, order)
        want = refs.admit_reports(r, order)
        np.testing.assert_array_equal(got, want)
    assert port._inflight_reports == refs._inflight_reports
    logits, masks = _round_reports(4, 16, 3, 1)
    for srv in (port, refs):
        srv.ingest_reports(0, np.array([1, 1, 1, 1], bool), np.arange(16),
                           logits, masks, decay=0.5)
        srv.aggregate_round(0)
    np.testing.assert_array_equal(port.admit_reports(3, order),
                                  refs.admit_reports(3, order))
    rng = np.random.default_rng(2)
    mc = [((rng.standard_normal((3, 3))).astype(np.float32),
           np.array([2.0, 0.0, 1.0], np.float32) * (i != 1))
          for i in range(4)]
    for weighted in (False, True):
        got = port.aggregate_classwise(
            [(torch.from_numpy(m), torch.from_numpy(c)) for m, c in mc],
            count_weighted=weighted,
            uploaded_rows=np.array([1, 0, 1, 1], bool))
        want = refs.aggregate_classwise(
            mc, count_weighted=weighted,
            uploaded_rows=np.array([1, 0, 1, 1], bool))
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert port.bytes_received == refs.bytes_received
    assert port.bytes_broadcast == refs.bytes_broadcast
    with pytest.raises(ValueError, match="max_pending_reports"):
        Server(port.proxy, max_pending_reports=-1, device="cpu")
