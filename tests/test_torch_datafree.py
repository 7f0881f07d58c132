"""The data-free and non-collaborative baselines of Table III in the port
against a live run of the JAX reference: FKD and PLS (class-wise mean
logits, unweighted and count-weighted, distilled on private data) and
independent learning (train and evaluate only), plus their class-wise
modules on their own.

The harness and its tolerances are in ``tests/_torch_parity.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_logs_match, config
from repro.core import aggregation as ref_agg
from repro.data import proxy as ref_proxy
from repro.fed.server import Server as RefServer
from repro_torch.core import aggregation
from repro_torch.data import proxy
from repro_torch.fed.server import Server

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["fkd", "pls"])
def test_classwise_round_logs_match_live_reference(method):
    ref, port = assert_logs_match(config(method, "strong"))
    assert all(r.id_fraction == 1.0 for r in port.result.rounds)
    assert port.result.rounds[-1].bytes_up > 0


def test_indlearn_round_logs_match_live_reference():
    ref, port = assert_logs_match(config("indlearn", "strong"))
    for p in port.result.rounds:
        assert set(p.phase_s) == {"local_train", "eval"}
        assert p.bytes_up == p.bytes_down == 0
    # no DRE is fitted without a client filter
    assert all(c.dre is None for c in port.clients)


def _private(n=120, k=10, classes=(0, 3, 7), seed=0):
    rng = np.random.default_rng(seed)
    y = rng.choice(np.asarray(classes), n).astype(np.int32)
    logits = (rng.standard_normal((n, k)) * 3).astype(np.float32)
    return logits, y


def test_classwise_mean_logits_matches():
    logits, y = _private()
    m, c = aggregation.classwise_mean_logits(torch.from_numpy(logits),
                                             torch.from_numpy(y), 10)
    m_w, c_w = ref_agg.classwise_mean_logits(jnp.asarray(logits),
                                             jnp.asarray(y), 10)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_w), **F32)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_w))
    assert float(m[1].abs().sum()) == 0.0      # an absent class: zero row


@pytest.mark.parametrize("count_weighted", [False, True])
@pytest.mark.parametrize("poison", [False, True])
def test_aggregate_classwise_matches_reference_and_ledger(count_weighted,
                                                          poison):
    tables = []
    for i, classes in enumerate(((0, 3, 7), (3, 4), (7, 8, 9))):
        logits, y = _private(n=60 + 10 * i, classes=classes, seed=i)
        tables.append(ref_agg.classwise_mean_logits(jnp.asarray(logits),
                                                    jnp.asarray(y), 10))
    tables = [(np.array(m), np.array(c)) for m, c in tables]
    if poison:
        tables[1][0][3, 2] = np.nan            # a held class goes bad
    x = np.zeros((30, 4), np.float32)
    px = ref_proxy.ProxyData(x, np.zeros(30, np.int32),
                             np.zeros(30, np.int32))
    ref = RefServer(px, seed=0)
    port = Server(proxy.ProxyData(*px), seed=0, device="cpu")
    t_w, v_w = ref.aggregate_classwise(
        [(jnp.asarray(m), jnp.asarray(c)) for m, c in tables],
        count_weighted=count_weighted, round_idx=0)
    t, v = port.aggregate_classwise(
        [(torch.from_numpy(m), torch.from_numpy(c)) for m, c in tables],
        count_weighted=count_weighted, round_idx=0)
    np.testing.assert_allclose(t.numpy(), t_w, **F32)
    np.testing.assert_array_equal(v.numpy(), v_w)
    assert port.bytes_received == ref.bytes_received
    assert port.bytes_broadcast == ref.bytes_broadcast
    assert port.pop_scrubbed(0) == ref.pop_scrubbed(0) == int(poison)
    assert port.scrub_total == ref.scrub_total
