"""The proxy-logit baselines of Table III in the port against a live run of
the JAX reference: FedMD and FedED (plain ensemble, temperature KL), DS-FL
(sharpened ensemble) and FedDF (``server_distill``: the server's student
distills on the fused teacher too), plus DS-FL's sharpening on its own.

The harness and its tolerances are in ``tests/_torch_parity.py``; the
student's loss and accuracy hold to the clients' tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_logs_match, config
from repro.core import aggregation as ref_agg
from repro_torch.core import aggregation

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["fedmd", "feded", "dsfl"])
def test_ensemble_round_logs_match_live_reference(method):
    ref, port = assert_logs_match(config(method, "strong"))
    # no client filter: every client reports every proxy sample
    assert all(r.id_fraction == 1.0 for r in port.result.rounds)


def test_server_distill_round_logs_match_live_reference():
    ref, port = assert_logs_match(config("server_distill", "strong"))
    for p, q in zip(port.result.rounds, ref.result.rounds):
        assert "server_distill" in p.phase_s
        assert p.server_distill_loss > 0.0
        assert p.server_student_acc is not None


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("temp", [0.5, None])
def test_sharpened_masked_mean_matches(seed, temp):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((4, 32, 10)) * 3).astype(np.float32)
    masks = rng.random((4, 32)) > 0.4
    masks[:, 0] = False                 # no client claims it: zero teacher
    t, v = aggregation.masked_mean_logits(
        torch.from_numpy(logits), torch.from_numpy(masks),
        temperature_sharpen=temp)
    t_w, v_w = ref_agg.masked_mean_logits(
        jnp.asarray(logits), jnp.asarray(masks), temperature_sharpen=temp)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_w), **F32)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_w))
    if temp:   # sharpened rows are log-probabilities
        np.testing.assert_allclose(torch.logsumexp(t, -1).numpy(), 0.0,
                                   atol=1e-5)
