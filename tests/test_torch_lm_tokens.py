"""The transformer scenario (``lm_tokens``) in the port against a live run
of the JAX reference's loop engine.

Every client is the reduced granite backbone
(``core.fd_trainer.TransformerClientModel``), at the sizes of
``tests/test_fd_transformer.py``: 3 clients, 2 rounds, proxy batch 64,
batch 16, n_train 300, n_test 150. The harness and its tolerances are in
``tests/_torch_parity.py``: the port loads the reference's transformer
pytrees and k-means++ seeds and runs on the CPU through its plain PyTorch
versions; losses hold to rtol 1e-4, accuracies to one test sample, and the
ID fraction and byte ledger exactly, up to counted near-threshold pairs
(the DRE's features are raw token ids, so private distances can tie).
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_logs_match, config
from repro_torch.common.types import FedConfig
from repro_torch.core.fd_trainer import TransformerClientModel
from repro_torch.data.synthetic import make_dataset
from repro_torch.fed import simulator

N_TRAIN, N_TEST = 300, 150
SIZES = dict(num_clients=3, rounds=2, proxy_batch=64, batch_size=16, lr=1e-2)


@pytest.mark.parametrize("scenario", ["strong", "weak"])
def test_lm_tokens_edgefd_round_logs_match_live_reference(scenario):
    ref, port = assert_logs_match(config("edgefd", scenario, **SIZES),
                                  "lm_tokens", N_TRAIN, N_TEST)
    for c in port.clients:
        assert isinstance(c.model, TransformerClientModel)
        # token batches stay integers for the embedding lookup
        assert c._x.dtype == torch.int64
    assert all(0.0 < r.id_fraction < 1.0 for r in port.result.rounds)


def test_lm_tokens_dataset_matches_the_reference_sampler():
    """The same sampler as the reference (its draws come from a torch
    generator here): int32 tokens within the label's vocab band."""
    ds = make_dataset("lm_tokens", n_train=400, n_test=50, seed=3)
    assert ds.x.dtype == np.int32 and ds.x.shape == (400, 16)
    assert ds.num_classes == 32 and ds.x_test.shape == (50, 16)
    offset = (ds.x - ds.y[:, None]) % 32
    assert set(np.unique(offset)) <= {0, 1, 2, 30, 31}   # half width 2
    assert len(np.unique(ds.y)) == 32
    again = make_dataset("lm_tokens", n_train=400, n_test=50, seed=3)
    np.testing.assert_array_equal(ds.x, again.x)


def test_server_distill_runs_in_token_mode():
    """FedDF's student is a transformer too (port-only, one round)."""
    cfg = FedConfig(method="server_distill", num_clients=3, rounds=1,
                    proxy_batch=64, batch_size=16, seed=0)
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, "lm_tokens", n_train=N_TRAIN, n_test=N_TEST, device="cpu")
    assert isinstance(server.student.model, TransformerClientModel)
    from repro_torch.core.protocol import run_experiment
    res = run_experiment(clients, server, cfg.method, cfg, x_test, y_test)
    log = res.rounds[0]
    assert "server_distill" in log.phase_s
    assert np.isfinite(log.server_distill_loss) and log.server_distill_loss > 0
    assert 0.0 <= log.server_student_acc <= 1.0
    assert log.id_fraction == 1.0          # fedDF has no client filter
