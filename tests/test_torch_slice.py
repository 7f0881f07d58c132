"""The port's EdgeFD path against a live run of the JAX reference.

The harness and its tolerances are in ``tests/_torch_parity.py``: the
reference runs on the jnp backend, the port is built from the reference's
dataset arrays, initial parameters and k-means++ seeds and runs on the CPU
through its plain PyTorch versions; losses hold to rtol 1e-4, accuracies
to one test sample, and the ID fraction and byte ledger exactly, up to
counted near-threshold pairs.
"""
import pytest

from _torch_parity import assert_logs_match, config


@pytest.mark.parametrize("scenario", ["strong", "weak", "iid"])
def test_edgefd_round_logs_match_live_reference(scenario):
    assert_logs_match(config("edgefd", scenario))
