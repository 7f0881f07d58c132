"""The proxy-logit baselines of Table III on the image path (``mnist_like``,
C = 4, Table I CNN slots 0–3) in the port against a live run of the JAX
reference: FedMD, FedED, DS-FL and FedDF (``server_distill``, whose
student is client 0's CNN).

The harness and its tolerances are in ``tests/_torch_parity.py``.
"""
import pytest

from _torch_parity import assert_logs_match, config
from repro_torch.models.cnn import CNNClassifier


@pytest.mark.parametrize("method", ["fedmd", "feded", "dsfl",
                                    "server_distill"])
def test_image_ensemble_round_logs_match_live_reference(method):
    ref, port = assert_logs_match(config(method, "strong"), "mnist_like")
    assert all(r.id_fraction == 1.0 for r in port.result.rounds)
    if method == "server_distill":
        student = port.server.student.model
        assert isinstance(student, CNNClassifier)
        assert all(r.server_student_acc is not None
                   for r in port.result.rounds)
