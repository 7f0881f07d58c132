"""The data-free and non-collaborative baselines of Table III on the image
path (``mnist_like``, C = 4, Table I CNN slots 0–3) in the port against a
live run of the JAX reference: FKD and PLS (class-wise mean logits over
private images, in eval mode) and independent learning.

The harness and its tolerances are in ``tests/_torch_parity.py``.
"""
import pytest

from _torch_parity import assert_logs_match, config


@pytest.mark.parametrize("method", ["fkd", "pls", "indlearn"])
def test_image_datafree_round_logs_match_live_reference(method):
    ref, port = assert_logs_match(config(method, "strong"), "mnist_like")
    for p in port.result.rounds:
        assert p.id_fraction == 1.0
        if method == "indlearn":
            assert set(p.phase_s) == {"local_train", "eval"}
            assert p.bytes_up == p.bytes_down == 0
