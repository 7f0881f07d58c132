"""The image path (the paper's pixel-space experiment, Tables I/II CNN zoo)
in the port against a live run of the JAX reference: EdgeFD strong on
``mnist_like`` (C = 4, Table I slots 0–3), Selective-FD strong on
``mnist_like`` (KuLSIF on 784-wide flattened images), EdgeFD strong on
``cifar_like`` (C = 2, Table II slots 0 and 1, with BatchNorm, one round)
and EdgeFD weak on ``fashion_like`` (three centroids per client).

The harness and its tolerances are in ``tests/_torch_parity.py``: the
port is built from the reference's NHWC arrays, CNN parameter lists,
k-means++ seeds and KuLSIF auxiliary samples; losses hold to rtol 1e-4,
accuracies to one test sample, the ID fraction and byte ledger exactly, up
to counted near-threshold pairs.
"""
import numpy as np
import pytest

from _torch_parity import assert_logs_match, config
from repro_torch.models.cnn import CNNClassifier


def _check_image_clients(ref, port, hw, ch):
    assert port.clients[0].x.shape[1:] == (hw, hw, ch)
    for pc, rc in zip(port.clients, ref.clients):
        assert isinstance(pc.model, CNNClassifier)
        np.testing.assert_array_equal(pc.x, np.asarray(rc.x))


@pytest.mark.parametrize("method,scenario,dataset,overrides", [
    ("edgefd", "strong", "mnist_like", {}),
    ("selective-fd", "strong", "mnist_like", {}),
    ("edgefd", "strong", "cifar_like", dict(num_clients=2, rounds=1)),
    ("edgefd", "weak", "fashion_like", {}),
])
def test_image_round_logs_match_live_reference(method, scenario, dataset,
                                               overrides):
    ref, port = assert_logs_match(config(method, scenario, **overrides),
                                  dataset)
    hw, ch = (32, 3) if dataset == "cifar_like" else (28, 1)
    _check_image_clients(ref, port, hw, ch)
    # the filter keeps a client's own proxy rows at least
    assert 0.0 < port.result.rounds[0].id_fraction <= 1.0
    if method == "edgefd":
        for pc, rc in zip(port.clients, ref.clients):
            assert pc.dre.centroids.shape == (rc.dre.num_centroids,
                                              hw * hw * ch)
