"""The port refuses a malformed federated config as the reference does.

``repro.fed.simulator.run`` checks its participation and scheduler knobs
(``participation.validate_config``, ``scheduler.validate_config``) before
it builds anything; ``repro_torch.fed.simulator.run`` must raise the same
exception type on the same config, also where the knob's feature is not
ported yet (the port would otherwise refuse it with
``NotImplementedError``, or run it).
"""
import dataclasses

import pytest

from repro.common.types import FedConfig as RefFedConfig
from repro.fed import simulator as ref_simulator
from repro_torch.common.types import FedConfig
from repro_torch.fed import simulator

BAD_CONFIGS = {
    "straggler_factor": dict(straggler_factor=0.5),
    "arrival_process": dict(arrival_process="bogus"),
    "staleness_decay": dict(staleness_decay=2.0),
    "max_inflight": dict(max_inflight=0),
    "participation_policy": dict(participation_policy="bogus"),
    "arrival_bursts": dict(arrival_bursts=0),
    "participation_fraction": dict(participation_fraction=0.0),
}


def _raised(run, cfg, **kwargs):
    with pytest.raises(Exception) as info:
        run(cfg, "mnist_feat", n_train=200, n_test=50, **kwargs)
    return type(info.value)


@pytest.mark.parametrize("knob", sorted(BAD_CONFIGS))
def test_port_raises_the_reference_exception_on_a_bad_config(knob,
                                                             monkeypatch):
    """Same exception type from both packages, and the port raises it
    before it builds any client."""
    def built(*args, **kwargs):
        raise AssertionError("the port built the experiment")
    monkeypatch.setattr(simulator, "build_experiment", built)
    bad = BAD_CONFIGS[knob]
    want = _raised(ref_simulator.run,
                   dataclasses.replace(RefFedConfig(num_clients=2), **bad))
    got = _raised(simulator.run,
                  dataclasses.replace(FedConfig(num_clients=2), **bad),
                  device="cpu")
    assert want is ValueError
    assert got is want
