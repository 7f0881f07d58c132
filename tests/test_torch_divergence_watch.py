"""``chip_smoke.py``'s ``DivergenceWatch`` on the CPU: an image run's
non-finite loss passes only when the same phase, rerun in float64 from
its saved start, also leaves float32's range."""
from __future__ import annotations

import importlib.util
import pathlib

import pytest

from repro_torch.core import distill
from repro_torch.launch import fed_train

_SMOKE = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
ARGS = ["--dataset", "mnist_like", "--clients", "4", "--rounds", "1",
        "--n-train", "800", "--n-test", "100", "--device", "cpu"]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_watch_passes_a_divergence_float64_reproduces(smoke):
    """At lr 3 the weights overflow float32; float64 from the saved start
    leaves float32's range too, so the run's NaN loss passes."""
    with smoke.DivergenceWatch() as watch:
        res = fed_train.main(ARGS + ["--lr", "3"])
    assert watch.first is not None
    with pytest.raises(AssertionError, match="non-finite metrics"):
        smoke.check_finite("lr 3", res)
    where = watch.check("lr 3")
    assert "phase, step" in where
    smoke.check_finite("lr 3", res, where)


def test_watch_fails_a_nan_float64_does_not_reproduce(smoke, monkeypatch):
    """A NaN put into the third KL loss of a healthy run is a fault: the
    phase in float64 from its saved start stays finite."""
    calls = []
    orig = distill.kd_kl_loss

    def nan_once(*args, **kwargs):
        calls.append(1)
        loss = orig(*args, **kwargs)
        return loss * float("nan") if len(calls) == 3 else loss
    monkeypatch.setattr(distill, "kd_kl_loss", nan_once)
    with smoke.DivergenceWatch() as watch:
        fed_train.main(ARGS)
    assert watch.first is not None
    with pytest.raises(AssertionError, match="a fault, not a divergence"):
        watch.check("injected NaN")


def test_watch_is_silent_on_a_finite_run(smoke):
    with smoke.DivergenceWatch() as watch:
        res = fed_train.main(ARGS)
    assert watch.check("finite") is None
    smoke.check_finite("finite", res)
