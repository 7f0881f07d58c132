"""``chip_smoke.py``'s ``DivergenceWatch`` on the CPU: an image run's
non-finite loss passes only when the same phase, rerun in float64 from
its saved start, also leaves float32's range."""
from __future__ import annotations

import importlib.util
import pathlib

import pytest

import types

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
    assert "phase, step" in where and watch.first_round == 0
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


COHORT = ["--engine", "cohort"]


def test_watch_passes_a_divergence_on_the_cohort_engine(smoke):
    """The cohort engine (one-client cohorts on images): the watch saves
    every lane at a cohort phase's start and reads the phase's step
    losses; the lr 3 divergence passes as on the loop engine."""
    with smoke.DivergenceWatch() as watch:
        res = fed_train.main(ARGS + COHORT + ["--lr", "3"])
    assert watch.first is not None
    where = watch.check("cohort lr 3")
    assert "phase, step" in where and watch.first_round == 0
    smoke.check_finite("cohort lr 3", res, where)


def test_watch_fails_a_nan_on_the_cohort_engine(smoke, monkeypatch):
    """A NaN put into one lane of the third batched KL loss is a fault."""
    calls = []
    orig = distill.kd_kl_loss_clients

    def nan_once(*args, **kwargs):
        calls.append(1)
        loss = orig(*args, **kwargs)
        if len(calls) == 3:
            loss = loss * float("nan")
        return loss
    monkeypatch.setattr(distill, "kd_kl_loss_clients", nan_once)
    with smoke.DivergenceWatch() as watch:
        fed_train.main(ARGS + COHORT)
    assert watch.first is not None
    with pytest.raises(AssertionError, match="a fault, not a divergence"):
        watch.check("cohort injected NaN")


def _run(*losses):
    """A result of len(losses) rounds, local loss as given, the rest
    equal."""
    return types.SimpleNamespace(rounds=[types.SimpleNamespace(
        round=r, local_loss=v, distill_loss=0.5, accs=[0.5, 0.5],
        id_fraction=1.0) for r, v in enumerate(losses)])


NAN, INF = float("nan"), float("inf")


@pytest.mark.parametrize("a, b, diverged, ok", [
    # no verdicts (phase 5's card-vs-CPU runs): any non-finite loss fails
    ((1.0, NAN), (1.0, NAN), (None, None), False),
    ((1.0, INF), (1.0, INF), (None, None), False),
    # a verdict for one run only
    ((1.0, NAN), (1.0, NAN), (("x", 1), None), False),
    # both shown to diverge by round 1: NaN against NaN agrees from there
    ((1.0, NAN), (1.0, NAN), (("x", 1), ("y", 1)), True),
    ((1.0, INF), (1.0, INF), (("x", 0), ("y", 1)), True),
    # but not in a round before the later divergence
    ((NAN, NAN), (NAN, NAN), (("x", 0), ("y", 1)), False),
    # nor against a finite loss or an infinity of the other sign
    ((1.0, NAN), (1.0, 2.0), (("x", 1), ("y", 1)), False),
    ((1.0, INF), (1.0, -INF), (("x", 1), ("y", 1)), False),
    ((1.0, 2.0), (1.0, INF), (None, None), False),
    # finite losses within rtol 1e-3 pass either way
    ((1.0, 2.0), (1.0, 2.0005), (None, None), True),
])
def test_compare_runs_lets_nan_match_only_after_shown_divergences(
        smoke, a, b, diverged, ok):
    run = lambda: smoke.compare_runs("pair", _run(*a), _run(*b), 100,
                                     diverged=diverged)
    if ok:
        run()
    else:
        with pytest.raises(AssertionError, match="local_loss"):
            run()
