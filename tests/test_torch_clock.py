"""The port's simulated deployment clock (``repro_torch.fed.clock``) against
the reference's (``repro.fed.clock``), bit for bit: straggler speeds,
arrival traces (static, poisson, bursty), churn and dropout masks, the
vectorized SeedSequence/PCG64 lanes and the timeline's primitives. Both
modules are numpy only, so every comparison is exact."""
import numpy as np
import pytest

from repro.fed import clock as ref
from repro_torch.fed import clock

SEEDS = (0, 1, 12345)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("factor", [1.0, 2.5, 4.0])
def test_client_speeds(seed, factor):
    got = clock.client_speeds(16, seed=seed, straggler_factor=factor)
    np.testing.assert_array_equal(
        got, ref.client_speeds(16, seed=seed, straggler_factor=factor))
    # a client keeps its speed when the fleet grows 8 -> 16
    np.testing.assert_array_equal(
        clock.client_speeds(8, seed=seed, straggler_factor=factor), got[:8])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("process,spread,bursts", [
    ("static", 2.0, 4), ("poisson", 0.0, 4), ("poisson", 1.5, 4),
    ("bursty", 2.0, 4), ("bursty", 3.0, 1)])
def test_arrival_offsets(seed, process, spread, bursts):
    for r in range(3):
        kw = dict(seed=seed, process=process, spread=spread, bursts=bursts)
        got = clock.arrival_offsets(16, r, **kw)
        want = ref.arrival_offsets(16, r, **kw)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(clock.arrival_offsets(8, r, **kw),
                                      got[:8])


@pytest.mark.parametrize("seed", SEEDS)
def test_churn_and_dropout_masks(seed):
    for r in range(4):
        for p in (0.0, 0.1, 0.5):
            for port_fn, ref_fn, knob in (
                    (clock.online_mask, ref.online_mask, "churn"),
                    (clock.dropout_mask, ref.dropout_mask, "dropout")):
                got = port_fn(16, r, seed=seed, **{knob: p})
                want = ref_fn(16, r, seed=seed, **{knob: p})
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)


def test_lane_uniform_and_seedseq_state():
    for seed in (0, 7, 2**32 + 5):
        for rnd in (None, 0, 3):
            np.testing.assert_array_equal(
                clock._lane_uniform(seed, 33, 0xC10C, rnd),
                ref._lane_uniform(seed, 33, 0xC10C, rnd))
    cols = [np.arange(9, dtype=np.uint32) * 7 + i for i in range(6)]
    np.testing.assert_array_equal(clock._seedseq_state(cols),
                                  ref._seedseq_state(cols))
    # the emulation is numpy's own generator, lane by lane
    want = [np.random.default_rng(np.random.SeedSequence(
        [3, c, 0xC10C])).random() for c in range(5)]
    np.testing.assert_array_equal(clock._lane_uniform(3, 5, 0xC10C), want)


def test_refusals_match():
    for fn, kw in ((clock.client_speeds, dict(straggler_factor=0.5)),
                   (clock.online_mask, dict(round_idx=0, churn=1.0)),
                   (clock.dropout_mask, dict(round_idx=0, dropout=-0.1)),
                   (clock.arrival_offsets, dict(round_idx=0,
                                                process="bogus")),
                   (clock.arrival_offsets, dict(round_idx=0, process="bursty",
                                                spread=1.0, bursts=0))):
        ref_fn = getattr(ref, fn.__name__)
        with pytest.raises(ValueError) as want:
            ref_fn(4, **kw)
        with pytest.raises(ValueError, match=str(want.value)[:20]):
            fn(4, **kw)


def test_timeline_primitives_and_state():
    speeds = clock.client_speeds(6, seed=1, straggler_factor=3.0)
    a, b = clock.SimTimeline(speeds), ref.SimTimeline(speeds)
    offsets = clock.arrival_offsets(6, 0, seed=1, process="poisson",
                                    spread=0.7)
    part = np.array([True, False, True, True, False, True])
    per = np.linspace(0.1, 0.6, 6)
    steps = [("client", (None, 1.0), dict(offsets=offsets)),
             ("client", (part, 0.3), dict(ready_s=0.5)),
             ("server", (0.25,), dict(ready_s=1.0)),
             ("client", (part, per), dict(ready_s=2.0)),
             ("client", (np.zeros(6, bool), 5.0), dict(ready_s=7.0)),
             ("server", (0.5,), dict(ready_s=0.0))]
    for kind, args, kw in steps:
        name = "client_phase" if kind == "client" else "server_phase"
        got = getattr(a, name)(*args, **kw)
        want = getattr(b, name)(*args, **kw)
        assert got == want and type(got) is type(want)
        np.testing.assert_array_equal(a.client_free, b.client_free)
        assert a.server_free == b.server_free
    sd = a.state_dict()
    np.testing.assert_array_equal(sd["client_free"],
                                  b.state_dict()["client_free"])
    c = clock.SimTimeline(speeds)
    c.load_state_dict(sd)
    np.testing.assert_array_equal(c.client_free, a.client_free)
    with pytest.raises(ValueError, match="lane-count mismatch"):
        clock.SimTimeline(speeds[:3]).load_state_dict(sd)
