"""The port's payload-fault traces and injector against ``repro.fed.faults``,
bit for bit: the Byzantine subset and the per-round fault masks over a
grid of seed, fleet size, fraction, probability and window, and the
injector's corrupted reports and class-wise payloads in every mode,
``stale_replay`` over three rounds and through ``state_dict``."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.fed import faults as ref
from repro_torch.fed import faults

ATTACKS = [m for m in faults.FAULT_MODES if m != "none"]


def test_constants_match_reference():
    assert faults.FAULT_MODES == ref.FAULT_MODES
    assert faults.SCALE_FACTOR == ref.SCALE_FACTOR
    assert faults.RANDOM_STD == ref.RANDOM_STD
    assert (faults._TAG_BYZ, faults._TAG_FLAKY) == (ref._TAG_BYZ,
                                                    ref._TAG_FLAKY)


@pytest.mark.parametrize("seed", [0, 3, 2**33 + 5])
def test_byzantine_ids_bit_for_bit(seed):
    for c, frac in itertools.product([0, 1, 5, 8, 33, 1000],
                                     [0.0, 0.1, 0.25, 0.34, 0.5, 1.0]):
        np.testing.assert_array_equal(
            faults.byzantine_ids(c, seed=seed, byzantine_frac=frac),
            ref.byzantine_ids(c, seed=seed, byzantine_frac=frac))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mode", ["none"] + ATTACKS)
def test_fault_mask_bit_for_bit(seed, mode):
    grid = itertools.product([1, 6, 64], range(0, 9, 2), [0.0, 0.2, 0.5],
                             [0.0, 0.3, 0.9], [(0, 0), (3, 2), (5, 0)])
    for c, r, frac, prob, (start, dur) in grid:
        kw = dict(seed=seed, mode=mode, fault_prob=prob, byzantine_frac=frac,
                  fault_start=start, fault_duration=dur)
        got, want = faults.fault_mask(c, r, **kw), ref.fault_mask(c, r, **kw)
        assert (got is None) == (want is None), (c, r, kw)
        if want is not None:
            np.testing.assert_array_equal(got, want)


def test_fault_config_refusals_match_reference():
    bad = [dict(mode="flip"), dict(fault_prob=1.0), dict(byzantine_frac=1.5),
           dict(fault_start=-1), dict(fault_duration=-2)]
    for b in bad:
        kw = dict(mode="nan", fault_prob=0.0, byzantine_frac=0.0,
                  fault_start=0, fault_duration=0)
        kw.update(b)
        with pytest.raises(ValueError) as got:
            faults.validate_fault_config(**kw)
        with pytest.raises(ValueError) as want:
            ref.validate_fault_config(**kw)
        assert str(got.value) == str(want.value)


def _pair(mode, c=6, **kw):
    cfg = dict(mode=mode, seed=1, byzantine_frac=0.34, fault_prob=0.3, **kw)
    return faults.FaultInjector(c, **cfg), ref.FaultInjector(c, **cfg)


def _reports(c, t, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(c, t, k)).astype(np.float32),
            rng.random((c, t)) < 0.6)


@pytest.mark.parametrize("mode", ATTACKS)
@pytest.mark.parametrize("with_part", [False, True])
def test_corrupt_reports_bit_for_bit(mode, with_part):
    """Three rounds (stale_replay warms its cache in the first faulty one
    and replays after), then the replay cache through state_dict."""
    port, refi = _pair(mode)
    part = np.array([True, True, False, True, True, False]) if with_part \
        else None
    for r in range(3):
        lo, mk = _reports(6, 8, 5, 10 + r)
        lo_t, mk_t = torch.as_tensor(lo), torch.as_tensor(mk)
        got_lo, got_mk = port.corrupt_reports(r, lo_t, mk_t, part)
        want_lo, want_mk = refi.corrupt_reports(r, lo, mk, part)
        np.testing.assert_array_equal(got_lo.numpy(), want_lo)
        np.testing.assert_array_equal(got_mk.numpy(), want_mk)
        if want_lo is lo:  # a clean round hands back the same objects
            assert got_lo is lo_t and got_mk is mk_t
        else:  # a corrupted one works on clones
            np.testing.assert_array_equal(lo_t.numpy(), lo)
    p_sd, r_sd = port.state_dict(), refi.state_dict()
    assert [c for c, _, _ in p_sd["replay"]] == [c for c, _, _ in
                                                r_sd["replay"]]
    for (_, pa, pb), (_, ra, rb) in zip(p_sd["replay"], r_sd["replay"]):
        np.testing.assert_array_equal(pa, ra)
        np.testing.assert_array_equal(pb, rb)


def test_stale_replay_cache_is_a_clone_and_resumes():
    """The cached rows do not change when the caller overwrites its stack,
    and after a state_dict round trip the injector replays what the
    reference's replays."""
    port, refi = _pair("stale_replay", c=3)
    lo, mk = _reports(3, 4, 2, 0)
    lo_t, mk_t = torch.as_tensor(lo.copy()), torch.as_tensor(mk.copy())
    port.corrupt_reports(0, lo_t, mk_t, None)
    refi.corrupt_reports(0, lo, mk, None)
    lo_t.fill_(123.0)          # the caller reuses its report stack
    mk_t.fill_(False)
    resumed = faults.FaultInjector(3, mode="stale_replay", seed=1,
                                   byzantine_frac=0.34, fault_prob=0.3)
    resumed.load_state_dict(port.state_dict())
    lo1, mk1 = _reports(3, 4, 2, 1)
    want, want_m = refi.corrupt_reports(1, lo1, mk1, None)
    assert not np.array_equal(want, lo1)   # a report was replayed
    for inj in (port, resumed):
        got, got_m = inj.corrupt_reports(1, torch.as_tensor(lo1),
                                         torch.as_tensor(mk1), None)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_m.numpy(), want_m)


@pytest.mark.parametrize("mode", ATTACKS)
def test_corrupt_classwise_bit_for_bit(mode):
    port, refi = _pair(mode)
    part = np.array([True, False, True, True, True, True])
    for r in range(3):
        rng = np.random.default_rng(20 + r)
        payload = []
        for _ in range(6):
            counts = rng.integers(0, 3, size=4).astype(np.float32)
            payload.append((rng.normal(size=(4, 4)).astype(np.float32),
                            counts))
        got = port.corrupt_classwise(
            r, [(torch.as_tensor(m), torch.as_tensor(c)) for m, c in payload],
            part)
        want = refi.corrupt_classwise(r, payload, part)
        for (gm, gc), (wm, wc) in zip(got, want):
            np.testing.assert_array_equal(gm.numpy(), wm)
            np.testing.assert_array_equal(gc.numpy(), wc)
    p_sd, r_sd = port.state_dict(), refi.state_dict()
    assert len(p_sd["replay"]) == len(r_sd["replay"])
    for (pc, pa, pb), (rc, ra, rb) in zip(p_sd["replay"], r_sd["replay"]):
        assert pc == rc
        np.testing.assert_array_equal(pa, ra)
        np.testing.assert_array_equal(pb, rb)


def test_injector_mask_matches_reference():
    port, refi = _pair("scaled", c=40)
    for r in range(5):
        a, b = port.mask(r), refi.mask(r)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
