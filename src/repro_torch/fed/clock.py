"""Simulated deployment clock: straggler speeds, arrival traces, a timeline.

A copy of ``repro.fed.clock`` (numpy only; the port imports nothing of the
reference package), bit for bit: the same draws for the same
``(seed, round, client)``, the same timeline arithmetic.

A single host executes every round phase back-to-back, so "overlapping
rounds beat lockstep rounds" is invisible in host wall-clock — the win
lives in the *deployment* timeline, where every edge client runs in
parallel at its own speed and the slowest participant gates each
synchronous barrier. This module prices a phase schedule onto that
timeline:

``client_speeds``
    ``(C,)`` slowdown multipliers in ``[1, straggler_factor]``, each drawn
    deterministically from ``(seed, client)`` and nothing else — stable
    across rounds, participation subsets, engines and client-count
    changes (client ``c`` keeps its speed when the fleet grows).

``arrival_offsets`` / ``online_mask`` / ``dropout_mask``
    Trace-driven arrival processes for heavy-traffic rounds, every draw
    deterministic in ``(seed, round, client)`` (and nothing else, so
    client ``c``'s trace is stable under fleet growth):

      * **arrival offsets** — when each client shows up for a round on the
        simulated timeline: ``static`` (everyone at phase start, the
        legacy behavior), ``poisson`` (iid exponential delays), or
        ``bursty`` (clients cluster into arrival spikes; a client's burst
        is stable in ``(seed, client)``, like a timezone cohort).
      * **churn** — a client is offline for the whole round with some
        probability; the scheduler removes it from the participant set so
        it drains through the staleness machinery.
      * **mid-round dropout** — a client trains but vanishes before
        reporting; its fresh report never reaches the server.

``SimTimeline``
    Event accounting over two resource kinds: one lane per client (clients
    run in parallel with each other; each client is serial with itself)
    and one serial server. The phase-graph scheduler
    (``repro_torch.fed.scheduler``) replays its *host* execution order through
    the timeline, so per-client data dependencies are respected by
    construction: a lane is occupied in exactly the order the numerics
    consumed it.

The clock is pure accounting on the timeline side (arrival offsets never
touch numerics); churn and dropout DO change the participant set — they
are part of the protocol being simulated, not just its price. Eval phases
are priced at zero: evaluating every client against the held-out test set
is a simulation-side measurement, not deployment work.

Implementation note: per-lane draws are produced by a vectorized,
bit-identical reimplementation of
``np.random.default_rng(SeedSequence([...])).random()`` (SeedSequence's
entropy-mixing hash plus PCG64's 128-bit LCG, both stable by numpy's
reproducibility policy), so a 10^4–10^6-client fleet costs a few numpy
ops instead of C Generator constructions (the reference pins it against
the per-client loop; ``tests/test_torch_clock.py`` pins this copy against
the reference).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

ARRIVAL_PROCESSES = ("static", "poisson", "bursty")

# ---------------------------------------------------------------------------
# Vectorized (seed, ..., lane) -> uniform double, bit-identical to
# np.random.default_rng(np.random.SeedSequence(entropy)).random() per lane.
# ---------------------------------------------------------------------------

# SeedSequence hashing constants (numpy/_bit_generator.pyx; fixed by
# numpy's stream-compatibility guarantee)
_XSHIFT = np.uint32(16)
_INIT_A = np.uint32(0x43B0D7E5)
_MULT_A = np.uint32(0x931E8875)
_INIT_B = np.uint32(0x8B51F9DD)
_MULT_B = np.uint32(0x58F38DED)
_MIX_MULT_L = np.uint32(0xCA01F9DD)
_MIX_MULT_R = np.uint32(0x4973F715)
_POOL_SIZE = 4

# PCG64's 128-bit LCG multiplier, as (hi, lo) 64-bit limbs
_PCG_MULT_H = np.uint64(2549297995355413924)
_PCG_MULT_L = np.uint64(4865540595714422341)
_MASK32 = np.uint64(0xFFFFFFFF)


def _hashmix(value: np.ndarray, hash_const: list) -> np.ndarray:
    value = value ^ hash_const[0]
    hash_const[0] = hash_const[0] * _MULT_A
    value = value * hash_const[0]
    return value ^ (value >> _XSHIFT)


def _mix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    result = (x * _MIX_MULT_L) - (y * _MIX_MULT_R)
    return result ^ (result >> _XSHIFT)


def _seedseq_state(entropy_cols) -> np.ndarray:
    """SeedSequence(entropy).generate_state(4, uint64), lane-vectorized.

    ``entropy_cols``: per-word (N,) uint32 arrays — the assembled entropy,
    equal length across lanes (every entropy word must fit uint32).
    Returns (N, 4) uint64.
    """
    n = entropy_cols[0].shape[0]
    with np.errstate(over="ignore"):
        hash_const = [_INIT_A]
        pool = []
        for i in range(_POOL_SIZE):
            v = (entropy_cols[i] if i < len(entropy_cols)
                 else np.zeros(n, np.uint32))
            pool.append(_hashmix(v, hash_const))
        for i_src in range(_POOL_SIZE):
            for i_dst in range(_POOL_SIZE):
                if i_src != i_dst:
                    pool[i_dst] = _mix(pool[i_dst],
                                       _hashmix(pool[i_src], hash_const))
        for i_src in range(_POOL_SIZE, len(entropy_cols)):
            for i_dst in range(_POOL_SIZE):
                pool[i_dst] = _mix(pool[i_dst],
                                   _hashmix(entropy_cols[i_src], hash_const))
        hash_const = [_INIT_B]
        words32 = np.zeros((n, 8), np.uint32)
        for i_dst in range(8):
            data_val = pool[i_dst % _POOL_SIZE] ^ hash_const[0]
            hash_const[0] = hash_const[0] * _MULT_B
            data_val = data_val * hash_const[0]
            words32[:, i_dst] = data_val ^ (data_val >> _XSHIFT)
    w = words32.astype(np.uint64)
    return w[:, 0::2] | (w[:, 1::2] << np.uint64(32))  # low word first


def _mul128(ah, al, bh, bl):
    """(ah<<64|al) * (bh<<64|bl) mod 2^128, element-wise on uint64 limbs."""
    a_lo, a_hi = al & _MASK32, al >> np.uint64(32)
    b_lo, b_hi = bl & _MASK32, bl >> np.uint64(32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    mid = (ll >> np.uint64(32)) + (lh & _MASK32) + (hl & _MASK32)
    lo = (ll & _MASK32) | (mid << np.uint64(32))
    hi = (a_hi * b_hi + (lh >> np.uint64(32)) + (hl >> np.uint64(32))
          + (mid >> np.uint64(32)) + al * bh + ah * bl)
    return hi, lo


def _add128(ah, al, bh, bl):
    lo = al + bl
    return ah + bh + (lo < al).astype(np.uint64), lo


def _uniform_lanes(entropy_cols) -> np.ndarray:
    """First uniform double of the PCG64 stream seeded per lane."""
    words = _seedseq_state(entropy_cols)
    with np.errstate(over="ignore"):
        init_h, init_l = words[:, 0].copy(), words[:, 1].copy()
        seq_h, seq_l = words[:, 2], words[:, 3]
        inc_h = (seq_h << np.uint64(1)) | (seq_l >> np.uint64(63))
        inc_l = (seq_l << np.uint64(1)) | np.uint64(1)

        def step(h, l):
            h, l = _mul128(h, l, _PCG_MULT_H, _PCG_MULT_L)
            return _add128(h, l, inc_h, inc_l)

        # pcg64_srandom_r: state = 0; step; state += initstate; step
        st_h, st_l = step(np.zeros_like(init_h), np.zeros_like(init_l))
        st_h, st_l = _add128(st_h, st_l, init_h, init_l)
        st_h, st_l = step(st_h, st_l)
        # first next64: step, then XSL-RR output
        st_h, st_l = step(st_h, st_l)
        rot = st_h >> np.uint64(58)
        xored = st_h ^ st_l
        out = (xored >> rot) | (xored << ((np.uint64(64) - rot)
                                          & np.uint64(63)))
    return (out >> np.uint64(11)).astype(np.float64) / 9007199254740992.0


def _lane_uniform(seed: int, num_clients: int, tag: int,
                  round_idx: Optional[int] = None) -> np.ndarray:
    """(C,) uniforms, lane c drawn from (seed[, round], c, tag) only."""
    cs = np.arange(num_clients, dtype=np.uint32)
    cols = [np.full(num_clients, np.uint32(seed % 2**32))]
    if round_idx is not None:
        cols.append(np.full(num_clients, np.uint32(round_idx % 2**32)))
    cols += [cs, np.full(num_clients, np.uint32(tag))]
    return _uniform_lanes(cols)


# ---------------------------------------------------------------------------
# Straggler speeds
# ---------------------------------------------------------------------------

def client_speeds(num_clients: int, *, seed: int = 0,
                  straggler_factor: float = 4.0) -> np.ndarray:
    """``(C,)`` per-client slowdown multipliers in ``[1, straggler_factor]``.

    ``straggler_factor=1`` is a homogeneous fleet (every multiplier exactly
    1). Each entry depends on ``(seed, client)`` only, so the draw is
    reproducible per client regardless of fleet size or round count.
    """
    if straggler_factor < 1.0:
        raise ValueError(
            f"straggler_factor must be >= 1.0 (1.0 = homogeneous fleet), "
            f"got {straggler_factor!r}")
    if straggler_factor == 1.0 or num_clients == 0:
        return np.ones((num_clients,), np.float64)
    u = _lane_uniform(seed, num_clients, 0xC10C)
    return 1.0 + (straggler_factor - 1.0) * u


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------

def arrival_offsets(num_clients: int, round_idx: int, *, seed: int = 0,
                    process: str = "static", spread: float = 0.0,
                    bursts: int = 4) -> Optional[np.ndarray]:
    """``(C,)`` per-client arrival delays (simulated seconds) for one round.

    ``None`` (the ``static`` process or ``spread=0``) means everyone is
    ready at the phase start — the legacy timeline, byte-for-byte.
    ``poisson`` draws iid exponential delays with mean ``spread``;
    ``bursty`` assigns each client a stable burst slot (uniform over
    ``bursts``, drawn from ``(seed, client)`` only) and spaces the bursts
    evenly over ``spread`` seconds with a small in-burst jitter — the
    flash-crowd shape heavy-traffic deployments actually see.
    """
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r}; known: "
                         + ", ".join(ARRIVAL_PROCESSES))
    if process == "static" or spread <= 0.0 or num_clients == 0:
        return None
    u = _lane_uniform(seed, num_clients, 0xA881, round_idx)
    if process == "poisson":
        return spread * -np.log1p(-u)
    if bursts < 1:
        raise ValueError(f"arrival_bursts must be >= 1, got {bursts!r}")
    gap = spread / bursts
    slot = np.floor(_lane_uniform(seed, num_clients, 0xB572) * bursts)
    return slot * gap + u * (0.1 * gap)


def online_mask(num_clients: int, round_idx: int, *, seed: int = 0,
                churn: float = 0.0) -> Optional[np.ndarray]:
    """``(C,)`` bool — which clients are online for the whole round.

    ``None`` (``churn=0``) means everyone, the legacy protocol. Each
    client flips its own coin per round, deterministic in
    ``(seed, round, client)``.
    """
    if not 0.0 <= churn < 1.0:
        raise ValueError(f"churn_prob must be in [0, 1), got {churn!r}")
    if churn == 0.0:
        return None
    return _lane_uniform(seed, num_clients, 0x0FF1, round_idx) >= churn


def dropout_mask(num_clients: int, round_idx: int, *, seed: int = 0,
                 dropout: float = 0.0) -> Optional[np.ndarray]:
    """``(C,)`` bool — True where a client drops *mid-round* (it trains but
    its report never reaches the server). ``None`` (``dropout=0``) means
    nobody drops. Deterministic in ``(seed, round, client)``.
    """
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout_prob must be in [0, 1), got {dropout!r}")
    if dropout == 0.0:
        return None
    return _lane_uniform(seed, num_clients, 0xD801, round_idx) < dropout


# ---------------------------------------------------------------------------
# Timeline
# ---------------------------------------------------------------------------

class SimTimeline:
    """Simulated-deployment event clock: client lanes + one serial server.

    ``client_phase``/``server_phase`` advance the timeline by one phase
    node and return the node's simulated completion time (the barrier at
    which every participant of the phase has finished). Callers feed nodes
    in host execution order; per-lane occupancy then encodes the true
    data-dependency order automatically. Lane updates are vectorized
    (``np.maximum`` over the participating lanes) — identical to the
    per-client loop, one numpy op per phase instead of O(C) Python steps.
    """

    def __init__(self, speeds: np.ndarray):
        self.speeds = np.asarray(speeds, np.float64)
        self.client_free = np.zeros((len(self.speeds),), np.float64)
        self.server_free = 0.0

    # ------------------------------------------------- resumable service
    def state_dict(self) -> dict:
        """Lane occupancy, for the resumable service's checkpoint.

        Speeds are not captured: they are a pure function of
        ``(seed, client, straggler_factor)`` and rebuilt at construction.
        """
        return {"client_free": self.client_free.copy(),
                "server_free": float(self.server_free)}

    def load_state_dict(self, sd: dict) -> None:
        lanes = np.asarray(sd["client_free"], np.float64)
        if lanes.shape != self.client_free.shape:
            raise ValueError(
                f"timeline lane-count mismatch: checkpoint {lanes.shape} "
                f"vs fleet {self.client_free.shape}")
        self.client_free = lanes.copy()
        self.server_free = float(sd["server_free"])

    def client_phase(self, participants: Optional[np.ndarray], base_s: float,
                     ready_s: float = 0.0,
                     offsets: Optional[np.ndarray] = None) -> float:
        """All participating clients run the phase in parallel: client ``c``
        starts at ``max(ready_s + its arrival offset, its lane's free
        time)`` and takes ``base_s * speed[c]``. Returns the barrier
        (latest finish); with no participants the phase completes at
        ``ready_s``. ``offsets`` (C,) are per-client arrival delays
        (``arrival_offsets``); ``None`` = everyone ready at ``ready_s``.
        ``base_s`` may also be a (C,) array of per-client base costs
        (heterogeneous-zoo pricing: each cohort's architecture has its own
        phase cost — see the ``"phase@cohort"`` keys of
        ``RoundScheduler.sim_phase_costs``)."""
        if participants is None:
            ids = slice(None)
        else:
            ids = np.flatnonzero(np.asarray(participants, bool))
            if ids.size == 0:
                return ready_s
        ready = ready_s if offsets is None else ready_s + offsets[ids]
        start = np.maximum(ready, self.client_free[ids])
        base = np.asarray(base_s)[ids] if np.ndim(base_s) else base_s
        finish = start + base * self.speeds[ids]
        self.client_free[ids] = finish
        return float(max(ready_s, finish.max())) if finish.size else ready_s

    def server_phase(self, base_s: float, ready_s: float = 0.0) -> float:
        """The server is one serial resource (aggregation runs round by
        round): the phase starts when both the server and its inputs are
        ready and takes ``base_s``."""
        start = max(ready_s, self.server_free)
        self.server_free = start + base_s
        return self.server_free
