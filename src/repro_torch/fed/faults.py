"""Payload-fault injection's config check.

Fault injection itself is ROADMAP queue A item 7; the port already refuses
a malformed fault config as the reference does, with ``ValueError``, from
``scheduler.validate_config``. This is
``repro.fed.faults.validate_fault_config`` and its mode names.
"""
from __future__ import annotations

FAULT_MODES = ("none", "nan", "random_logits", "scaled", "colluding_flip",
               "stale_replay")


def validate_fault_config(mode: str, fault_prob: float, byzantine_frac: float,
                          fault_start: int, fault_duration: int) -> None:
    if mode not in FAULT_MODES:
        raise ValueError(
            f"fault_mode must be one of {FAULT_MODES}, got {mode!r}")
    if not 0.0 <= fault_prob < 1.0:
        raise ValueError(f"fault_prob must be in [0, 1), got {fault_prob!r}")
    if not 0.0 <= byzantine_frac <= 1.0:
        raise ValueError(
            f"byzantine_frac must be in [0, 1], got {byzantine_frac!r}")
    if fault_start < 0:
        raise ValueError(f"fault_start must be >= 0, got {fault_start!r}")
    if fault_duration < 0:
        raise ValueError(
            f"fault_duration must be >= 0 (0 = unbounded), "
            f"got {fault_duration!r}")
