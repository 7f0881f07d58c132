"""Partial participation's config check.

The port runs every client every round (sampling and the staleness buffer
are ROADMAP queue A item 6), but it refuses a bad participation config as
the reference does, with ``ValueError``, before anything is built. This is
``repro.fed.participation.validate_config`` and its policy names.
"""
from __future__ import annotations

PARTICIPATION_POLICIES = ("uniform", "weighted", "roundrobin")


def validate_config(cfg) -> None:
    """Fail fast on an inconsistent participation config (FedConfig-like)."""
    f = cfg.participation_fraction
    if not 0.0 < f <= 1.0:
        raise ValueError(
            f"participation_fraction must be in (0, 1], got {f!r}")
    if cfg.participation_policy not in PARTICIPATION_POLICIES:
        raise ValueError(
            f"unknown participation_policy {cfg.participation_policy!r}; "
            f"known: {', '.join(PARTICIPATION_POLICIES)}")
    if not 0.0 <= cfg.staleness_decay <= 1.0:
        raise ValueError(
            f"staleness_decay must be in [0, 1], got {cfg.staleness_decay!r}")
