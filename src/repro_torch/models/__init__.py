"""Client models."""
