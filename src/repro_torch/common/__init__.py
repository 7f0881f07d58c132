"""Typed configuration and parameter-init helpers."""
