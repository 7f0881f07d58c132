"""Synthetic feature datasets, non-IID partitioners and the proxy set."""
