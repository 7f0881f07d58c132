import importlib.util
import os
import pathlib
import sys

# tests run on CPU; the CI matrix additionally forces a multi-device host
# (XLA_FLAGS=--xla_force_host_platform_device_count=4) so the mesh-sharded
# cohort engine is exercised in-process — see test_cohort_parity.py
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Property tests prefer real hypothesis (requirements-dev.txt); fall back to
# the deterministic shim so `pytest -q` collects out of the box.
try:
    import hypothesis  # noqa: F401
except ImportError:
    _shim_path = pathlib.Path(__file__).parent / "_hypothesis_compat.py"
    _spec = importlib.util.spec_from_file_location("hypothesis", _shim_path)
    _shim = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_shim)
    sys.modules["hypothesis"] = _shim
    sys.modules["hypothesis.strategies"] = _shim.strategies

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
