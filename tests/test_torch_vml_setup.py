"""``import repro_torch`` sets up MKL's vector math (VML) on one thread
(``src/repro_torch/__init__.py``, ROADMAP C7). In a fresh process that
imports the package, the first parallel ``torch.sqrt`` (16384 float32s,
eight chunks of 2048) is exact to float32 rounding. Without that set-up,
about one such process in nine had a chunk off by ~3e-4 relative
(``tests/_torch_vml_first_call.py``; PERF.md §7)."""
from __future__ import annotations

import importlib.util
import pathlib

_HELPER = pathlib.Path(__file__).resolve().parent / "_torch_vml_first_call.py"


def _helper():
    spec = importlib.util.spec_from_file_location("_torch_vml_first_call",
                                                  _HELPER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_first_parallel_sqrt_after_import_is_exact():
    # without the set-up ~9% of such processes fail (75 of 800): 24
    # processes catch its removal nine times in ten
    recs = _helper().count_first_calls(24, 4, warm="import")
    assert all(r["threads"] > 1 for r in recs), "no parallel first call"
    assert [r for r in recs if r["off"]] == []
