"""Package boundaries and the entry point of the port (``repro_torch``).

* The port stands alone: no module under ``src/repro_torch/`` imports
  ``jax``, ``jaxlib`` or anything of the JAX package ``repro``.
* ``repro_torch.launch.fed_train`` runs on the card unless asked for the
  CPU, raises without a card, and refuses every flag whose feature is not
  ported yet with ``NotImplementedError`` naming its ROADMAP item.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import fed_train

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

SMALL = ["--clients", "2", "--rounds", "1", "--n-train", "200",
         "--n-test", "50"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_module_imports_jax_or_the_reference_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = [f"{f.relative_to(PKG)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(("repro_torch",) + f.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__") for f in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_fed_train_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_train.main(SMALL)


def test_fed_train_runs_on_the_cpu_when_asked(tmp_path, capsys):
    out = tmp_path / "run.json"
    res = fed_train.main(SMALL + ["--device", "cpu", "--scenario", "weak",
                                  "--json", str(out)])
    assert len(res.rounds) == 1
    log = res.rounds[0]
    assert 0.0 <= log.mean_acc <= 1.0 and len(log.accs) == 2
    assert set(log.phase_s) == {"local_train", "report", "aggregate",
                                "distill", "eval"}
    assert log.bytes_up > 0 and log.bytes_down > 0
    assert "round   0" in capsys.readouterr().out
    assert out.exists()


@pytest.mark.parametrize("flags,item", [
    (["--engine", "cohort"], "item 5"),
    (["--zoo", "mixed"], "item 5"),
    (["--wave-size", "4"], "item 5"),
    (["--devices", "2"], "item 10"),
    (["--round-mode", "overlap"], "item 6"),
    (["--participation", "0.5"], "item 6"),
    (["--churn", "0.1"], "item 6"),
    (["--dropout", "0.1"], "item 6"),
    (["--max-pending-reports", "4"], "item 6"),
    (["--concurrent-cohorts"], "item 6"),
    (["--fault-mode", "nan"], "item 7"),
    (["--edge-aggregators", "2"], "item 7"),
    (["--robust-aggregation", "median"], "item 7"),
    (["--quarantine-threshold", "1.5"], "item 7"),
    (["--watchdog"], "item 7"),
    (["--dataset", "mnist_like"], "item 4"),
    (["--dataset", "lm_tokens"], "item 9"),
    (["--method", "fedmd"], "item 4"),
    (["--method", "selective-fd"], "item 4"),
])
def test_flags_outside_the_slice_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A {item}"):
        fed_train.main(SMALL + ["--device", "cpu"] + flags)
