"""Package boundaries and the entry point of the port (``repro_torch``).

* The port stands alone: no module under ``src/repro_torch/`` imports
  ``jax``, ``jaxlib`` or anything of the JAX package ``repro``.
* ``repro_torch.launch.fed_train`` runs on the card unless asked for the
  CPU, raises without a card, runs the feature, image and token datasets,
  the cohort engine (with the mixed zoo and wave streaming) and every
  scheduler flag (overlap, partial participation, churn, dropout,
  admission, concurrent cohorts), and refuses every flag whose feature is
  not ported yet with ``NotImplementedError`` naming its ROADMAP item.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
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


@pytest.mark.parametrize("method", ["server_distill", "selective-fd"])
def test_fed_train_runs_the_table_iii_methods(method, capsys):
    res = fed_train.main(SMALL + ["--device", "cpu", "--method", method])
    log = res.rounds[0]
    assert res.method == method and 0.0 <= log.mean_acc <= 1.0
    out = capsys.readouterr().out
    if method == "server_distill":
        assert "server_distill" in log.phase_s
        assert log.server_student_acc is not None and "student=" in out
    else:
        assert 0.0 < log.id_fraction < 1.0


def test_fed_train_runs_lm_tokens_on_the_cpu():
    """The transformer scenario through the entry point: reduced granite
    clients, the KMeans-DRE filter on raw token ids."""
    res = fed_train.main(SMALL + ["--device", "cpu", "--dataset", "lm_tokens",
                                  "--proxy-batch", "32"])
    log = res.rounds[0]
    assert set(log.phase_s) == {"local_train", "report", "aggregate",
                                "distill", "eval"}
    assert 0.0 < log.id_fraction <= 1.0 and log.bytes_up > 0
    assert log.local_loss == log.local_loss and log.distill_loss > 0.0


@pytest.mark.parametrize("dataset", ["mnist_like", "fashion_like",
                                     "cifar_like"])
def test_fed_train_runs_the_image_datasets_on_the_cpu(dataset):
    """The image path through the entry point: the Tables I/II CNN zoo,
    the KMeans-DRE filter on flattened NHWC images."""
    res = fed_train.main(SMALL + ["--device", "cpu", "--dataset", dataset,
                                  "--proxy-batch", "32"])
    log = res.rounds[0]
    assert set(log.phase_s) == {"local_train", "report", "aggregate",
                                "distill", "eval"}
    assert 0.0 < log.id_fraction <= 1.0 and log.bytes_up > 0
    assert 0.0 <= log.mean_acc <= 1.0 and len(log.accs) == 2
    assert log.local_loss > 0.0 and log.distill_loss > 0.0


@pytest.mark.parametrize("flags", [
    ["--engine", "cohort"],
    ["--zoo", "mixed", "--clients", "3"],
    ["--engine", "cohort", "--zoo", "mixed", "--clients", "6",
     "--wave-size", "1"],
    ["--engine", "cohort", "--wave-size", "4", "--clients", "6"]],
    ids=["cohort", "mixed-zoo-loop", "cohort-mixed-waves-of-1",
         "cohort-waves-of-4"])
def test_fed_train_runs_the_cohort_engine_on_the_cpu(flags):
    """The cohort engine, the mixed MLP zoo and wave streaming through the
    entry point (the refusals they replace named ROADMAP item 5)."""
    res = fed_train.main(SMALL + ["--device", "cpu"] + flags)
    log = res.rounds[0]
    assert set(log.phase_s) == {"local_train", "report", "aggregate",
                                "distill", "eval"}
    assert 0.0 < log.id_fraction <= 1.0 and log.bytes_up > 0
    assert log.local_loss > 0.0 and log.distill_loss > 0.0


def test_wave_size_needs_the_cohort_engine():
    with pytest.raises(ValueError, match="wave_size requires engine='cohort'"):
        fed_train.main(SMALL + ["--device", "cpu", "--wave-size", "4"])


def test_cohort_phase_refuses_participants():
    """``phase_distill(..., participants=...)`` trains the participants and
    leaves a sampled-out lane bitwise as it was; a mask of the wrong
    length is refused."""
    from repro_torch.common.types import FedConfig
    from repro_torch.fed import simulator
    from repro_torch.fed.cohort import CohortEngine
    clients, *_ = simulator.build_experiment(
        FedConfig(num_clients=2, rounds=1, engine="cohort"), n_train=200,
        n_test=50, device="cpu")
    engine = CohortEngine(clients)
    cohort = engine.cohorts[0]
    before = [p.detach().clone() for p in cohort.params]
    rng = np.random.default_rng(0)
    args = (rng.standard_normal((8, 50)).astype(np.float32),
            rng.standard_normal((8, 10)).astype(np.float32),
            np.ones(8, np.float32), 1, 4)
    losses = engine.phase_distill(*args, participants=[True, False])
    assert losses[0] > 0.0 and losses[1] == 0.0
    assert all(torch.equal(p[1], q[1]) for p, q in zip(cohort.params, before))
    assert not torch.equal(cohort.params[0][0], before[0][0])
    with pytest.raises(ValueError, match="participation mask shape"):
        engine.phase_distill(*args, participants=[True, False, True])


SCHED_FIELDS = ("participants", "mean_staleness", "sim_finish_s",
                "served_model_age_s")


@pytest.mark.parametrize("flags", [
    ["--round-mode", "overlap", "--rounds", "3"],
    ["--participation", "0.5", "--staleness-decay", "0.5"],
    ["--participation", "0.5", "--policy", "roundrobin", "--engine",
     "cohort", "--round-mode", "overlap", "--rounds", "2"],
    ["--churn", "0.3", "--rounds", "2"],
    ["--dropout", "0.3", "--engine", "cohort"],
    ["--max-pending-reports", "1", "--round-mode", "overlap", "--rounds",
     "2"],
    ["--concurrent-cohorts", "--engine", "cohort", "--zoo", "mixed",
     "--clients", "3"],
    ["--participation", "0.5", "--policy", "weighted", "--arrival-process",
     "bursty", "--arrival-spread", "2"]],
    ids=["overlap", "participation", "roundrobin-cohort-overlap", "churn",
         "dropout-cohort", "max-pending-reports", "concurrent-cohorts",
         "weighted-bursty"])
def test_scheduler_flags_run_on_the_cpu(flags, tmp_path):
    """Each scheduler flag (refused before the full scheduler was ported)
    runs ``fed_train`` to its end, and ``--json`` carries the round's
    participants, staleness, simulated finish and served-model age."""
    out = tmp_path / "run.json"
    res = fed_train.main(SMALL + ["--device", "cpu", "--json", str(out)]
                         + flags)
    rounds = json.loads(out.read_text())["rounds"]
    assert len(rounds) == len(res.rounds) >= 1
    for r, log in zip(rounds, res.rounds):
        assert all(f in r for f in SCHED_FIELDS)
        assert r["sim_finish_s"] == log.sim_finish_s > 0.0
        assert r["participants"] == log.participants
    if "--participation" in flags or "--max-pending-reports" in flags:
        assert all(r["participants"] is not None for r in rounds)


@pytest.mark.parametrize("flags,item", [
    (["--engine", "cohort", "--dataset", "lm_tokens"], "item 5"),
    (["--engine", "cohort", "--devices", "2"], "item 10"),
    (["--engine", "cohort", "--model-shards", "2"], "item 10"),
    (["--devices", "2"], "item 10"),
    (["--watchdog"], "item 8"),
    (["--watchdog", "--engine", "cohort", "--fault-mode", "nan"], "item 8"),
])
def test_flags_outside_the_slice_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A {item}"):
        fed_train.main(SMALL + ["--device", "cpu"] + flags)


ROBUST_FLAGS = {
    **{f"fault-{m}": ["--fault-mode", m, "--byzantine-frac", "0.5",
                      "--fault-prob", "0.2"]
       for m in ("nan", "random_logits", "scaled", "colluding_flip",
                 "stale_replay")},
    **{f"robust-{r}": ["--robust-aggregation", r, "--fault-mode",
                       "colluding_flip", "--byzantine-frac", "0.34"]
       for r in ("trimmed_mean", "median", "krum_row")},
    "edges": ["--edge-aggregators", "2", "--participation", "0.67",
              "--staleness-decay", "0.5"],
    "quarantine": ["--quarantine-threshold", "1.5", "--fault-mode",
                   "scaled", "--byzantine-frac", "0.34", "--trim-frac",
                   "0.3", "--robust-aggregation", "trimmed_mean"],
}


@pytest.mark.parametrize("engine", ["loop", "cohort"])
@pytest.mark.parametrize("name", list(ROBUST_FLAGS))
def test_robustness_flags_run_on_the_cpu(name, engine, tmp_path, capsys):
    """Each robustness flag (refused before the server was ported at full
    size) runs ``fed_train`` to its end on both engines; a nan attack's
    scrubbed rows reach the round line."""
    out = tmp_path / "run.json"
    res = fed_train.main(["--clients", "3", "--rounds", "2", "--n-train",
                          "300", "--n-test", "50", "--proxy-batch", "64",
                          "--device", "cpu", "--engine", engine, "--json",
                          str(out)] + ROBUST_FLAGS[name])
    rounds = json.loads(out.read_text())["rounds"]
    assert len(rounds) == len(res.rounds) == 2
    assert all(np.isfinite(r.local_loss) for r in res.rounds)
    if name == "fault-nan":
        assert all(r["scrubbed_rows"] > 0 for r in rounds)
        assert "scrubbed=" in capsys.readouterr().out
