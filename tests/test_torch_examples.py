"""``examples_torch/``: the reference's five example scripts on the port.

``train_100m.py --tiny --steps 3 --device cpu`` runs in-process and its
checkpoint loads into the reference's parameter tree; the other four are
imported without running (each runs behind ``if __name__ ==
"__main__"``), and their scenario constants (clients, rounds, sizes,
methods, datasets, thresholds) equal the reference scripts', read from
``examples/`` with ``ast`` without executing them. Nothing under
``examples_torch/`` or ``src/repro_torch/``, nor ``chip_smoke.py``,
imports ``jax`` or the reference package.
"""
import ast
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REF = os.path.join(ROOT, "examples")
PORT = os.path.join(ROOT, "examples_torch")
torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("quickstart", "edgefd_vs_baselines", "fd_transformers",
         "fed_shardmap", "train_100m")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(PORT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(name):
    with open(os.path.join(REF, f"{name}.py")) as f:
        return ast.parse(f.read())


def _assigns(tree) -> dict:
    """Module-level ``NAME = literal`` and ``A, B = literals``."""
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            if isinstance(t, ast.Name):
                out[t.id] = value
            elif isinstance(t, ast.Tuple):
                out.update(zip((e.id for e in t.elts), value))
    return out


def _call(tree, name):
    """The first call of a function or method named ``name``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if getattr(f, "attr", getattr(f, "id", None)) == name:
                return node
    raise AssertionError(f"no call of {name}")


def _keywords(call, names: dict) -> dict:
    """A call's keywords as values: literals, module constants
    (``names``), and ``a if cond else b`` as ``a`` (the branch a host
    with enough devices takes)."""
    out = {}
    for kw in call.keywords:
        v = kw.value
        if isinstance(v, ast.IfExp):
            v = v.body
        if isinstance(v, ast.Name):
            if v.id in names:
                out[kw.arg] = names[v.id]
            continue
        try:
            out[kw.arg] = ast.literal_eval(v)
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("name", NAMES)
def test_each_script_imports_without_running_and_has_a_main(name):
    mod = _load(name)
    assert callable(mod.main)


def test_quickstart_is_the_references_scenario():
    tree = _tree("quickstart")
    mod = _load("quickstart")
    assert _keywords(_call(tree, "FedConfig"), {}) == mod.CONFIG
    run = _call(tree, "run")
    assert _keywords(run, {}) == {"dataset_name": mod.DATASET,
                                  "n_train": mod.N_TRAIN,
                                  "n_test": mod.N_TEST}


def test_edgefd_vs_baselines_is_the_references_scenario():
    tree = _tree("edgefd_vs_baselines")
    mod = _load("edgefd_vs_baselines")
    consts = _assigns(tree)
    assert consts["ROUNDS"] == mod.ROUNDS
    loop = next(n for n in ast.walk(tree) if isinstance(n, ast.For))
    assert ast.literal_eval(loop.iter) == mod.METHODS
    assert _keywords(_call(tree, "FedConfig"), consts) == mod.CONFIG
    run = _call(tree, "run")
    assert ast.literal_eval(run.args[1]) == mod.DATASET
    assert _keywords(run, {}) == {"n_train": mod.N_TRAIN,
                                  "n_test": mod.N_TEST}


def test_fd_transformers_is_the_references_scenario():
    tree = _tree("fd_transformers")
    mod = _load("fd_transformers")
    kw = _keywords(_call(tree, "FedConfig"), {})
    assert (kw.pop("num_devices"), kw.pop("model_shards")) == (
        mod.MESH_RANKS, mod.MODEL_SHARDS)
    assert kw == mod.CONFIG
    run = _call(tree, "run")
    assert ast.literal_eval(run.args[1]) == mod.DATASET
    assert _keywords(run, {}) == {"n_train": mod.N_TRAIN,
                                  "n_test": mod.N_TEST}


def test_fed_shardmap_is_the_references_scenario():
    tree = _tree("fed_shardmap")
    mod = _load("fed_shardmap")
    consts = _assigns(tree)
    assert {k: consts[k] for k in ("C", "T", "K", "DIM")} == \
        {"C": mod.C, "T": mod.T, "K": mod.K, "DIM": mod.DIM}
    full = _call(tree, "full")
    assert ast.literal_eval(full.args[1]) == mod.THRESHOLD
    # the same tolerances on the psum teacher against the hub's
    close = _call(tree, "assert_allclose")
    assert _keywords(close, {}) == {"rtol": 1e-5, "atol": 1e-6}


def test_train_100m_is_the_references_config():
    tree = _tree("train_100m")
    mod = _load("train_100m")
    cfg = _keywords(_call(tree, "ArchConfig"), {})
    cfg.pop("attention", None)
    assert {k: getattr(mod.CONFIG_100M, k) for k in cfg} == cfg
    assert mod.CONFIG_100M.attention.name == "FULL"
    tiny = _keywords(_call(tree, "replace"), {})
    assert tiny == mod.TINY
    ref_flags = {ast.literal_eval(c.args[0]): _keywords(c, {}).get("default")
                 for c in ast.walk(tree) if isinstance(c, ast.Call)
                 and getattr(c.func, "attr", "") == "add_argument"}
    with open(os.path.join(PORT, "train_100m.py")) as f:
        ptree = ast.parse(f.read())
    port_flags = {ast.literal_eval(c.args[0]): _keywords(c, {}).get(
        "default") for c in ast.walk(ptree) if isinstance(c, ast.Call)
        and getattr(c.func, "attr", "") == "add_argument"}
    for flag in ("--steps", "--batch", "--seq", "--lr", "--tiny"):
        assert port_flags[flag] == ref_flags[flag], flag
    assert "--ckpt-dir" in port_flags and port_flags["--device"] == "cuda"


def test_train_100m_tiny_runs_on_the_cpu_and_its_checkpoint_loads(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.transformer import Transformer
    mod = _load("train_100m")
    first, last, path = mod.main(["--tiny", "--steps", "3", "--device",
                                  "cpu", "--ckpt-dir", str(tmp_path)])
    assert last < first and os.path.exists(path)
    cfg = dataclasses.replace(mod.CONFIG_100M, **mod.TINY)
    like = Transformer(cfg).jax_params()
    tree = restore_checkpoint(str(tmp_path), 3, like)
    flat = [np.asarray(v) for v in _leaves(tree)]
    assert [a.shape for a in flat] == [np.shape(v) for v in _leaves(like)]
    assert all(np.isfinite(a).all() for a in flat)
    assert not all(np.array_equal(a, np.asarray(b))
                   for a, b in zip(flat, _leaves(like)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_port_imports_neither_jax_nor_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in (PORT, os.path.join(ROOT, "src", "repro_torch")):
        for d, _, names in os.walk(top):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, bad
