"""The port's ``fed/mesh.py`` against ``tests/test_mesh.py``, case by case.

Mesh construction, padding, placement and engine wiring in one process (a
world of one rank, where every collective is the identity; a 2x2 layout
is built as rank 0 of it without a process group). Where a helper needs
no devices, the reference's own function runs beside the port's on the
same input. Multi-rank runs are in ``tests/test_torch_mesh_parity.py``.
"""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.fed import mesh as RM
from repro_torch.common.types import FedConfig
from repro_torch.fed import mesh as M
from repro_torch.fed import simulator

torch.set_num_threads(min(2, torch.get_num_threads()))


def test_build_client_mesh_zero_is_off():
    assert M.build_client_mesh(0) is None


def test_build_client_mesh_single_device():
    m = M.build_client_mesh(1, axis="clients")
    assert m.axis_names == ("clients",)
    assert m.devices.size == 1


def test_build_client_mesh_all_devices():
    m = M.build_client_mesh(-1)
    assert m.devices.size == M.world_size() == 1


def test_build_client_mesh_too_many_devices_is_legible():
    with pytest.raises(ValueError, match="torch.distributed.run"):
        M.build_client_mesh(M.world_size() + 1)


def test_padded_size():
    class FakeMesh:                     # only .devices.shape is read
        devices = np.zeros(4)

    for mod in (M, RM):
        assert mod.padded_size(8, None) == 8
        assert mod.padded_size(5, FakeMesh) == 8
        assert mod.padded_size(8, FakeMesh) == 8
        assert mod.padded_size(1, FakeMesh) == 4


def test_shard_and_replicate_placement():
    m = M.build_client_mesh(1)
    tree = {"a": np.arange(8.0).reshape(4, 2), "b": np.arange(4)}
    sharded = M.shard_clients(tree, m)
    np.testing.assert_array_equal(sharded["a"].numpy(), tree["a"])
    assert sharded["a"].device == m.device
    rep = M.replicate(tree, m)
    np.testing.assert_array_equal(rep["b"].numpy(), tree["b"])
    # no mesh: both placements are the identity
    assert M.shard_clients(tree, None) is tree
    assert M.replicate(tree, None) is tree


def _clients(n: int = 2) -> list:
    """A small real client list (mnist_feat, on the CPU)."""
    clients, *_ = simulator.build_experiment(
        FedConfig(num_clients=n, rounds=1), "mnist_feat", n_train=120,
        n_test=40, device="cpu")
    return clients


def test_loop_engine_rejects_num_devices():
    from repro_torch.core.protocol import as_engine
    with pytest.raises(ValueError, match="cohort"):
        as_engine(_clients(), "loop", num_devices=2)


def test_prebuilt_meshless_engine_with_num_devices_warns():
    from repro_torch.core.protocol import LoopEngine, as_engine
    engine = LoopEngine(_clients())
    with pytest.warns(UserWarning, match="pre-built"):
        assert as_engine(engine, "cohort", num_devices=2) is engine


def test_single_device_mesh_parity():
    """num_devices=1 runs the mesh code path (lane placement, gathers,
    per-lane DRE sharing) in a world of one and reproduces the unsharded
    cohort logs bit for bit."""
    logs = {}
    for nd in (0, 1):
        cfg = FedConfig(num_clients=3, rounds=1, method="edgefd",
                        scenario="strong", proxy_batch=60, batch_size=32,
                        lr=1e-2, seed=0, engine="cohort", num_devices=nd)
        logs[nd] = simulator.run(cfg, "mnist_feat", n_train=400, n_test=200,
                                 device="cpu")
    for a, b in zip(logs[0].rounds, logs[1].rounds):
        assert a.accs == b.accs
        assert a.local_loss == b.local_loss
        assert a.distill_loss == b.distill_loss
        assert a.id_fraction == b.id_fraction


# ------------------------------------------------- 2-D (clients, model)

def test_build_client_mesh_2d_shape():
    """model_shards folds the same ranks into (clients, model); here as
    rank 0 of a 2x2 layout, and model_shards=1 is the 1-D mesh."""
    m = M.ClientMesh((2, 2), ("clients", "model"))
    assert m.axis_names == ("clients", "model")
    assert m.devices.shape == (2, 2)
    assert M.client_axis_size(m) == 2
    assert M.model_axis_name(m) == "model"
    assert m.coords == (0, 0)
    m1 = M.build_client_mesh(1, model_shards=1)
    assert m1.axis_names == ("clients",)
    assert M.model_axis_name(m1) is None


def test_model_shards_is_off_on_1d_mesh():
    m = M.build_client_mesh(1)
    assert m.axis_names == ("clients",)
    assert M.model_axis_name(m) is None
    assert M.model_axis_name(None) is None
    assert M.client_axis_size(None) == 1


def test_model_shards_without_mesh_raises():
    with pytest.raises(ValueError, match="requires a device mesh"):
        M.build_client_mesh(0, model_shards=2)


def test_model_shards_nondivisible_raises():
    with pytest.raises(ValueError, match="cannot tile"):
        M.build_client_mesh(1, model_shards=3)


def test_too_many_devices_error_mentions_product():
    with pytest.raises(ValueError, match="TOTAL devices"):
        M.build_client_mesh(M.world_size() + 2, model_shards=2)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        M.build_client_mesh(M.world_size() + 2, model_shards=2)


def test_env_model_shards_is_clamped_not_fatal(monkeypatch):
    monkeypatch.setenv(M.MODEL_SHARDS_ENV, "3")
    m = M.build_client_mesh(1)          # gcd(1, 3) == 1 -> no model axis
    assert m.devices.shape == (1,)
    assert m.axis_names == ("clients",)
    assert M.build_client_mesh(0) is None


def test_resolve_model_shards_validation(monkeypatch):
    for mod in (M, RM):
        with pytest.raises(ValueError, match=">= 0"):
            mod.resolve_model_shards(-1)
    monkeypatch.setenv(M.MODEL_SHARDS_ENV, "nope")
    for mod in (M, RM):
        with pytest.raises(ValueError, match="not an integer"):
            mod.resolve_model_shards(0)
    monkeypatch.setenv(M.MODEL_SHARDS_ENV, "2")
    for mod in (M, RM):
        assert mod.resolve_model_shards(0) == 2
        assert mod.resolve_model_shards(4) == 4   # explicit beats env


def test_model_logical_rules_are_the_references():
    assert M.MODEL_LOGICAL_RULES == RM.MODEL_LOGICAL_RULES
    assert (M.DEFAULT_CLIENT_AXIS, M.DEFAULT_MODEL_AXIS,
            M.MODEL_SHARDS_ENV) == (RM.DEFAULT_CLIENT_AXIS,
                                    RM.DEFAULT_MODEL_AXIS,
                                    RM.MODEL_SHARDS_ENV)


def test_build_mesh_validates_shape():
    with pytest.raises(ValueError, match="axis names"):
        M.build_mesh((1, 1), ("clients",))
    with pytest.raises(ValueError, match="positive"):
        M.build_mesh((0,), ("clients",))


def test_padded_size_uses_client_axis_only():
    class Fake2D:                       # only .devices.shape is read
        devices = np.zeros((2, 2))

    for mod in (M, RM):
        assert mod.padded_size(5, Fake2D) == 6
        assert mod.padded_size(2, Fake2D) == 2


def test_stacked_state_shardings_1d_is_client_split():
    m = M.build_client_mesh(1)
    tree = {"w": np.zeros((4, 8, 6)), "b": np.zeros((4, 6)),
            "step": np.zeros(())}
    sh = M.stacked_state_shardings(tree, m)
    assert sh["w"] == tuple(JP("clients")) == ("clients",)
    assert sh["b"] == ("clients",)
    assert sh["step"] == tuple(JP()) == ()


def test_stacked_state_shardings_2d_splits_model_dims():
    """On a 2x2 layout a stacked transformer tree gets client x model
    specs: wq heads -> model, embed vocab -> model, scalars whole."""
    m = M.ClientMesh((2, 2), ("clients", "model"))
    C, L = 2, 2
    tree = {"embed": np.zeros((C, 32, 64)),
            "blocks": {"wq": np.zeros((C, L, 64, 4, 16)),
                       "bq": np.zeros((C, L, 4, 16))},
            "step": np.zeros(())}
    sh = M.stacked_state_shardings(tree, m)
    assert sh["embed"] == tuple(JP("clients", "model"))
    assert sh["blocks"]["wq"] == tuple(JP("clients", None, None, "model"))
    assert sh["step"] == tuple(JP())


def test_shard_stacked_state_places_this_ranks_block():
    """Rank 0 of a 2x2 layout holds client row 0 and the first model half
    of the leaf's largest dim."""
    m = M.ClientMesh((2, 2), ("clients", "model"))
    tree = {"w": np.arange(2 * 8 * 4, dtype=np.float32).reshape(2, 8, 4)}
    placed = M.shard_stacked_state(tree, m)
    spec = M.stacked_state_shardings(tree, m)["w"]
    assert spec == ("clients", "model")
    np.testing.assert_array_equal(placed["w"].numpy(), tree["w"][:1, :4])
    assert M.shard_stacked_state(tree, None) is tree


def test_mesh_request_outside_the_launcher_raises_legibly():
    """A run that asks for two ranks in a world of one names the
    launcher, before any client is built."""
    cfg = FedConfig(num_clients=2, rounds=1, engine="cohort", num_devices=2)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        simulator.run(cfg, n_train=200, n_test=50, device="cpu")


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    """More ranks on a host than cards under NCCL: refused, naming the
    gloo setting (never a silent switch of backend)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.delenv(M.BACKEND_ENV, raising=False)
    with pytest.raises(ValueError, match="REPRO_DIST_BACKEND=gloo"):
        M.init_distributed("cuda")
    assert not torch.distributed.is_initialized()


def test_fed_train_runs_under_the_launcher(tmp_path):
    """``fed_train --engine cohort --devices 2 --model-shards 2`` under
    ``python -m torch.distributed.run`` (two CPU ranks over gloo): rank 0
    alone prints the rounds and writes ``--json``."""
    import json
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop(M.MODEL_SHARDS_ENV, None)
    out = tmp_path / "run.json"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.fed_train",
         "--device", "cpu", "--engine", "cohort", "--devices", "2",
         "--model-shards", "2", "--dataset", "lm_tokens", "--clients", "3",
         "--rounds", "1", "--n-train", "150", "--n-test", "60",
         "--proxy-batch", "32", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("round   0") == 1, res.stdout
    rounds = json.loads(out.read_text())["rounds"]
    assert len(rounds) == 1 and len(rounds[0]["accs"]) == 3
