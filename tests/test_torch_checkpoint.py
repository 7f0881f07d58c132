"""The port's checkpoint layer (``repro_torch.checkpoint``): atomic writes,
retention, corruption fallback, the nested-manifest experiment-state
format, and the container the reference's ``repro.checkpoint`` writes,
read and written across the two packages.

The cases of ``tests/test_checkpoint.py`` and the two checkpoint cases of
``tests/test_optim_ckpt.py``, one for one, with torch tensors where the
reference has ``jax.Array``s; the shardings case becomes ``device=``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore_checkpoint
from repro.checkpoint import restore_state as ref_restore_state
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.checkpoint import save_state as ref_save_state
from repro_torch.checkpoint import (checkpoint_steps, latest_step,
                                    restore_checkpoint, restore_state,
                                    save_checkpoint, save_state)
from repro_torch.fed.state import load_rng_state, rng_state_dict


def _ls(d):
    return sorted(os.listdir(d))


def test_atomic_write_leaves_no_orphans(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, {"w": torch.zeros((2,))})
    assert _ls(d) == ["ckpt_00000003.npz"]
    save_state(d, 4, {"x": np.arange(3)})
    assert _ls(d) == ["ckpt_00000003.npz", "ckpt_00000004.npz"]


def test_latest_step_sweeps_stale_tmp_files(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, {"w": torch.zeros(2)})
    for orphan in ("ckpt_00000002.npz.tmp.npz", "ckpt_00000002.npz.tmp"):
        with open(os.path.join(d, orphan), "wb") as f:
            f.write(b"torn write")
    assert latest_step(d) == 1
    assert _ls(d) == ["ckpt_00000001.npz"]


def test_latest_step_missing_dir(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None
    assert checkpoint_steps(str(tmp_path / "nope")) == []


def test_retention_keeps_last_k(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(5):
        save_checkpoint(d, s, {"w": torch.zeros(2)}, keep_last=2)
    assert checkpoint_steps(d) == [3, 4]
    save_state(d, 5, {"x": 1}, keep_last=2)
    assert checkpoint_steps(d) == [4, 5]


def test_corrupt_checkpoint_falls_back_with_warning(tmp_path):
    d = str(tmp_path / "ck")
    save_state(d, 1, {"val": 10, "arr": np.arange(4)})
    save_state(d, 2, {"val": 20, "arr": np.arange(4)})
    path2 = os.path.join(d, "ckpt_00000002.npz")
    with open(path2, "r+b") as f:  # tear the zip central directory
        f.truncate(os.path.getsize(path2) // 2)
    with pytest.warns(UserWarning, match="unreadable"):
        state = restore_state(d, 2, fallback=True)
    assert state["val"] == 10
    np.testing.assert_array_equal(state["arr"], np.arange(4))
    with pytest.raises(Exception):
        restore_state(d, 2, fallback=False)


def test_corrupt_pytree_checkpoint_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    like = {"w": torch.zeros(3)}
    save_checkpoint(d, 1, {"w": torch.arange(3.0)})
    save_checkpoint(d, 2, {"w": torch.arange(3.0) * 2})
    with open(os.path.join(d, "ckpt_00000002.npz"), "wb") as f:
        f.write(b"not a zip at all")
    with pytest.warns(UserWarning, match="unreadable"):
        out = restore_checkpoint(d, 2, like, fallback=True)
    np.testing.assert_array_equal(out["w"], np.arange(3.0))


def test_save_state_roundtrips_nonarray_leaves(tmp_path):
    """Ints beyond 64 bits (PCG64 words), None, bools, strs, nested lists,
    arrays and tensors all round-trip exactly, dtypes kept."""
    d = str(tmp_path / "ck")
    gen = np.random.default_rng(7)
    gen.standard_normal(13)  # advance so the state is nontrivial
    state = {
        "version": 1,
        "cursors": {"round": 42, "edge": [0, 3, None]},
        "big": (1 << 100) + 12345,  # wider than any numpy integer
        "flags": [True, False, None, "sync", 2.5],
        "mask": np.array([True, False, True]),
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "i64": np.arange(4, dtype=np.int64),
        "torch": torch.ones((2, 2)),
        "rng": rng_state_dict(gen),
        "empty": [],
    }
    save_state(d, 0, state)
    out = restore_state(d)
    assert out["version"] == 1 and out["cursors"] == state["cursors"]
    assert out["big"] == state["big"]
    assert out["flags"] == state["flags"]
    assert out["empty"] == []
    for k in ("mask", "f32", "i64"):
        np.testing.assert_array_equal(out[k], state[k])
        assert out[k].dtype == np.asarray(state[k]).dtype
    np.testing.assert_array_equal(out["torch"], np.ones((2, 2)))
    assert out["torch"].dtype == np.float32
    gen2 = np.random.default_rng(0)
    load_rng_state(gen2, out["rng"])
    np.testing.assert_array_equal(gen.standard_normal(5),
                                  gen2.standard_normal(5))


def test_save_state_rejects_bad_structures(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(TypeError, match="keys must be str"):
        save_state(d, 0, {1: "int key"})
    with pytest.raises(TypeError, match="reserved"):
        save_state(d, 0, {"__npz__": "reserved key"})
    with pytest.raises(TypeError, match="unserializable"):
        save_state(d, 0, {"bad": object()})


def test_restore_state_on_pytree_checkpoint_raises(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, {"w": torch.zeros(2)})
    with pytest.raises(KeyError, match="manifest"):
        restore_state(d, 0)


def test_shape_mismatch_message_names_leaf_and_shapes(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, {"layer": {"w": torch.zeros((2, 4))}})
    with pytest.raises(ValueError) as ei:
        restore_checkpoint(d, 0, {"layer": {"w": torch.zeros((3, 4))}})
    msg = str(ei.value)
    assert "shape mismatch" in msg and "layer/w" in msg
    assert "(2, 4)" in msg and "(3, 4)" in msg


def test_missing_leaf_raises_keyerror(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(d, 0, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_restore_with_device_places_tensors(tmp_path):
    """Restore-time placement: with ``device`` every leaf comes back as a
    tensor on it (the reference's shardings); without, as numpy."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(8.0), "n": [torch.arange(3)]}
    save_checkpoint(d, 0, tree)
    like = {"w": torch.zeros(8), "n": [torch.zeros(3, dtype=torch.int64)]}
    out = restore_checkpoint(d, 0, like, device="cpu")
    assert isinstance(out["w"], torch.Tensor)
    assert out["w"].device == torch.device("cpu")
    assert out["n"][0].dtype == torch.int64
    torch.testing.assert_close(out["w"], torch.arange(8.0))
    plain = restore_checkpoint(d, 0, like)
    assert isinstance(plain["w"], np.ndarray)


def test_flaky_writer_retries_then_succeeds(tmp_path, monkeypatch):
    from repro_torch.checkpoint import ckpt

    real_write = ckpt._write_tmp
    calls = {"n": 0}

    def flaky(tmp, arrays):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError(28, "No space left on device (injected)")
        real_write(tmp, arrays)

    sleeps = []
    monkeypatch.setattr(ckpt, "_write_tmp", flaky)
    monkeypatch.setattr(ckpt.time, "sleep", sleeps.append)
    d = str(tmp_path / "ck")
    with pytest.warns(UserWarning, match="retry"):
        save_state(d, 7, {"x": np.arange(3)})
    assert calls["n"] == 3
    assert sleeps == sorted(sleeps) and len(sleeps) == 2  # backoff grows
    assert sleeps[1] > sleeps[0]
    out = restore_state(d, 7)
    np.testing.assert_array_equal(out["x"], np.arange(3))


def test_flaky_writer_exhausts_retries_and_raises(tmp_path, monkeypatch):
    from repro_torch.checkpoint import ckpt

    def always_fail(tmp, arrays):
        raise OSError(30, "Read-only file system (injected)")

    monkeypatch.setattr(ckpt, "_write_tmp", always_fail)
    monkeypatch.setattr(ckpt.time, "sleep", lambda s: None)
    d = str(tmp_path / "ck")
    with pytest.warns(UserWarning, match="retry"):
        with pytest.raises(OSError, match="Read-only"):
            save_state(d, 1, {"x": np.arange(3)})
    assert latest_step(d) is None  # sweeps any tmp litter, finds nothing


# ---- tests/test_optim_ckpt.py's two checkpoint cases

def test_checkpoint_roundtrip(tmp_path):
    tree = {"layer": {"w": torch.arange(6.0).reshape(2, 3),
                      "b": torch.zeros(3)},
            "step": torch.tensor(7, dtype=torch.int32)}
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, tree)
    assert latest_step(d) == 3
    like = {"layer": {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
            "step": torch.tensor(0, dtype=torch.int32)}
    out = restore_checkpoint(d, 3, like, device="cpu")
    for k in ("w", "b"):
        assert torch.equal(out["layer"][k], tree["layer"][k])
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, 0, {"w": torch.zeros((3, 3))})


# ---- the container across packages

def test_reference_and_port_read_each_others_state(tmp_path):
    """One container on disk: a state the reference writes loads in the
    port, and the other way round, big ints, arrays and nesting alike."""
    gen = np.random.default_rng(3)
    gen.integers(0, 9, 11)
    state = {"version": 1, "big": (1 << 90) + 7,
             "rng": gen.bit_generator.state,
             "nested": [{"a": np.arange(5, dtype=np.int64)}, None, "s"],
             "f": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3)}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_save_state(ref_dir, 2, state)
    save_state(port_dir, 2, dict(state, f=torch.from_numpy(state["f"])))
    for got in (restore_state(ref_dir, 2), ref_restore_state(port_dir, 2)):
        assert got["big"] == state["big"] and got["rng"] == state["rng"]
        assert got["nested"][1:] == [None, "s"]
        np.testing.assert_array_equal(got["nested"][0]["a"], np.arange(5))
        np.testing.assert_array_equal(got["f"], state["f"])
        assert got["f"].dtype == np.float32


def test_reference_and_port_read_each_others_pytrees(tmp_path):
    """The array-pytree format's '/'-joined leaf names are the same: a
    reference checkpoint restores into a port like-tree and back."""
    ref_tree = {"layers": [{"w": jnp.arange(6.0).reshape(2, 3),
                            "b": jnp.ones(3)}], "step": jnp.int32(4)}
    ref_save_checkpoint(str(tmp_path / "r"), 0, ref_tree)
    like = {"layers": [{"w": torch.zeros(2, 3), "b": torch.zeros(3)}],
            "step": torch.tensor(0, dtype=torch.int32)}
    out = restore_checkpoint(str(tmp_path / "r"), 0, like, device="cpu")
    assert torch.equal(out["layers"][0]["w"], torch.arange(6.0).reshape(2, 3))
    save_checkpoint(str(tmp_path / "p"), 0, out)
    back = ref_restore_checkpoint(str(tmp_path / "p"), 0, ref_tree)
    np.testing.assert_array_equal(np.asarray(back["layers"][0]["w"]),
                                  np.arange(6.0).reshape(2, 3))
    assert int(back["step"]) == 4
