"""Checkpointing: flat-pytree .npz + a nested-manifest experiment-state format.

The counterpart of ``repro.checkpoint.ckpt``, the same on disk: a file
written by either package loads in the other. Two layers share one
container, a ``ckpt_<step:08d>.npz`` per step:

``save_checkpoint`` / ``restore_checkpoint``
    The array-pytree format: nested dicts, lists and tuples of tensors or
    arrays, leaves addressed by '/'-joined paths (dict keys, list indices
    as ``str(i)``); restore rebuilds the structure of a caller-supplied
    ``like_tree`` (shape-checked, cast to the like-leaf's dtype) and, with
    ``device=``, places every leaf on that device as a tensor.

``save_state`` / ``restore_state``
    The experiment-state format (``repro_torch.fed.state.ExperimentState``):
    arbitrary nesting of dicts (string keys), lists, tensors, numpy arrays
    and plain scalars — ints of any width (rng bit-generator words),
    floats, strs, bools, None. Tensors and arrays land as npz entries
    (a tensor as ``t.detach().cpu().numpy()``); everything else goes into
    an embedded JSON manifest under ``__state_manifest__`` that records the
    nesting, ``{"__npz__": path}`` marking an array, so restore needs no
    ``like_tree`` and returns plain dicts, lists and numpy arrays.

Both writers go through one atomic path: write to a ``<final>.tmp.npz``
sibling, fsync the file and the directory, then ``os.replace`` onto the
final name, retrying a transient ``OSError`` with backoff. A crash
mid-write leaves only a ``*.tmp*`` orphan, which ``latest_step`` sweeps.
``keep_last=K`` prunes old steps after each save, and both restore entry
points can fall back step by step past an unreadable file; a structural
error (a missing leaf, a shape mismatch) always raises.
"""
from __future__ import annotations

import json
import os
import re
import time
import warnings
import zipfile
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# manifest marker for an array leaf (the value is the npz entry name);
# a dict key equal to this is reserved
_ARRAY_REF = "__npz__"
_MANIFEST_KEY = "__state_manifest__"

# errors that mean "this checkpoint file is unreadable" (truncated zip,
# torn write, bad CRC), as opposed to structural errors, which raise
_CORRUPT_ERRORS = (zipfile.BadZipFile, EOFError, OSError, zlib.error,
                   ValueError, KeyError)


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's flatten order: dict keys
    sorted, list and tuple entries by index; ``None`` is an empty
    subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """Flatten a nested tree to ``{'/'-joined path: np.ndarray}``."""
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _np_dtype(like) -> np.dtype:
    if isinstance(like, torch.Tensor):
        return torch.empty((), dtype=like.dtype).numpy().dtype
    return np.asarray(like).dtype


def unflatten_like(flat: Dict[str, np.ndarray], like_tree, device=None,
                   *, source: str = "ckpt") -> Any:
    """Rebuild ``like_tree``'s structure from a flat ``{path: array}`` dict.

    Shapes are checked against ``like_tree`` (a mismatch is a structural
    error and always raises) and dtypes cast to the like-leaf's. Leaves
    come back as numpy arrays, or, with ``device``, as tensors on it."""
    def build(like, prefix):
        if isinstance(like, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            out = [build(v, prefix + (str(i),)) for i, v in enumerate(like)]
            return out if isinstance(like, list) else tuple(out)
        if like is None:
            return None
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError(f"{source} is missing leaf {key!r}")
        arr = np.asarray(flat[key])
        shape = tuple(like.shape) if isinstance(like, torch.Tensor) \
            else np.shape(like)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch at {key}: {source} "
                             f"{arr.shape} vs model {tuple(shape)}")
        arr = arr.astype(_np_dtype(like))
        return arr if device is None else torch.tensor(arr, device=device)
    return build(like_tree, ())


# ---------------------------------------------------------------------------
# Atomic container I/O
# ---------------------------------------------------------------------------

# transient-OSError retry policy for checkpoint writes: attempts =
# retries + 1, sleeping backoff * 2**attempt between them
_SAVE_RETRIES = 3
_SAVE_BACKOFF_S = 0.05


def _write_tmp(tmp: str, arrays: Dict[str, np.ndarray]) -> None:
    """One durable tmp-file write attempt (tests inject failures here)."""
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray], *,
                  retries: int = _SAVE_RETRIES,
                  backoff: float = _SAVE_BACKOFF_S) -> None:
    """Write ``arrays`` to ``path`` atomically and durably.

    The tmp name ends in ``.npz``, so ``np.savez`` writes exactly there
    (handed a name without the suffix it appends one). fsync before the
    rename plus a directory fsync make the rename crash-durable. A
    transient ``OSError`` is retried with exponential backoff; the last
    attempt re-raises, so the caller decides whether to go on."""
    tmp = path + ".tmp.npz"
    for attempt in range(retries + 1):
        try:
            _write_tmp(tmp, arrays)
            os.replace(tmp, path)
            break
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass  # never written, or swept elsewhere
            if attempt == retries:
                raise
            delay = backoff * (2 ** attempt)
            warnings.warn(
                f"checkpoint write {path} failed ({e!r}); "
                f"retry {attempt + 1}/{retries} in {delay:.2f}s")
            time.sleep(delay)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # a filesystem without directory fds; best effort


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    """Fully materialize an npz (decompression errors surface here)."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def checkpoint_steps(directory: str) -> List[int]:
    """All step numbers with a (non-temp) checkpoint file, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.match(r"ckpt_(\d+)\.npz$", f)))


def _apply_retention(directory: str, keep_last: Optional[int]) -> None:
    if not keep_last or keep_last < 1:
        return
    for s in checkpoint_steps(directory)[:-keep_last]:
        try:
            os.remove(_ckpt_path(directory, s))
        except OSError:
            pass  # a concurrent sweep already got it


def latest_step(directory: str) -> Optional[int]:
    """Newest checkpointed step, sweeping stale ``ckpt_*.tmp*`` orphans
    (a writer that died mid-save leaves one; it is never a restore
    target)."""
    if not os.path.isdir(directory):
        return None
    for f in os.listdir(directory):
        if f.startswith("ckpt_") and ".tmp" in f:
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# Array-pytree checkpoints (restore into a like_tree)
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, step: int, tree, *,
                    keep_last: Optional[int] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    _atomic_savez(path, flatten_tree(tree))
    _apply_retention(directory, keep_last)
    return path


def restore_checkpoint(directory: str, step: int, like_tree, device=None,
                       *, fallback: bool = False) -> Any:
    """Restore into the structure of ``like_tree``, shape-checked, each
    leaf on ``device`` when one is given.

    ``fallback=True`` treats an unreadable file as skippable: it warns and
    tries the previous step until one loads. A missing leaf or a shape
    mismatch always raises: the caller's model disagrees with the
    checkpoint, and an older step would hide it."""
    flat, path = _read_with_fallback(directory, step, fallback)
    return unflatten_like(flat, like_tree, device, source=path)


def _read_with_fallback(directory: str, step: int, fallback: bool):
    candidates = [step]
    if fallback:
        candidates += [s for s in reversed(checkpoint_steps(directory))
                       if s < step]
    last_err: Optional[BaseException] = None
    for s in candidates:
        path = _ckpt_path(directory, s)
        try:
            return _load_npz(path), path
        except _CORRUPT_ERRORS as e:
            last_err = e
            if fallback:
                warnings.warn(
                    f"checkpoint {path} is unreadable ({e!r}); falling "
                    "back to the previous step")
    raise last_err if last_err is not None else FileNotFoundError(
        _ckpt_path(directory, step))


# ---------------------------------------------------------------------------
# Nested-manifest experiment state (no like_tree needed)
# ---------------------------------------------------------------------------

def save_state(directory: str, step: int, state, *,
               keep_last: Optional[int] = None) -> str:
    """Serialize arbitrarily nested experiment state to one npz.

    ``state`` may nest dicts (string keys), lists/tuples (restored as
    lists), tensors, numpy arrays and plain scalars — ints of any width
    (rng bit-generator words exceed 64 bits), floats, strs, bools, None."""
    arrays: Dict[str, np.ndarray] = {}

    def enc(obj, path):
        if isinstance(obj, (np.ndarray, torch.Tensor)):
            arrays[path] = _host(obj)
            return {_ARRAY_REF: path}
        if isinstance(obj, np.generic):
            return obj.item()
        if isinstance(obj, dict):
            for k in obj:
                if not isinstance(k, str):
                    raise TypeError(
                        f"state dict keys must be str at {path!r}, got "
                        f"{k!r} — encode int/tuple keys as list entries")
                if k == _ARRAY_REF:
                    raise TypeError(f"dict key {_ARRAY_REF!r} is reserved "
                                    f"(at {path!r})")
            return {k: enc(v, f"{path}/{k}") for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [enc(v, f"{path}/{i}") for i, v in enumerate(obj)]
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        raise TypeError(
            f"unserializable state leaf at {path!r}: {type(obj).__name__}")

    manifest = enc(state, "state")
    arrays[_MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), np.uint8)
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    _atomic_savez(path, arrays)
    _apply_retention(directory, keep_last)
    return path


def restore_state(directory: str, step: Optional[int] = None, *,
                  fallback: bool = True) -> Any:
    """Load a ``save_state`` checkpoint back into plain dicts, lists and
    numpy arrays. ``step=None`` picks ``latest_step``; with ``fallback``
    (the default, the service's restore path) an unreadable file warns
    and falls back to the previous step."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {directory!r}")
    arrays, path = _read_with_fallback(directory, step, fallback)
    if _MANIFEST_KEY not in arrays:
        raise KeyError(
            f"{path} has no state manifest — it is an array-pytree "
            "checkpoint; restore it with restore_checkpoint(like_tree)")
    manifest = json.loads(arrays[_MANIFEST_KEY].tobytes().decode("utf-8"))

    def dec(obj):
        if isinstance(obj, dict):
            if set(obj) == {_ARRAY_REF}:
                return arrays[obj[_ARRAY_REF]]
            return {k: dec(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [dec(v) for v in obj]
        return obj

    return dec(manifest)
