"""Production meshes and sharding-spec derivation (``repro.launch.mesh``).

``param_spec`` and its name-aware templates (``_NAME_SPECS``) are the
reference's, bit for bit: a pure function of a leaf's shape, its name and
the mesh's ``shape`` and ``axis_names``, which places the cohort engine's
2-D ``(clients, model)`` state (``repro_torch.fed.mesh``) and decides how
each transformer layer computes on its local slices
(``repro_torch.models.sharding``). A spec is a tuple with an axis name, a
tuple of axis names or ``None`` a dim (``P``). ``make_production_mesh`` is
a function, so importing this module never touches the process group.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class P(tuple):
    """A partition spec: one entry a dim (an axis name, a tuple of axis
    names, or ``None`` for a replicated dim), as ``jax.sharding``'s: a
    tuple of one axis name is that name."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple)
                                     and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Placement(NamedTuple):
    """A leaf's placement on a mesh (``NamedSharding``'s counterpart)."""
    mesh: object
    spec: P


def production_layout(*, multi_pod: bool = False):
    """The reference's pod layouts as (shape, axis names): ``(16, 16)``
    ``("data", "model")``, or ``(2, 16, 16)`` with ``"pod"``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """``production_layout``'s mesh over the ranks of the world; a world
    too small raises the launcher-naming error of ``fed.mesh``."""
    from repro_torch.fed.mesh import build_mesh
    return build_mesh(*production_layout(multi_pod=multi_pod))


def make_debug_mesh(data: int = 1, model: int = 1):
    """A small ``("data", "model")`` mesh over the world's ranks."""
    from repro_torch.fed.mesh import build_mesh
    return build_mesh((data, model), ("data", "model"))


# ---------------------------------------------------------------------------
# parameter auto-sharder
# ---------------------------------------------------------------------------

def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


# Name-aware sharding templates: name -> (negative dim offset, axis or
# tuple of axes) tried in order; the first divisible assignment wins per
# axis. 'model' goes on a contraction dim only where the sum it induces is
# the intended Megatron output sum (wo, wd); 'data' (FSDP) goes on a
# contraction dim or rides the same dim as 'model'.
_NAME_SPECS = {
    # (d, n_heads, h): heads -> model
    "wq": [(-3, "data"), (-2, "model"), (-1, "model")],
    "wk": [(-3, "data"), (-2, "model"), (-1, "model")],
    "wv": [(-3, "data"), (-2, "model"), (-1, "model")],
    # (n, h, d): heads -> model (the output sum); no FSDP
    "wo": [(-3, "model")],
    # dense (d, f) / moe (e, d, f)
    "wg": [(-2, "data"), (-1, "model")],
    # (f, d) / (e, f, d): f -> (model, data) jointly, or data alone when
    # the expert dim took model
    "wd": [(-2, ("model", "data")), (-2, "data")],
    "embed": [(-2, "model"), (-1, "data")],
    "lm_head": [(-1, "model"), (-2, "data")],
    "router": [(-2, "model"), (-1, "data")],
}
_NAME_SPECS["wu"] = [(-2, "data"), (-1, "model")]
# moe 3-D variants override the leading (expert) dim
_MOE_EXPERT_FIRST = ("wg", "wu", "wd")


def param_spec(shape: tuple, mesh, *, n_stack_axes: int = 0,
               fsdp: bool = True, name: Optional[str] = None) -> P:
    """Resolve the template for ``name`` (fallback: the largest divisible
    dim for 'model' on non-attention leaves, then 'data')."""
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data")
    sizes = {"model": model, "data": data}
    nd = len(shape)
    assign: list = [None] * nd
    dims = set(range(n_stack_axes, nd))
    used_axes: set = set()

    def axis_len(ax) -> int:
        if isinstance(ax, tuple):
            return int(np.prod([sizes[a] for a in ax]))
        return sizes[ax]

    def place(off: int, ax) -> None:
        if ax is None:
            return
        if not fsdp and (ax == "data"
                         or (isinstance(ax, tuple) and "data" in ax)):
            if ax == "data":
                return
            ax = tuple(a for a in ax if a != "data") or None
            if ax is None:
                return
            if len(ax) == 1:
                ax = ax[0]
        if isinstance(ax, tuple):
            # size-1 mesh axes are inert: drop them, so a joint template
            # still shards over what remains
            ax = tuple(a for a in ax if sizes[a] > 1)
            if not ax:
                return
            if len(ax) == 1:
                ax = ax[0]
        i = nd + off if off < 0 else off
        flat = set(ax) if isinstance(ax, tuple) else {ax}
        if i in dims and shape[i] >= axis_len(ax) \
                and shape[i] % axis_len(ax) == 0 \
                and not (flat & used_axes) \
                and all(sizes[a] > 1 for a in flat):
            assign[i] = ax
            dims.discard(i)
            used_axes.update(flat)

    template = list(_NAME_SPECS.get(name or "", []))
    if name in _MOE_EXPERT_FIRST and nd - n_stack_axes == 3:
        # MoE (e, d, f)/(e, f, d): experts -> model, FSDP on the output dim
        if name in ("wg", "wu"):
            template = [(n_stack_axes - nd, "model"), (-1, "data")]
        else:  # wd (e, f, d)
            template = [(n_stack_axes - nd, "model"), (-2, "data")]
    for off, ax in template:
        place(off, ax)

    if "model" not in used_axes and model > 1 \
            and name not in ("wq", "wk", "wv", "wo", "wd"):
        cands = [i for i in dims if shape[i] >= model and shape[i] % model == 0]
        mi = max(cands, key=lambda i: shape[i], default=None)
        if mi is not None:
            assign[mi] = "model"
            dims.discard(mi)
            used_axes.add("model")
    if fsdp and "data" not in used_axes and data > 1 and not template:
        cands = [i for i in dims if shape[i] >= data and shape[i] % data == 0]
        di = max(cands, key=lambda i: shape[i], default=None)
        if di is not None:
            assign[di] = "data"
    return P(*assign)


def _key(p):
    """A path entry's key: a jax ``DictKey``'s ``.key``, or the entry."""
    return getattr(p, "key", p)


def _stack_depth(path) -> int:
    """Leading stacked-layer axes of the leaf at ``path``: one under
    'blocks', two for members nested one level deeper ('self'/'rec')."""
    keys = [_key(p) for p in path]
    if "blocks" not in keys:
        return 0
    return 2 if any(k in ("self", "rec") for k in keys) else 1


def _leaf_name(path) -> Optional[str]:
    return next((str(_key(p)) for p in reversed(path)
                 if not isinstance(_key(p), int)), None)


def param_shardings(params, mesh, *, fsdp: bool = True):
    """A tree of ``Placement``s for a parameter tree (dicts and lists)."""
    from repro_torch.fed.mesh import _tree_map_path

    def leaf(path, x):
        spec = param_spec(tuple(x.shape), mesh,
                          n_stack_axes=_stack_depth(path), fsdp=fsdp,
                          name=_leaf_name(path))
        return Placement(mesh, spec)
    return _tree_map_path(leaf, params)


def opt_state_shardings(params, mesh, *, fsdp: bool = True):
    """ZeRO-style placements for optimizer moments: the param spec, then
    'data' on any remaining divisible dim."""
    from repro_torch.fed.mesh import _tree_map_path
    data = _axis_size(mesh, "data")

    def leaf(path, x):
        shape = tuple(x.shape)
        spec = param_spec(shape, mesh, n_stack_axes=_stack_depth(path),
                          fsdp=fsdp, name=_leaf_name(path))
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for p in parts if p
                for a in (p if isinstance(p, tuple) else (p,))}
        if fsdp and data > 1 and "data" not in used:
            cands = [i for i in range(_stack_depth(path), len(shape))
                     if parts[i] is None and shape[i] >= data
                     and shape[i] % data == 0]
            if cands:
                parts[max(cands, key=lambda i: shape[i])] = "data"
        return Placement(mesh, P(*parts))
    return _tree_map_path(leaf, params)


def batch_spec(mesh, *, shard_batch: bool = True) -> P:
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return P(tuple(axes)) if (shard_batch and axes) else P()


def data_shardings(batch_like, mesh, *, batch_divisible: bool = True):
    """The leading (batch) axis of every input leaf over pod+data."""
    from repro_torch.fed.mesh import _tree_map
    spec = batch_spec(mesh, shard_batch=batch_divisible)

    def leaf(x):
        nd = len(x.shape)
        return Placement(mesh, P(*(list(spec) + [None] * (nd - 1)))
                         if nd else P())
    return _tree_map(leaf, batch_like)
