"""Client/model device mesh for the cohort engine: one process per rank.

The counterpart of ``repro.fed.mesh``, with its public names. The
reference is one JAX process addressing N devices; here every mesh device
is a process of one ``torch.distributed`` group (one rank a card, or ranks
on the CPU for tests), every rank runs the same host program from the same
seed (data, partition, proxy set, scheduler, server) and holds only its
own rows of each stacked ``(C, ...)`` cohort tensor and, on a 2-D mesh,
only its own slices of each leaf.

``build_client_mesh(num_devices, model_shards=m)`` lays the world out as
the reference does: ``num_devices`` counts every rank (``-1``: the whole
world), ``m == 0`` or ``1`` gives the 1-D ``("clients",)`` mesh and
``m > 1`` the 2-D ``(clients, model)`` mesh of shape
``(num_devices // m, m)``, rank ``r`` at coordinates ``(r // m, r % m)``.
The stacked client axis splits into contiguous blocks over ``"clients"``
(``shard_clients``), and each leaf's dims split over ``"model"`` as
``repro_torch.launch.mesh.param_spec`` places them
(``stacked_state_shardings``). A :class:`ClientMesh` carries the shape,
the axis names, the ranks laid out as ``devices``, this rank's
coordinates and device, and one process group an axis; it has no GSPMD
behind it, so placement means slicing (``shard_stacked_state``) and every value
that must be whole is gathered explicitly (``gather``).

A request for more than one rank outside a launcher raises, naming the
launcher (``python -m torch.distributed.run``, i.e. torchrun), as the
reference names ``XLA_FLAGS``. ``$REPRO_MODEL_SHARDS`` fills in a config
that leaves ``model_shards`` at 0, clamped to ``gcd(num_devices, env)``.
Cohorts whose client count does not divide the client axis are padded
with *dummy clients* (``padded_size``) whose step flags are all false.

The process group (``init_distributed``) takes its backend from
``$REPRO_DIST_BACKEND`` or the device: ``nccl`` for CUDA, ``gloo`` on the
CPU. NCCL refuses two ranks on one card, so when the launcher puts more
ranks on a host than it has cards the port refuses and names
``REPRO_DIST_BACKEND=gloo``, which stages every collective through host
memory; it never switches backend by itself. The group has a timeout
(``DIST_TIMEOUT``), so a dead peer fails its survivors with a message
instead of a hang.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_CLIENT_AXIS = "clients"
# launch.mesh.param_spec's name-aware templates key on the literal axis
# name "model", so the 2-D client mesh reuses it verbatim
DEFAULT_MODEL_AXIS = "model"
MODEL_SHARDS_ENV = "REPRO_MODEL_SHARDS"
BACKEND_ENV = "REPRO_DIST_BACKEND"
# a collective that waits longer fails: a dead peer ends its survivors
DIST_TIMEOUT = datetime.timedelta(seconds=300)
LAUNCHER = "python -m torch.distributed.run --nproc_per_node N"

# logical-axis rules of the 2-D mesh: activations stay replicated across
# model shards (the Megatron residual stream) while heads, ff, vocab and
# experts ride the "model" axis, matching the param specs
MODEL_LOGICAL_RULES = {
    "batch": None,
    "seq": None,
    "embed": None,
    "heads": DEFAULT_MODEL_AXIS,
    "kv_heads": DEFAULT_MODEL_AXIS,
    "head_dim": None,
    "ff": DEFAULT_MODEL_AXIS,
    "vocab": DEFAULT_MODEL_AXIS,
    "experts": DEFAULT_MODEL_AXIS,
    "kv_seq": None,
    "vision_seq": None,
}


def resolve_model_shards(model_shards: int = 0) -> int:
    """Resolve a ``model_shards`` request: explicit value > env > 0 (1-D).
    The result is still a request: :func:`build_client_mesh` clamps an
    env-sourced one to a divisor of ``num_devices``."""
    if model_shards < 0:
        raise ValueError(
            f"model_shards must be >= 0, got {model_shards!r} "
            "(0 = the 1-D client mesh)")
    if model_shards == 0:
        env = os.environ.get(MODEL_SHARDS_ENV, "").strip()
        if env:
            try:
                model_shards = int(env)
            except ValueError:
                raise ValueError(
                    f"${MODEL_SHARDS_ENV}={env!r} is not an integer")
            if model_shards < 0:
                raise ValueError(
                    f"${MODEL_SHARDS_ENV}={env!r} must be >= 0")
    return model_shards


# ---------------------------------------------------------------- the world

def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def resolve_backend(device_type: str) -> str:
    """``$REPRO_DIST_BACKEND``, else nccl on CUDA and gloo on the CPU."""
    env = os.environ.get(BACKEND_ENV, "").strip()
    if env:
        return env
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device for a requested one: ``cuda`` becomes the card
    ``LOCAL_RANK`` maps to (ranks beyond the card count share cards)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def init_distributed(device, *, init_method: str = "env://") -> None:
    """Join the launcher's process group (``WORLD_SIZE`` and ``RANK`` from
    the environment, as torchrun sets them; ``init_method`` the rendezvous:
    torchrun's ``MASTER_ADDR``/``MASTER_PORT`` by default, or a
    ``file://`` store) unless one is already open; a world of one without
    a launcher opens nothing."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method == "env://":
        return
    dev = torch.device(device)
    backend = resolve_backend(dev.type)
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"{local_world} ranks on a host with {cards} CUDA device(s): "
                "NCCL refuses two ranks on one card; run one rank a card, "
                f"or set {BACKEND_ENV}=gloo to stage every collective "
                "through host memory")
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world,
                            rank=int(os.environ.get("RANK", "0")),
                            timeout=DIST_TIMEOUT)


def _too_few(total: int, detail: str, extra: str = "") -> ValueError:
    return ValueError(
        f"requested a {total}-device mesh ({detail}) but this process is "
        f"one rank of a world of {world_size()}; launch one process a "
        f"device: {LAUNCHER} -m repro_torch.launch.fed_train ... (or set "
        "WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT)" + extra)


# ------------------------------------------------------------------ the mesh

class ClientMesh:
    """A mesh of ranks: ``shape`` (axis name -> size, in order),
    ``axis_names``, ``devices`` (the ranks laid out row-major), this rank's
    ``coords`` and ``device``, and a process group an axis (None in a world
    of one, where every collective is the identity)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device=None, groups: bool = True):
        """``groups=False``: the layout alone (shape, coordinates, splits),
        no process group and so no collective, for placing state before
        the engine's mesh exists."""
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        total = int(np.prod(list(self.shape.values())))
        self.devices = np.arange(total).reshape(tuple(self.shape.values()))
        self.rank = world_rank()
        self.coords = tuple(int(c) for c in
                            np.unravel_index(self.rank, self.devices.shape))
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = (dist.get_backend() if dist.is_initialized()
                        else None)
        self._splits: Dict[tuple, Optional[int]] = {}   # model_split's
        self._groups: Dict[str, object] = {}
        self._roots: Dict[str, int] = {}     # each axis line's first rank
        if dist.is_initialized() and groups:
            # every rank creates every group, in one order
            for ax_i, ax in enumerate(self.axis_names):
                lines = np.moveaxis(self.devices, ax_i, -1).reshape(
                    -1, self.devices.shape[ax_i])
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        self._groups[ax] = g
                        self._roots[ax] = int(line[0])

    def __repr__(self) -> str:
        return (f"ClientMesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self._groups.get(axis)

    # ------------------------------------------------------- collectives
    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where this mesh's backend takes it: gloo's collectives run
        on host copies, NCCL's on the card."""
        want = torch.device("cpu") if self.backend == "gloo" else self.device
        return t.detach().to(want).contiguous()

    def gather(self, t: torch.Tensor, axis: str, dim: int = 0,
               to=None, root: bool = False) -> Optional[torch.Tensor]:
        """Concatenate every rank's ``t`` along ``dim`` over ``axis``, in
        the axis's order (the identity on an axis of one), on ``to`` (by
        default ``t``'s device). ``root``: on the axis's first rank alone
        (``None`` on the others)."""
        to = t.device if to is None else torch.device(to)
        if self.axis_size(axis) == 1 or self.group(axis) is None:
            return t.to(to)
        dtype = t.dtype
        src = self._comm(t.to(torch.uint8) if dtype == torch.bool else t)
        mine = not root or self.coord(axis) == 0
        parts = ([torch.empty_like(src) for _ in range(self.axis_size(axis))]
                 if mine else None)
        if root:
            dist.gather(src, parts, dst=self._roots[axis],
                        group=self.group(axis))
            if not mine:
                return None
        else:
            dist.all_gather(parts, src, group=self.group(axis))
        out = torch.cat(parts, dim=dim).to(to)
        return out.to(dtype) if dtype == torch.bool else out

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """The sum of every rank's ``t`` over ``axis`` (None: the world)."""
        if axis is not None and (self.axis_size(axis) == 1
                                 or self.group(axis) is None):
            return t
        if axis is None and (self.size == 1 or not dist.is_initialized()):
            return t
        buf = self._comm(t).clone()
        dist.all_reduce(buf, group=None if axis is None
                        else self.group(axis))
        return buf.to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank of the world."""
        if self.size == 1 or not dist.is_initialized():
            return t
        buf = self._comm(t).clone()
        dist.broadcast(buf, src=src)
        return buf.to(t.device)

    def gather_objects(self, obj, axis: str) -> List:
        """Every rank's picklable ``obj`` over ``axis``, in axis order."""
        if self.axis_size(axis) == 1 or self.group(axis) is None:
            return [obj]
        out = [None] * self.axis_size(axis)
        dist.all_gather_object(out, obj, group=self.group(axis))
        return out


def build_mesh(shape: Sequence[int], axes: Sequence[str],
               device=None, groups: bool = True) -> ClientMesh:
    """N-D mesh over the first ``prod(shape)`` ranks of the world, folded
    row-major (the single layout path, as in the reference). Raises a
    legible ``ValueError`` naming the launcher when the world is too
    small."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} has {len(shape)} dims but "
                         f"{len(axes)} axis names: {tuple(axes)!r}")
    if any(s <= 0 for s in shape):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    total = int(np.prod(shape))
    if total != world_size():
        detail = " × ".join(f"{s} {a!r}" for s, a in zip(shape, axes))
        if total > world_size():
            raise _too_few(total, detail)
        raise ValueError(
            f"a {total}-device mesh ({detail}) must span the whole world of "
            f"{world_size()} ranks: every rank runs the same program")
    return ClientMesh(shape, axes, device, groups)


def build_client_mesh(num_devices: int = 0,
                      axis: str = DEFAULT_CLIENT_AXIS,
                      model_shards: int = 0,
                      model_axis: str = DEFAULT_MODEL_AXIS,
                      device=None, groups: bool = True
                      ) -> Optional[ClientMesh]:
    """The client mesh, or ``None`` for the unsharded path.

    ``num_devices``: 0 = no mesh; ``-1`` = the whole world; ``N > 0`` =
    exactly N ranks (a legible error naming the launcher if the world is
    smaller). With ``model_shards = m > 1`` the ranks fold into a
    ``(num_devices // m, m)`` ``(clients, model)`` mesh; ``m`` 0 resolves
    through ``$REPRO_MODEL_SHARDS`` (clamped to a divisor of
    ``num_devices``), and ``m == 1`` is the 1-D mesh."""
    from_env = model_shards == 0
    model_shards = resolve_model_shards(model_shards)
    if num_devices == 0:
        if model_shards > 0 and not from_env:
            raise ValueError(
                f"model_shards={model_shards} requires a device mesh; set "
                "num_devices (e.g. -1 for the whole world)")
        return None
    if num_devices < 0:
        num_devices = world_size()
    if num_devices > world_size():
        extra = ""
        if model_shards > 0:
            extra = (f" (num_devices counts TOTAL devices — the clients × "
                     f"model_shards={model_shards} product must fit)")
        raise _too_few(num_devices, f"{num_devices} {axis!r}", extra)
    if model_shards == 0:
        return build_mesh((num_devices,), (axis,), device, groups)
    if from_env:
        model_shards = math.gcd(num_devices, model_shards)
    elif num_devices % model_shards:
        raise ValueError(
            f"model_shards={model_shards} cannot tile a "
            f"{num_devices}-device mesh: num_devices must be a positive "
            f"multiple of model_shards (the mesh folds to "
            f"(num_devices // model_shards, model_shards) = clients × "
            "model)")
    if model_shards == 1:
        return build_mesh((num_devices,), (axis,), device, groups)
    return build_mesh((num_devices // model_shards, model_shards),
                      (axis, model_axis), device, groups)


def client_axis_size(mesh) -> int:
    """Ranks along the client (leading) axis, not the mesh size."""
    if mesh is None:
        return 1
    return int(mesh.devices.shape[0])


def model_axis_name(mesh) -> Optional[str]:
    """The model axis name of a 2-D client mesh, else ``None``."""
    if mesh is None or len(mesh.axis_names) < 2:
        return None
    return mesh.axis_names[1]


def padded_size(count: int, mesh) -> int:
    """Client-axis length after padding to a multiple of the client-axis
    size (model shards never pad the client axis)."""
    if mesh is None:
        return count
    d = client_axis_size(mesh)
    return ((count + d - 1) // d) * d


# ----------------------------------------------------------------- placement

def model_split(name: Optional[str], shape: Sequence[int], mesh
                ) -> Optional[int]:
    """The dim of a leaf named ``name`` of ``shape`` (one client's leaf: no
    client or layer-stack axis) that the model axis splits, or ``None``
    (no model axis, or a leaf it leaves whole): where
    ``launch.mesh.param_spec`` puts ``"model"``. The one split decision:
    ``stacked_state_shardings``, ``shard_stacked_state``, the cohort
    engine's stacking and the layers' local compute
    (``models.sharding``) all read it."""
    ax = model_axis_name(mesh)
    if ax is None or mesh.axis_size(ax) == 1:
        return None
    key = (name, tuple(int(n) for n in shape))
    if key not in mesh._splits:
        from repro_torch.launch.mesh import param_spec
        spec = param_spec(key[1], mesh, name=name)
        mesh._splits[key] = next(
            (i for i, a in enumerate(spec) if a == ax), None)
    return mesh._splits[key]


def model_block(t, dim: int, mesh):
    """This rank's contiguous block of ``t`` (a tensor or an array) along
    ``dim`` over the model axis."""
    return _block(t, dim, model_axis_name(mesh), mesh)


def _block(t, dim: int, axis: str, mesh):
    n = t.shape[dim] // mesh.axis_size(axis)
    lo = mesh.coord(axis) * n
    return t[(slice(None),) * dim + (slice(lo, lo + n),)]


def _slice(t, spec, mesh):
    """This rank's block of ``t`` under ``spec`` (an axis name or None a
    dim): each named dim cut into equal contiguous blocks."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = _block(t, dim, ax, mesh)
    return t


def shard_clients(tree, mesh, axis: str = DEFAULT_CLIENT_AXIS):
    """This rank's rows of every leaf's leading (client) axis, moved to the
    mesh's device; the identity without a mesh. Leaves must already be
    padded to a client-axis multiple."""
    if mesh is None:
        return tree
    return _tree_map(lambda x: _put(_slice(x, (axis,), mesh), mesh), tree)


def replicate(tree, mesh):
    """Every leaf whole on this rank's device (the identity without)."""
    if mesh is None:
        return tree
    return _tree_map(lambda x: _put(x, mesh), tree)


def stacked_state_shardings(tree, mesh, axis: str = DEFAULT_CLIENT_AXIS):
    """Per-leaf specs (tuples of axis names or None, one a dim) for a
    stacked ``(C, ...)`` state tree: dim 0 over ``axis``, and the dim
    ``model_split`` names for the leaf (named by its last key) over the
    model axis, past the client axis and any layer stack. A 1-D mesh
    gives ``(axis,)`` for every leaf; a scalar, ``()``."""
    from repro_torch.launch.mesh import _stack_depth

    def leaf(path, x):
        shape = tuple(x.shape)
        if not shape:
            return ()
        name = next((str(k) for k in reversed(path)
                     if not isinstance(k, int)), None)
        lead = 1 + _stack_depth(path)
        parts = [axis] + [None] * (len(shape) - 1)
        s = model_split(name, shape[lead:], mesh)
        if s is not None:
            parts[lead + s] = model_axis_name(mesh)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    return _tree_map_path(leaf, tree)


def shard_stacked_state(tree, mesh, axis: str = DEFAULT_CLIENT_AXIS):
    """This rank's block of a stacked ``(C, ...)`` state tree on the mesh's
    device: its client rows on a 1-D mesh, its rows and model slices on a
    2-D mesh; the identity without a mesh."""
    if mesh is None:
        return tree
    specs = stacked_state_shardings(tree, mesh, axis)
    return _tree_map2(lambda x, s: _put(_slice(x, s, mesh), mesh),
                      tree, specs)


def _put(x, mesh):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(mesh.device)


def _tree_map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _tree_map(fn, tree):
    return _tree_map_path(lambda _, x: fn(x), tree)


def _tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over dict/list trees (``other``'s leaves
    may be tuples)."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map2(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)
