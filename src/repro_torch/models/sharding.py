"""Logical-axis rules and the model-axis collectives of the 2-D mesh.

The counterpart of ``repro.models.sharding``. The reference annotates
activations with logical axis names (``constrain``) and leaves the rest to
GSPMD; torch has no GSPMD, so ``constrain`` is the identity here and the
tables (``DEFAULT_RULES``, ``PROFILES``, ``set_logical_rules``,
``logical_rules``) are what layers read. A layer computes on the local
slices the cohort engine gives it, as ``repro_torch.fed.mesh.model_split``
(``launch.mesh.param_spec``) places each leaf over the ``"model"`` axis
(Megatron's split):

* an output-dim shard is column-parallel: the input enters through
  ``copy_to_model`` (identity forward, all-reduce backward);
* a contraction-dim shard is row-parallel: the output leaves through
  ``reduce_from_model`` (all-reduce forward, identity backward);
* a value that must be whole (a leaf split on a dim that is neither its
  input nor its output, vocab-split logits) goes through
  ``gather_from_model`` (all-gather forward; the backward takes the local
  slice, since what follows runs the same on every rank);
* a whole value that a rank reads only a block of (the input of a
  contraction-split product, a recurrence on a local width block) goes
  through ``scatter_to_model`` (this rank's block forward, the blocks'
  gradients gathered backward), and a partial sum that a rank reads only a
  block of through ``reduce_then_block`` (an all-reduce of the whole sum,
  then this rank's block: twice the bytes of a reduce-scatter, which
  gloo lacks; the gradients gathered backward).

A partial sum in bf16 (``layers.psum_einsum`` under ``bf16_psum``) is
summed in f32 and rounded to bf16 once: at two ranks that is a bf16 add,
the result of the reference's GSPMD all-reduce, whatever the backend sums
bf16 in.

Each collective is a ``torch.autograd.Function`` with a ``vmap`` rule (the
cohort engine vmaps the forward over its client axis): the rule runs the
collective once on the batched tensor. ``model_parallel(mesh)`` installs
the mesh for the forwards inside it; without one (or with a model axis of
one) every helper here is the identity and the layers take their unsharded
code unchanged.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

_state = threading.local()

# logical axis name -> mesh axis name (or tuple of mesh axes, or None)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": None,
    "vision_seq": None,
}

# sharding profiles: 2d (batch over (pod, data), tensor parallel over
# model, FSDP over data), dp (batch over every axis, params replicated),
# tp (tensor parallel without FSDP)
PROFILES = {
    "2d": DEFAULT_RULES,
    "dp": {**{k: None for k in DEFAULT_RULES},
           "batch": ("pod", "data", "model")},
    "tp": DEFAULT_RULES,
}


def set_logical_rules(rules: Optional[dict], mesh=None) -> None:
    _state.rules = rules
    _state.mesh = mesh


@contextlib.contextmanager
def logical_rules(rules: Optional[dict], mesh=None):
    """Scoped ``set_logical_rules``: installs (rules, mesh) for the block
    and restores the previous pair on exit."""
    prev = (getattr(_state, "rules", None), getattr(_state, "mesh", None))
    set_logical_rules(rules, mesh)
    try:
        yield
    finally:
        set_logical_rules(*prev)


def get_mesh():
    return getattr(_state, "mesh", None)


def _resolve(axis: Optional[str], rules: dict, mesh_axes
             ) -> Optional[Union[str, tuple]]:
    if axis is None:
        return None
    m = rules.get(axis, None)
    if m is None:
        return None
    if isinstance(m, tuple):
        kept = tuple(a for a in m if a in mesh_axes)
        return kept if kept else None
    return m if m in mesh_axes else None


def logical_spec(*axes: Optional[str]):
    """The mesh axes the installed rules map ``axes`` to (a ``P``), or
    None without rules and a mesh."""
    from repro_torch.launch.mesh import P
    rules = getattr(_state, "rules", None)
    mesh = getattr(_state, "mesh", None)
    if rules is None or mesh is None:
        return None
    mesh_axes = set(mesh.axis_names)
    return P(*[_resolve(a, rules, mesh_axes) for a in axes])


def constrain(x, *axes: Optional[str]):
    """The identity: torch has no GSPMD to hand a placement to. Layers
    place their values themselves, through the collectives below."""
    return x


# ---------------------------------------------------------- model parallel

class ModelParallel:
    """The installed model axis: the mesh, its size and this rank's
    index along it."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.axis_size(axis)
        self.index = mesh.coord(axis)

    def split_dim(self, name: str, shape: Sequence[int]) -> Optional[int]:
        """The dim of a whole leaf of ``shape`` that the model axis splits,
        or None (``fed.mesh.model_split``, the placement's own rule)."""
        from repro_torch.fed.mesh import model_split
        return model_split(name, shape, self.mesh)


@contextlib.contextmanager
def model_parallel(mesh, axis: str = "model"):
    """Install ``mesh``'s model axis for the forwards in the block (none,
    or an axis of one, leaves the layers unsharded)."""
    prev = getattr(_state, "mp", None)
    mp = (ModelParallel(mesh, axis)
          if mesh is not None and mesh.axis_size(axis) > 1 else None)
    _state.mp = mp
    try:
        yield mp
    finally:
        _state.mp = prev


def model_parallel_state() -> Optional[ModelParallel]:
    return getattr(_state, "mp", None)


def _ndim_dim(dim: int, ndim: int) -> int:
    return dim if dim >= 0 else dim + ndim


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over the model axis."""

    @staticmethod
    def forward(x, mp):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mp = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.mesh.all_reduce(g, ctx.mp.axis), None

    @staticmethod
    def vmap(info, in_dims, x, mp):
        return _CopyToModel.apply(x, mp), in_dims[0]


def _sum(x: torch.Tensor, mp: "ModelParallel") -> torch.Tensor:
    """Every rank's ``x`` summed over the model axis: a bf16 ``x`` in f32,
    rounded once (exact at two ranks: the two bf16 values' f32 sum is
    exact, so its rounding is the bf16 add's)."""
    if x.dtype == torch.bfloat16:
        return mp.mesh.all_reduce(x.to(torch.float32),
                                  mp.axis).to(torch.bfloat16)
    return mp.mesh.all_reduce(x, mp.axis)


def _own(x: torch.Tensor, dim: int, mp: "ModelParallel") -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    n = x.shape[dim] // mp.size
    return x.narrow(dim, mp.index * n, n).contiguous()


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over the model axis, identity backward."""

    @staticmethod
    def forward(x, mp):
        return _sum(x, mp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, mp):
        return _ReduceFromModel.apply(x, mp), in_dims[0]


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` over the model axis; the backward takes
    this rank's block of the gradient."""

    @staticmethod
    def forward(x, dim, mp):
        return mp.mesh.gather(x, mp.axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dim, mp = inputs
        ctx.dim, ctx.mp, ctx.n = dim, mp, x.shape[dim]

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mp.index * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, mp):
        bd = in_dims[0]
        if bd is None:
            return _GatherFromModel.apply(x, dim, mp), None
        x = x.movedim(bd, 0)
        return _GatherFromModel.apply(
            x, _ndim_dim(dim, x.ndim - 1) + 1, mp), 0


class _ToModelBlock(torch.autograd.Function):
    """This rank's block along ``dim`` of ``x``, a value whole on every
    rank, or (``reduce``) of the sum of every rank's partial ``x``; the
    backward gathers every rank's block of the gradient (each rank's use
    is of its own block alone)."""

    @staticmethod
    def forward(x, dim, mp, reduce):
        return _own(_sum(x, mp) if reduce else x, dim, mp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.mp = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.mesh.gather(g, ctx.mp.axis, ctx.dim), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, mp, reduce):
        bd = in_dims[0]
        if bd is None:
            return _ToModelBlock.apply(x, dim, mp, reduce), None
        x = x.movedim(bd, 0)
        return _ToModelBlock.apply(
            x, _ndim_dim(dim, x.ndim - 1) + 1, mp, reduce), 0


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product (identity without a model
    axis)."""
    mp = model_parallel_state()
    return x if mp is None else _CopyToModel.apply(x, mp)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of a row-parallel product's partial outputs."""
    mp = model_parallel_state()
    return x if mp is None else _ReduceFromModel.apply(x, mp)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, concatenated in model
    order."""
    mp = model_parallel_state()
    if mp is None:
        return x
    return _GatherFromModel.apply(x, _ndim_dim(dim, x.ndim), mp)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (whole on every rank) along ``dim``."""
    mp = model_parallel_state()
    if mp is None:
        return x
    return _ToModelBlock.apply(x, _ndim_dim(dim, x.ndim), mp, False)


def reduce_then_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's partial
    ``x``: the whole sum all-reduced, then cut (twice a reduce-scatter's
    bytes; gloo has no reduce-scatter)."""
    mp = model_parallel_state()
    if mp is None:
        return x
    return _ToModelBlock.apply(x, _ndim_dim(dim, x.ndim), mp, True)


def block(n: int) -> tuple:
    """This rank's ``[lo, hi)`` of a dim of ``n`` split evenly over the
    model axis (``(0, n)`` without one)."""
    mp = model_parallel_state()
    if mp is None:
        return 0, n
    k = n // mp.size
    return mp.index * k, (mp.index + 1) * k


def splits(n: int) -> bool:
    """Whether a dim of ``n`` splits evenly over the installed model axis
    (False without one)."""
    mp = model_parallel_state()
    return mp is not None and n % mp.size == 0


def whole(w: torch.Tensor, name: str, shape: Sequence[int]) -> torch.Tensor:
    """Leaf ``name`` whole (``shape``), from this rank's slice ``w``, for
    compute that runs the same on every rank; ``w`` itself when it is not
    split. Gathered at every call: nothing is kept between calls."""
    mp = model_parallel_state()
    if mp is None:
        return w
    s = mp.split_dim(name, shape)
    return w if s is None else gather_from_model(w, s)


def whole_all(ws: Sequence[torch.Tensor], names: Sequence[str],
              shape: Sequence[int]) -> list:
    """``whole`` of several leaves of one whole ``shape``: in one gather
    where the model axis splits them alike."""
    mp = model_parallel_state()
    if mp is None:
        return list(ws)
    dims = {mp.split_dim(n, shape) for n in names}
    if len(dims) > 1 or dims == {None}:
        return [whole(w, n, shape) for w, n in zip(ws, names)]
    return list(gather_from_model(torch.stack(list(ws)),
                                  dims.pop() + 1).unbind(0))


def part(w: torch.Tensor, name: str, shape: Sequence[int], dim: int,
         lo: int, hi: int) -> torch.Tensor:
    """The block ``[lo, hi)`` along ``dim`` of leaf ``name`` (whole shape
    ``shape``), for compute inside a model-parallel region (between
    ``copy_to_model`` and ``reduce_from_model``): this rank's own slice
    when it is that block, else the whole leaf cut to it, with the
    gradient summed over the model axis (every rank's use is partial)."""
    mp = model_parallel_state()
    if mp is None:
        return w.narrow(dim, lo, hi - lo)
    s = mp.split_dim(name, shape)
    n = shape[dim] // mp.size if s == dim else None
    if n is not None and (lo, hi) == (mp.index * n, (mp.index + 1) * n):
        return w
    return copy_to_model(whole(w, name, shape)).narrow(dim, lo, hi - lo)
