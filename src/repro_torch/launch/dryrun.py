"""Multi-pod dry run: one rank's step of every (arch × input shape) on the
reference's production layouts, run on the meta device, and the roofline
terms of what it did (the counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --out dryrun.json

The reference lowers and compiles each step for 256 or 512 TPU devices and
reads the compiled HLO. The port has no compiler to ask, so it runs the
step itself: rank 0 of ``launch.mesh.production_layout``'s ``(16, 16)``
``("data", "model")`` or ``(2, 16, 16)`` layout, its model
``Transformer(cfg, device="meta").shard(mesh)`` in bf16 under
``models.sharding.model_parallel(mesh)``, on the meta device (shapes, no
data, no memory), with the plain attention (``kernels.dispatch`` set to
``"torch"``: the meta device has no kernels). The mesh is a
``RecordingMesh``: a ``ClientMesh`` without process groups whose
``all_reduce`` and ``gather`` return tensors of the right shape and append
``(kind, axis, bytes_in, bytes_out)`` to its record
(``launch.hlo_analysis``). A rank holds ``1 / (pod · data)`` of the global
batch (all of it where that does not divide, as long_500k's one row), its
slices of the weights (``fed.mesh.model_split``) and its share of a
decode cache: its kv heads (the shared ones whole), its mLSTM heads, its
RG-LRU width block and the sLSTM's state whole (``T.init_cache`` under the
axis). The reference places a cache's length on ``model`` instead; the dry
run counts what the port holds.

What it counts, for one step on one rank:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions, attention), which equals a real step's count on the CPU or
  the card (``tests/test_torch_dryrun.py``, ``chip_smoke.py``);
* bytes: ``StepMeter``, a ``TorchDispatchMode``: the arguments (the rank's
  parameters, AdamW moments, batch or cache), the peak of the live
  storages through the step, and the bytes every op reads and writes
  (eager PyTorch moves each op's operands through HBM: the memory term);
* collectives: the recording mesh's calls, by kind and axis.

``_EmbedRows``' backward (a vocab above 1024) takes ``torch.unique``, which
has no meta kernel: on meta it counts ``min(vocab, tokens)`` distinct rows,
or a count the caller passes (``distinct``). The sLSTM's time loop runs
every step in Python, too slow for 4096 or 32768 steps on meta, so the ssm
family's train and prefill cells run at ``ssm_points()`` (three lengths,
each two or more mLSTM chunks, at 0 and 1 groups) and every count
is extrapolated: each is affine in the groups and at most quadratic in
the length (the stack holds no attention; the collectives do not grow
with it), ``extrapolate``; the test holds this to the full loop. The
peak of such a cell is a lower bound (``peak_is_lower_bound``).

The reference's ``fsdp=True`` also places parameters over ``data``. The
port has no FSDP runtime, so for those cells a rank's parameter and
AdamW bytes come from ``launch.mesh.param_spec`` (the reference's, bit for
bit), and the FSDP all-gathers (forward and backward) and gradient
reduce-scatters, and the gradient all-reduces over ``data`` (and ``pod``)
that a data-parallel step needs, are added by formula, under
``"by_formula"`` in the result. Decode runs without FSDP, as the
reference's does.

Roofline constants: one NVIDIA H100 SXM5 80GB at its 700 W limit, from
NVIDIA's data sheet: 989 TFLOP/s dense bf16 (tensor cores), 67 TFLOP/s
fp32 outside them (an fp32 step: ``pin_fp32`` keeps TF32 off), 3.35 TB/s
HBM3, 80 GB of HBM, NVLink 4 at 450 GB/s a direction a GPU inside an
8-GPU node and InfiniBand NDR at 50 GB/s a GPU between nodes. A collective
over an axis whose ranks span more than one node takes the inter-node
rate: on these layouts (rank = row-major index, 8 ranks a node) the model
axis of 16 spans two nodes, and ``data`` and ``pod`` always span nodes.
The compute and memory terms are the counted FLOPs and bytes of rank 0's
step at those peaks; ``analytic_*`` are ``launch.analytic.step_cost``'s,
the reference's model, beside them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
from fractions import Fraction
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common.types import ArchConfig, InputShape
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.fed.mesh import ClientMesh
from repro_torch.kernels.dispatch import kernel_backend
from repro_torch.launch import mesh as M
from repro_torch.launch.analytic import step_cost
from repro_torch.launch.hlo_analysis import (COLL_KINDS,
                                             collective_bytes_corrected,
                                             empty_counts, while_trip_counts)
from repro_torch.models import sharding
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.layers import set_attention_options
from repro_torch.models.sharding import PROFILES
from repro_torch.optim.optimizers import adamw

# ---------------------------------------------------------------------------
# H100 SXM5 80GB constants (NVIDIA data sheet; 700 W)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s a GPU (tensor cores)
PEAK_FLOPS_F32 = 67e12       # fp32 FLOP/s a GPU outside the tensor cores
HBM_BW = 3.35e12             # B/s a GPU
HBM_BYTES = 80e9             # HBM a GPU
NVLINK_BW = 450e9            # B/s a direction a GPU, inside a node
IB_BW = 50e9                 # B/s a GPU between nodes (NDR, 400 Gb/s)
NODE_GPUS = 8

# long-context policy: dense/moe/vlm run long_500k only via the
# sliding-window variant; ssm/hybrid run native; audio has no decode.
LONG_WINDOW = 8192
SKIPS = {
    ("hubert-xlarge", "decode_32k"): "encoder-only: no decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only: no decode step",
}


def ssm_points() -> tuple:
    """The (groups, length) points the ssm family's long cells are
    extrapolated from: 0 and 1 groups at 2, 3 and 4 mLSTM chunks (one
    chunk's slices are the whole sequence, off the polynomial)."""
    return tuple((g, k * SSM.CHUNK) for g in (0, 1) for k in (2, 3, 4))


def long_window_for(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        return LONG_WINDOW
    return None


def peak_flops(dtype) -> float:
    return PEAK_FLOPS_F32 if dtype == torch.float32 else PEAK_FLOPS


def link_bw(shape, axes, axis: Optional[str]) -> float:
    """The rate of a collective over ``axis`` (None: the world) on rank
    0's line of a row-major layout of ``shape``: NVLink inside one node of
    ``NODE_GPUS`` ranks, InfiniBand across nodes."""
    devices = np.arange(int(np.prod(shape))).reshape(shape)
    if axis is None or axis not in axes:
        line = devices.reshape(-1)
    else:
        i = list(axes).index(axis)
        line = np.moveaxis(devices, i, -1).reshape(-1, shape[i])[0]
    return NVLINK_BW if len({int(r) // NODE_GPUS for r in line}) == 1 \
        else IB_BW


# ---------------------------------------------------------------------------
# the recording mesh
# ---------------------------------------------------------------------------

class RecordingMesh(ClientMesh):
    """A ``ClientMesh`` layout with no process group whose model-axis
    collectives return tensors of the right shape (an all-reduce ``t``'s
    copy, a gather ``t`` repeated along ``dim``) and record ``(kind,
    axis, bytes_in, bytes_out)`` in ``record``; ``rank`` places this rank
    (default 0)."""

    def __init__(self, shape, axes, rank: int = 0, device="meta"):
        super().__init__(shape, axes, device=device, groups=False)
        self.rank = rank
        self.coords = tuple(int(c) for c in
                            np.unravel_index(rank, self.devices.shape))
        self.record: List[tuple] = []

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None
                   ) -> torch.Tensor:
        if (self.size if axis is None else self.axis_size(axis)) == 1:
            return t
        n = t.numel() * t.element_size()
        self.record.append(("all-reduce", axis, n, n))
        return t.detach().clone()

    def gather(self, t: torch.Tensor, axis: str, dim: int = 0, to=None,
               root: bool = False) -> torch.Tensor:
        to = t.device if to is None else torch.device(to)
        k = self.axis_size(axis)
        if k == 1:
            return t.to(to)
        n = t.numel() * t.element_size()
        self.record.append(("all-gather", axis, n, n * k))
        return torch.cat([t.detach()] * k, dim=dim).to(to)


@contextlib.contextmanager
def recorded(mesh: ClientMesh):
    """A live mesh's ``all_reduce`` and ``gather`` calls appended to
    ``mesh.record`` as a ``RecordingMesh`` records them, while in effect
    (the calls themselves run as they do)."""
    mesh.record = []
    for name in ("all_reduce", "gather"):
        orig = getattr(mesh, name)

        def counted(t, axis=None, *a, _orig=orig, _name=name, **kw):
            out = _orig(t, axis, *a, **kw)
            if out is not t:                  # not an axis of one
                mesh.record.append((
                    "all-reduce" if _name == "all_reduce" else "all-gather",
                    axis, t.numel() * t.element_size(),
                    out.numel() * out.element_size()))
            return out
        setattr(mesh, name, counted)
    try:
        yield mesh.record
    finally:
        del mesh.all_reduce, mesh.gather


# ---------------------------------------------------------------------------
# the meter
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op moves for ``t``: its elements, at most its
    storage (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class StepMeter(TorchDispatchMode):
    """The live storages on ``device`` through a step and their peak
    bytes (``hold`` the arguments first; at most 1/256 below the true
    peak), and ``traffic``: the bytes every op other than a view or an
    allocation reads and writes."""

    SKIP = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "lift_fresh", "alias"}

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.live: Dict[int, tuple] = {}
        self.upper = self.peak = self.traffic = 0

    def _mine(self, t) -> bool:
        """A tensor of the step's device, not a scalar: a few bytes, and
        the optimizer's step scalars sit on the host whatever the device."""
        return isinstance(t, torch.Tensor) and t.device == self.device \
            and t.dim() > 0

    def hold(self, tensors) -> int:
        for t in tensors:
            if self._mine(t):
                self._track(t)
        return self.upper

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        old = self.live.get(key)
        if old is not None:
            if not old[0].expired():
                return
            self.upper -= old[1]
        n = st.nbytes()
        self.live[key] = (StorageWeakRef(st), n)
        self.upper += n
        if self.upper > self.peak + (self.peak >> 8):
            # ``upper`` also counts storages freed since the last sweep:
            # sweep when it passes the peak by 1/256 of it (the peak read
            # is at most that much below the true one)
            for k in [k for k, (w, _) in self.live.items() if w.expired()]:
                self.upper -= self.live.pop(k)[1]
            self.peak = max(self.peak, self.upper)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if self._mine(t)]
        if not func.is_view and func.__name__.split(".")[0] not in self.SKIP:
            ins = [t for t in tree_leaves((args, kwargs)) if self._mine(t)]
            self.traffic += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def measure(step: Callable[[], object], held: list, device) -> dict:
    """``step()`` under ``FlopCounterMode`` and a ``StepMeter`` holding
    ``held`` (the arguments; the list is emptied), on the plain
    attention: its FLOPs, argument and peak bytes, and the bytes its ops
    move."""
    meter = StepMeter(device)
    args = meter.hold(held)
    held.clear()          # a replaced argument (AdamW's moments) may free
    counter = FlopCounterMode(display=False)
    with kernel_backend("torch"), counter, meter:
        step()
    return {"flops": int(counter.get_total_flops()), "argument_bytes": args,
            "peak_bytes": meter.peak, "traffic_bytes": meter.traffic}


# ---------------------------------------------------------------------------
# input specs (meta tensors: no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: InputShape, *,
                dtype=torch.bfloat16, batch: Optional[int] = None,
                device="meta") -> dict:
    """A train or prefill batch as the port's ``make_batch_fn`` types it
    (int64 tokens and labels; the vlm's ``vision`` and audio's ``frames``
    in ``dtype``), ``batch`` rows (default the global batch)."""
    b = shape.global_batch if batch is None else batch
    s = shape.seq_len

    def ints(*sh):
        return torch.zeros(sh, dtype=torch.int64, device=device)
    if cfg.family == "audio":
        return {"frames": torch.zeros((b, s, cfg.frontend_stub_dim),
                                      dtype=dtype, device=device),
                "labels": ints(b, s)}
    out = {"tokens": ints(b, s), "labels": ints(b, s)}
    if cfg.family == "vlm":
        out["vision"] = torch.zeros((b, cfg.num_vision_tokens, cfg.d_model),
                                    dtype=dtype, device=device)
    return out


def decode_specs(cfg: ArchConfig, shape: InputShape, *,
                 dtype=torch.bfloat16, batch: Optional[int] = None,
                 device="meta", window: Optional[int] = None):
    """(tokens (b, 1), pos, cache) for a serve step at the cache's last
    position; the cache is a rank's share under the installed model
    axis (``T.init_cache``), a ring of ``window`` (default
    ``long_window_for``'s)."""
    b = shape.global_batch if batch is None else batch
    window = long_window_for(cfg, shape) if window is None else window
    cache = T.init_cache(cfg, b, shape.seq_len, dtype,
                         window_override=window, device=device)
    tokens = torch.zeros((b, 1), dtype=torch.int64, device=device)
    return tokens, shape.seq_len - 1, cache


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, *, remat: bool = True, lr: float = 3e-4,
                    opt_state_dtype=None):
    """``(step(model, opt_state, batch) -> (opt_state, loss), opt)``: one
    ``launch.train.make_train_step`` AdamW step, the trainer's own."""
    from repro_torch.launch import train as TR
    opt = adamw(lr, state_dtype=opt_state_dtype)

    def train_step(model, opt_state, batch):
        return TR.make_train_step(model, opt, remat=remat)(opt_state, batch)
    return train_step, opt


def make_serve_step(cfg: ArchConfig, window: Optional[int]):
    @torch.no_grad()
    def serve_step(model, tokens, cache, pos):
        logits, cache = T.decode_step(model, tokens, cache, pos,
                                      window_override=window)
        return torch.argmax(logits[:, -1], dim=-1), cache
    return serve_step


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(model, batch):
        if cfg.family == "audio":
            return model(frames=batch["frames"])
        kw = {"vision": batch["vision"]} if cfg.family == "vlm" else {}
        return model(batch["tokens"], **kw)
    return prefill_step


# ---------------------------------------------------------------------------
# one rank's step, counted
# ---------------------------------------------------------------------------

def build_model(cfg: ArchConfig, *, dtype=torch.bfloat16, device="meta",
                seed: int = 0) -> T.Transformer:
    """``cfg``'s model on ``device`` in ``dtype`` (off the meta device
    drawn from ``seed``)."""
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    return T.Transformer(cfg, generator=gen, device=device).to(dtype)


def whole_leaves(model: T.Transformer) -> List[tuple]:
    """(leaf name, whole shape) of every parameter, in order."""
    return [(n.rsplit(".", 1)[-1], tuple(p.shape))
            for n, p in model.named_parameters()]


def loops_for(cfg: ArchConfig, mode: str, seq: int) -> List[dict]:
    """The step's loops and their trips at length ``seq`` (decode: one
    position). Each runs every trip, so none has a body's collectives to
    multiply (``hlo_analysis``)."""
    s = 1 if mode == "decode" else seq
    loops = [{"name": "blocks", "trips": len_groups(cfg)}]
    if cfg.family == "ssm":
        chunks = -(-s // min(SSM.CHUNK, s))
        loops += [{"name": "mlstm_chunks", "trips": chunks},
                  {"name": "slstm_time", "trips": s}]
    if cfg.family == "hybrid" and s > 1:
        loops.append({"name": "rglru_doubling",
                      "trips": math.ceil(math.log2(s))})
    return loops


def len_groups(cfg: ArchConfig) -> int:
    """The model's blocks: layers, or groups of them (ssm, hybrid, vlm)."""
    per = {"ssm": 2, "hybrid": cfg.hybrid_period,
           "vlm": cfg.cross_attn_every}.get(cfg.family, 1)
    return cfg.num_layers // per


def count_step(cfg: ArchConfig, mode: str, batch: int, seq: int, *,
               dtype=torch.bfloat16, mesh: Optional[ClientMesh] = None,
               device="meta", remat: bool = True, opt_state_dtype=None,
               distinct: Optional[int] = None,
               window: Optional[int] = None, data=None) -> dict:
    """One ``mode`` step ("train", "prefill" or "decode": one token at a
    cache of ``seq``) of ``cfg`` at ``batch`` rows, on ``device`` (meta,
    or real tensors drawn from seed 0), this rank's share under ``mesh``
    (a ``RecordingMesh``, or a live mesh under ``recorded``):
    ``measure``'s numbers, the recorded collectives and the parameter
    bytes. ``distinct``: the distinct tokens ``_EmbedRows`` counts on
    meta; ``data``: the batch (or ``(tokens, pos, cache)``) to use."""
    shape = InputShape(name="count", seq_len=seq, global_batch=batch,
                       mode=mode)
    with sharding.model_parallel(mesh), T.meta_distinct_tokens(distinct):
        model = build_model(cfg, dtype=dtype, device=device)
        leaves = whole_leaves(model)
        if mesh is not None:
            model.shard(mesh)
        params = list(model.parameters())
        record = getattr(mesh, "record", None)
        if record is not None:
            record.clear()
        if mode == "train":
            step, opt = make_train_step(cfg, remat=remat,
                                        opt_state_dtype=opt_state_dtype)
            state = opt.init(params)
            inputs = data if data is not None else input_specs(
                cfg, shape, dtype=dtype, device=device)
            held = params + state["m"] + state["v"] + list(inputs.values())
            out = measure(lambda: step(model, state, inputs), held, device)
            out["opt_bytes"] = sum(t.numel() * t.element_size()
                                   for t in state["m"] + state["v"])
        elif mode == "prefill":
            step = make_prefill_step(cfg)
            inputs = data if data is not None else input_specs(
                cfg, shape, dtype=dtype, device=device)
            inputs = {k: v for k, v in inputs.items() if k != "labels"}
            held = params + list(inputs.values())
            out = measure(lambda: step(model, inputs), held, device)
            out["opt_bytes"] = 0
        else:
            step = make_serve_step(cfg, window)
            tokens, pos, cache = data if data is not None else \
                decode_specs(cfg, shape, dtype=dtype, device=device,
                             window=window)
            held = params + [tokens] + tree_leaves(cache)
            out = measure(lambda: step(model, tokens, cache, pos), held,
                          device)
            out["opt_bytes"] = 0
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in params)
    out["leaves"] = leaves
    calls = list(record) if record is not None else []
    for axis in (mesh.axis_names if mesh is not None else ()):
        out[f"collective_bytes@{axis}"] = sum(c[3] for c in calls
                                              if c[1] == axis)
    out["record"] = {"collectives": calls, "loops": loops_for(cfg, mode, seq)}
    return out


def _exact(v):
    """A ``Fraction`` as an int where it is one, else a float."""
    return int(v) if v.denominator == 1 else float(v)


def _lagrange(xs, ys, x):
    """The polynomial through the points (``xs``, ``ys``) at ``x``, in
    exact rational arithmetic."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def extrapolate(points: Dict[tuple, dict], groups: int, seq: int) -> dict:
    """The counts at (``groups``, ``seq``) from counts at (groups, length)
    ``points``: two group counts, each at the same three lengths. Each
    count is affine in the groups and at most quadratic in the length
    (FLOPs, argument bytes and collectives are affine; the bytes ops move
    are not: the backward of each chunk's slice of the mLSTM's inputs
    writes a gradient as long as the sequence). ``peak_bytes`` is a lower
    bound: the peak at the larger group count, on the line through its
    two longest points (a maximum of affine functions of the length is
    convex in it, so the line's extension lies below it), plus the
    argument bytes the further groups add (their parameters and moments
    are live at every point of the step)."""
    gs, ss = (sorted({k[i] for k in points}) for i in (0, 1))

    def at(get):
        by_g = [_lagrange(ss, [get(points[(g, s)]) for s in ss], seq)
                for g in gs]
        return _exact(_lagrange(gs, by_g, groups))
    keys = [k for k, v in points[(gs[0], ss[0])].items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and k != "peak_bytes"]
    out = {k: at(lambda p, k=k: p[k]) for k in keys}
    out["collectives"] = {
        k: at(lambda p, k=k: collective_bytes_corrected(p["record"])[k])
        for k in (*COLL_KINDS, "count")}
    top = [points[(gs[-1], s)] for s in ss[-2:]]
    line = _lagrange(ss[-2:], [p["peak_bytes"] for p in top], seq)
    args = _lagrange(ss[-2:], [p["argument_bytes"] for p in top], seq)
    out["peak_bytes"] = _exact(line + out["argument_bytes"] - args)
    return out


# ---------------------------------------------------------------------------
# the FSDP terms, by formula
# ---------------------------------------------------------------------------

def _factor(spec, sizes, which=None) -> int:
    n = 1
    for a in spec:
        for ax in (a if isinstance(a, tuple) else (a,)):
            if ax is not None and (which is None or ax in which):
                n *= sizes[ax]
    return n


def fsdp_terms(leaves, mesh, *, elsize: int, opt_elsize: int, fsdp: bool,
               train: bool) -> dict:
    """A rank's parameter and AdamW bytes under ``launch.mesh.param_spec``
    and ``opt_state_shardings``' rule (``leaves``: (name, whole shape)),
    and, for a train step, the data-parallel collectives a step adds:
    FSDP all-gathers of a leaf split over ``data`` (forward and backward,
    each the leaf's model block) and its gradient's reduce-scatter (the
    rank's shard); an all-reduce over ``data`` of every other leaf's
    gradient; over ``pod``, an all-reduce of each gradient shard."""
    sizes = mesh.shape
    param = opt = 0
    calls: List[tuple] = []
    data = sizes.get("data", 1)
    for name, shape in leaves:
        numel = int(np.prod(shape))
        spec = M.param_spec(tuple(shape), mesh, fsdp=fsdp, name=name)
        shard = numel // _factor(spec, sizes)
        param += shard * elsize
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for p in parts if p
                for a in (p if isinstance(p, tuple) else (p,))}
        ospec = parts
        if fsdp and data > 1 and "data" not in used:
            cands = [i for i in range(len(shape)) if parts[i] is None
                     and shape[i] >= data and shape[i] % data == 0]
            if cands:
                ospec = list(parts)
                ospec[max(cands, key=lambda i: shape[i])] = "data"
        opt += numel // _factor(ospec, sizes) * opt_elsize
        if not train:
            continue
        block = numel // _factor(spec, sizes, ("model",)) * elsize
        if "data" in used:
            calls += [("all-gather", "data", shard * elsize, block)] * 2
            calls.append(("reduce-scatter", "data", block, shard * elsize))
        elif data > 1:
            calls.append(("all-reduce", "data", shard * elsize,
                          shard * elsize))
        if "pod" in sizes:
            calls.append(("all-reduce", "pod", shard * elsize,
                          shard * elsize))
    return {"param_bytes": param, "opt_bytes": opt, "collectives": calls}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def roofline(counted: dict, coll_seconds: float, coll_bytes: float,
             n_chips: int, model_flops: float, analytic, *,
             dtype=torch.bfloat16) -> dict:
    """The three roofline terms (seconds) of rank 0's step: its counted
    FLOPs at the card's peak for ``dtype``, the bytes its ops move at the
    HBM rate, its collectives at their links' rates (``coll_seconds``);
    the reference's analytic terms beside them."""
    peak = peak_flops(dtype)
    t_compute = counted["flops"] / peak
    t_memory = counted["traffic_bytes"] / HBM_BW
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", coll_seconds)), key=lambda kv: kv[1])[0]
    total = counted["flops"] * n_chips
    return {
        "analytic_flops_global": analytic.flops,
        "analytic_hbm_bytes_global": analytic.hbm_bytes,
        "analytic_t_compute_s": analytic.flops / n_chips / peak,
        "analytic_t_memory_s": analytic.hbm_bytes / n_chips / HBM_BW,
        "counted_flops_per_rank": counted["flops"],
        "counted_bytes_per_rank": counted["traffic_bytes"],
        "collective_bytes_per_device": coll_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": coll_seconds,
        "bottleneck": dom,
        "model_flops_total": model_flops,
        "useful_flops_ratio": model_flops / total if total else 0.0,
        "analytic_useful_flops_ratio": (model_flops / analytic.flops
                                        if analytic.flops else 0.0),
    }


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def rank_counts(cfg, shape, b, *, mesh, dtype=torch.bfloat16, remat=True,
                opt_state_dtype=None, window=None, points=None,
                device="meta") -> dict:
    """``count_step`` of the cell on rank 0; the ssm family's train and
    prefill cells extrapolated from ``points`` (default ``ssm_points()``,
    ``extrapolate``)."""
    points = ssm_points() if points is None else points
    kw = dict(dtype=dtype, mesh=mesh, remat=remat,
              opt_state_dtype=opt_state_dtype, window=window, device=device)
    if cfg.family != "ssm" or shape.mode == "decode" \
            or shape.seq_len <= points[-1][1]:
        out = count_step(cfg, shape.mode, b, shape.seq_len, **kw)
        out["collectives"] = collective_bytes_corrected(out["record"])
        out["extrapolated_from"] = None
        return out
    at = {}
    for g, s in points:
        small = dataclasses.replace(cfg, num_layers=2 * g)
        at[(g, s)] = count_step(small, shape.mode, b, s, **kw)
    out = extrapolate(at, len_groups(cfg), shape.seq_len)
    out["record"] = {"collectives": at[points[-1]]["record"]["collectives"],
                     "loops": loops_for(cfg, shape.mode, shape.seq_len)}
    out["leaves"] = whole_leaves(T.Transformer(cfg, device="meta"))
    out["extrapolated_from"] = [list(k) for k in points]
    return out


def dryrun_one(arch_name: str, shape_name: str, *, multi_pod: bool = False,
               remat: bool = True, fsdp: bool = True, verbose: bool = True,
               opt_state_dtype=None, profile: str = "2d",
               chunk_q: int = 0, slstm_unroll: int = 1,
               bf16_psum: bool = False, dtype=torch.bfloat16) -> dict:
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    skip = SKIPS.get((cfg.name, shape.name))
    if skip:
        return {"arch": cfg.name, "shape": shape.name, "skipped": skip}

    layout, axes = M.production_layout(multi_pod=multi_pod)
    sizes = dict(zip(axes, layout))
    n_chips = int(np.prod(layout))
    if profile == "dp":
        fsdp = False
    if shape.mode == "decode":
        # serving has no optimizer state: no FSDP, as the reference
        fsdp = False
    baxes = [a for a in (("pod", "data", "model") if profile == "dp"
                         else ("pod", "data")) if a in sizes]
    bsize = int(np.prod([sizes[a] for a in baxes]))
    b = (shape.global_batch // bsize if shape.global_batch % bsize == 0
         else shape.global_batch)
    # the step runs on the model axis alone, as the port's (clients,
    # model) meshes place a model (``fed.mesh.model_split``): a data axis
    # would turn the reference's FSDP templates on there; pod and data
    # split the batch, and their collectives come by formula
    mesh = RecordingMesh((1, 1 if profile == "dp" else sizes["model"]),
                         ("data", "model"))
    window = long_window_for(cfg, shape)
    set_attention_options(chunk_q=chunk_q, bf16_psum=bf16_psum)
    SSM.set_slstm_unroll(slstm_unroll)
    t0 = time.perf_counter()
    try:
        counted = rank_counts(cfg, shape, b, mesh=mesh, dtype=dtype,
                              remat=remat, opt_state_dtype=opt_state_dtype,
                              window=window)
    finally:
        set_attention_options()
        SSM.set_slstm_unroll(1)
    run_s = time.perf_counter() - t0

    elsize = torch.empty((), dtype=dtype).element_size()
    opt_elsize = 2 * (torch.empty((), dtype=opt_state_dtype).element_size()
                      if opt_state_dtype is not None else 4)
    terms = fsdp_terms(counted["leaves"], RecordingMesh(layout, axes),
                       elsize=elsize, opt_elsize=opt_elsize, fsdp=fsdp,
                       train=shape.mode == "train")
    by_formula = empty_counts()
    for kind, _, _, out_b in terms["collectives"]:
        by_formula[kind] += out_b
        by_formula["count"] += 1
    recorded = counted["collectives"]
    total = {k: recorded[k] + by_formula[k] for k in (*COLL_KINDS, "count")}
    rec_s = sum(counted[f"collective_bytes@{a}"] / link_bw(layout, axes, a)
                for a in mesh.axis_names)
    form_s = sum(out_b / link_bw(layout, axes, axis)
                 for _, axis, _, out_b in terms["collectives"])

    if shape.mode == "train":
        model_flops = 6.0 * cfg.active_param_count() \
            * shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        model_flops = 2.0 * cfg.active_param_count() \
            * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * cfg.active_param_count() * shape.global_batch
    analytic = step_cost(cfg, shape, window=window,
                         opt_bytes_per_param=4.0 if opt_state_dtype else 8.0)
    rl = roofline(counted, rec_s + form_s,
                  float(sum(total[k] for k in COLL_KINDS)), n_chips,
                  model_flops, analytic, dtype=dtype)

    held = counted["param_bytes"] + counted["opt_bytes"]
    inputs = counted["argument_bytes"] - held
    if fsdp and shape.mode == "train":
        param_b, opt_b = terms["param_bytes"], terms["opt_bytes"]
    else:
        param_b, opt_b = counted["param_bytes"], counted["opt_bytes"]
    peak = counted["peak_bytes"] - held + param_b + opt_b
    result = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(f"{k}={v}" for k, v in sizes.items()),
        "n_chips": n_chips,
        "mode": shape.mode,
        "profile": profile,
        "fsdp": fsdp,
        "remat": remat,
        "chunk_q": chunk_q,
        "slstm_unroll": slstm_unroll,
        "bf16_psum": bf16_psum,
        "window_override": window,
        "rank_batch": b,
        "run_s": round(run_s, 1),
        "extrapolated_from": counted["extrapolated_from"],
        "collectives": total,
        "collectives_recorded": recorded,
        "by_formula": {"collectives": by_formula,
                       "param_bytes": terms["param_bytes"],
                       "opt_bytes": terms["opt_bytes"]},
        "loops": [list(x) for x in while_trip_counts(counted["record"])],
        "memory": {
            "argument_bytes": param_b + opt_b + inputs,
            "param_bytes": param_b,
            "opt_bytes": opt_b,
            "input_bytes": inputs,
            "peak_bytes": peak,
            "peak_bytes_measured": counted["peak_bytes"],
            # extrapolated: a lower bound (the peak is a maximum of affine
            # functions of the length, convex in it)
            "peak_is_lower_bound": counted["extrapolated_from"] is not None,
            "fits_hbm": peak <= HBM_BYTES,
        },
        **rl,
    }
    if verbose:
        print(json.dumps(result, default=str))
    return result


def table(results: List[dict]) -> List[str]:
    """Markdown rows of a run's results: one a cell of the single-pod
    layout, then one a family of the multi-pod layout."""
    def gb(b):
        return f"{b / 1e9:.3g}"
    rows = ["| arch | shape | FLOPs a rank: counted (analytic / ranks) "
            "| useful | argument / peak GB a rank | collectives: calls, GB "
            "| t compute / memory / collective s | bound |",
            "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    single = [r for r in results if "n_chips" in r and r["n_chips"] == 256]
    for r in single:
        m = r["memory"]
        peak = ("≥ " if m["peak_is_lower_bound"] else "") \
            + gb(m["peak_bytes"])
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['counted_flops_per_rank']:.3e}"
            f" ({r['analytic_flops_global'] / r['n_chips']:.3e}) | "
            f"{r['useful_flops_ratio']:.2f} | {gb(m['argument_bytes'])} / "
            f"{peak}{'' if m['fits_hbm'] else ' (no)'} | "
            f"{r['collectives']['count']}, "
            f"{gb(r['collective_bytes_per_device'])} | "
            f"{r['t_compute_s']:.3g} / {r['t_memory_s']:.3g} / "
            f"{r['t_collective_s']:.3g} | {r['bottleneck']} |")
    multi = [r for r in results if r.get("n_chips") == 512]
    for fam in ("dense", "moe", "vlm", "audio", "ssm", "hybrid"):
        cells = [r for r in multi if get_arch(r["arch"]).family == fam]
        if not cells:
            continue
        fits = sum(r["memory"]["fits_hbm"] for r in cells)
        worst = max(cells, key=lambda r: r["memory"]["peak_bytes"])
        dom = sorted({r["bottleneck"] for r in cells})
        rows.append(
            f"- (2, 16, 16), {fam} ({len(cells)} cells): "
            f"{fits} fit 80 GB; the largest peak "
            f"{gb(worst['memory']['peak_bytes'])} GB ({worst['arch']} "
            f"{worst['shape']}); bound by "
            f"{', '.join(dom)}; collective seconds "
            + ", ".join(f"{r['arch']} {r['shape']} {r['t_collective_s']:.3g}"
                        for r in cells if r["mode"] == "train"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on the "
                                             "meta device")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--opt-bf16", action="store_true",
                    help="bf16 AdamW state (memory lever for 405B)")
    ap.add_argument("--profile", default="2d", choices=sorted(PROFILES),
                    help="sharding profile (see models/sharding.py)")
    ap.add_argument("--chunk-q", type=int, default=0,
                    help="query-chunked attention tile (0 = whole)")
    ap.add_argument("--slstm-unroll", type=int, default=1,
                    help="kept from the reference; changes no count")
    ap.add_argument("--bf16-psum", action="store_true",
                    help="bf16 output on psum-feeding projections")
    ap.add_argument("--out", default="")
    ap.add_argument("--table", default="",
                    help="print the markdown table of a saved --out file")
    args = ap.parse_args(argv)
    if args.table:
        with open(args.table) as f:
            print("\n".join(table(json.load(f))))
        return

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                try:
                    r = dryrun_one(
                        a, s, multi_pod=mp, remat=not args.no_remat,
                        fsdp=not args.no_fsdp, profile=args.profile,
                        chunk_q=args.chunk_q,
                        slstm_unroll=args.slstm_unroll,
                        bf16_psum=args.bf16_psum,
                        opt_state_dtype=(torch.bfloat16 if args.opt_bf16
                                         else None))
                except Exception as e:  # record failures; they are bugs
                    r = {"arch": a, "shape": s, "multi_pod": mp,
                         "error": f"{type(e).__name__}: {e}"}
                    print(json.dumps(r, default=str))
                results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
    errs = [r for r in results if "error" in r]
    print(f"\n{len(results)} runs, {len(errs)} errors")
    if errs:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
