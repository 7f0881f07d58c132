"""Batched cohort engine: stacked clients, one batched step for all of them.

The loop engine (``repro_torch.core.protocol.LoopEngine``) drives clients
one at a time: a few dozen PyTorch ops and a host read of the loss per
client per SGD step. This engine stacks the clients of one architecture
into leading-axis ``(C, ...)`` parameter and optimizer-state tensors and
runs every round phase — local training, proxy logits, filter masks,
distillation, evaluation — as one batched forward (and backward) for all
C clients at a time: ``torch.func.vmap`` over ``functional_call`` of the
architecture's module, and for a cohort of one, the module itself. Losses
stay on the device and are read once per phase. It is the counterpart of
``repro.fed.cohort``, whose public names it keeps.

Homogeneous-cohort grouping rule
--------------------------------
Clients are grouped by ``Client.arch_key``: equal keys form one cohort, a
client with ``arch_key=None`` a cohort of its own. Members must share one
optimizer instance, one model structure, the temperature, the distill
loss, the class count and the resolved kernel backend. The image path's
Tables I/II zoo gives every client its own CNN (ten singleton cohorts);
the shared MLP zoo gives one cohort, the mixed zoo three.

Steps and gating
----------------
Each phase draws every member's epoch permutations from its own rng, as
the loop engine does, and packs them with ``padded_epoch_plan``: a client
with fewer samples than the cohort's largest has steps past its own that
are no-ops, and a short last batch is padded with zero-weight slots. A
step computes each client's loss separately (a weighted mean over its own
batch), backpropagates their sum (the lanes are independent, so each
stacked gradient slice is that client's gradient), and applies the
update per lane where the step is valid (``torch.where``, leaf by leaf
and in place), as the reference's ``scan_steps`` does.

Kernels
-------
The DRE fit of a cohort whose members share a configuration and a
private-set size is ``core.dre.learn_kmeans_batched``: one Lloyd-step
launch an iteration for every member, one estimation launch for every
member's calibration. The filter's estimation step is one launch a cohort
a report (KMeans-DRE), or two RBF Gram-matrix launches (KuLSIF-DRE, on the
shared proxy batch against every member's auxiliary and padded private
set); the KL distillation loss is one fused launch a cohort a step.

Wave streaming
--------------
``wave_size > 0`` bounds the device memory by the wave, not by C: the
cohort keeps its stacked data, parameters, optimizer state and filter
state on the host (numpy masters) and runs each phase ``wave_size``
clients at a time, the last wave padded with dummy lanes (copies of the
wave's first client whose steps never validate, cid -1, sentinel private
rows), writing each wave's results back before the next. Lanes are
independent, so waved results equal unwaved ones (bit for bit on the
CPU).

Partial participation
---------------------
``participants=`` (a (C,) bool mask over the fleet) makes each sampled-out
member a no-op lane: it draws no permutation from its rng (as the loop
engine, which skips it), every one of its steps is invalid, so
``torch.where`` leaves its parameters and momentum bitwise untouched, and
its report is zero logits, an all-False mask and zero class-wise counts.
The batched kernels still run over the whole cohort and the sampled-out
rows are gated after, as in the reference; a lane's result does not
depend on the others', so the participants' rows are bitwise what they
would be alone. The per-cohort entry points (``cohort_positions``,
``cohort_local_train``, ``cohort_report``, ...) drive one cohort at a
time for concurrent-cohort scheduling.

One copy of the state
---------------------
While an unwaved cohort owns the stacked state, its members' parameters
and momentum are views of their rows of it (``adopt_member_state``), so
the device holds the state once: ten granite-8b-wide token clients are
16.3 GiB of parameters, and a second copy would not fit beside their
momentum and gradients. ``state_dict`` syncs the stacked state (or a
waved cohort's host masters) back onto the clients and emits the loop
engine's per-client checkpoint; ``load_state_dict`` loads the clients and
re-stacks every cohort from them, so a checkpoint moves between the
engines and wave sizes.

Token (transformer) clients run here like any other architecture: the
flash-attention kernel's ``vmap`` rule folds the client axis into its
batch, one launch a layer for the cohort.

Device mesh
-----------
With a ``mesh`` (``repro_torch.fed.mesh``: one process a rank, every rank
running the same host program) each cohort pads its client axis (each
wave's, when waved) to a multiple of the client-axis size with dummy
lanes, and each rank holds only its contiguous block of lanes: the rows of
the stacked data, parameters, momentum and filter state, and on a 2-D
``(clients, model)`` mesh only its slice of each leaf
(``fed.mesh.model_split``). ``simulator.build_experiment`` places the
state before the engine exists (``owned_positions``, ``shard_member``):
every member's module holds shapes only (``meta``), an owned member's
slices wait on the device in ``Client.shard`` until the cohort stacks
them, and no host or device holds a lane this rank does not own. The
forward runs under
``models.sharding.model_parallel``: a transformer computes on its local
slices with collectives over the model axis; any other module gets its
split leaves gathered whole first. Every rank draws every member's batch
order, so the host streams agree everywhere. Per-client results that
leave the engine (losses, proxy logits, masks, class-wise means, eval
counts, learned DREs) are gathered over the client axis, so every rank's
server runs on the same whole inputs. ``state_dict`` gathers the stacked
state, a lane row of a leaf at a time, to the world's first rank alone,
in the loop engine's per-client layout; every other rank keeps its own
rows and slices (its restore point). ``load_state_dict`` takes each
rank's rows and slices from either. ``sync_to_clients`` gathers the
whole state to every rank's members, on request.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, vmap

from repro_torch.common.pytree import unstack_tree
from repro_torch.core import distill as D
from repro_torch.core.dre import (KMeansDRE, KuLSIFDRE, kmeans_id_masks,
                                  kulsif_id_masks, learn_kmeans_batched)
from repro_torch.core.protocol import client_generator
from repro_torch.data.synthetic import sample_tensor
from repro_torch.fed import mesh as M
from repro_torch.fed.batching import padded_epoch_plan, steps_per_epoch
from repro_torch.fed.state import (check_clients_entries, clients_state_dict,
                                   load_clients_state_dict, load_rng_state,
                                   rng_state_dict)
from repro_torch.kernels import dispatch
from repro_torch.models import sharding


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gate(out: torch.Tensor, part) -> torch.Tensor:
    """Zero (or False) the rows of the members ``part`` samples out."""
    if part is None:
        return out
    keep = torch.as_tensor(np.asarray(part, bool), device=out.device)
    return torch.where(keep.reshape((-1,) + (1,) * (out.ndim - 1)), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


class _OneLane(list):
    """A cohort of one's parameters, unstacked: views of its (1, ...)
    state, which its forward reads and its gradients are taken for (no
    stacking op in the backward)."""


def cohort_groups(keys: Sequence) -> List[List[int]]:
    """Client positions grouped by architecture key, in order of first
    appearance (``None``: a cohort of its own): the engine's cohorts."""
    groups: Dict[object, List[int]] = {}
    for pos, key in enumerate(keys):
        groups.setdefault(key if key is not None else ("solo", pos),
                          []).append(pos)
    return list(groups.values())


def rank_members(count: int, wave_size: int, mesh) -> List[int]:
    """The members (indices into a cohort of ``count``) whose lanes this
    rank holds, in any wave: each wave padded to a client-axis multiple,
    this rank's contiguous block of its lanes."""
    ws = wave_size if 0 < wave_size < count else count
    c_loc = M.padded_size(ws, mesh) // M.client_axis_size(mesh)
    k = mesh.coords[0] if mesh is not None else 0
    return [i for lo in range(0, count, ws)
            for i in range(lo + k * c_loc,
                           min(lo + (k + 1) * c_loc, lo + ws, count))]


def owned_positions(keys: Sequence, wave_size: int, mesh) -> set:
    """The client positions whose lanes live on this rank of ``mesh`` (a
    layout will do: ``fed.mesh.build_client_mesh(..., groups=False)``),
    for clients of architecture keys ``keys``."""
    return {group[i] for group in cohort_groups(keys)
            for i in rank_members(len(group), wave_size, mesh)}


def shard_member(model: nn.Module, mesh, owned: bool, device):
    """Under a mesh, before the engine exists: an owned member's slice of
    each leaf (``fed.mesh.model_split``) copied to ``device``, returned for
    ``Client.shard``; every parameter of ``model`` itself becomes shapes
    only (``meta``), owned or not, so the module is the cohort's structure
    and holds no state (its buffers stay)."""
    keep = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            if owned:
                s = M.model_split(name.split(".")[-1], p.shape, mesh)
                t = p if s is None else M.model_block(p, s, mesh)
                keep.append(t.to(device, copy=True))
        for mod in model.modules():
            for name, p in mod._parameters.items():
                if p is not None:
                    mod._parameters[name] = nn.Parameter(
                        torch.empty_like(p, device="meta"),
                        requires_grad=p.requires_grad)
    return keep if owned else None


def _rebind(c, params, mu) -> None:
    """Member ``c``'s parameters made ``params`` (whole, in place of
    shapes-only ones too) and its momentum ``mu``."""
    for p, v in zip(c.params, params):
        if p.is_meta:
            torch.utils.swap_tensors(p, nn.Parameter(
                v, requires_grad=p.requires_grad))
        else:
            p.data = v
    c.opt_state["mu"] = list(mu)


class _Cohort:
    """One architecture group: stacked state and its batched round phases."""

    def __init__(self, members: Sequence, positions: Sequence[int],
                 wave_size: int = 0, mesh=None):
        self.members = list(members)
        self.positions = list(positions)     # index into the global list
        if wave_size < 0:
            raise ValueError(f"wave_size must be >= 0, got {wave_size!r}")
        c0 = self.members[0]
        shapes0 = [tuple(p.shape) for p in c0.params]
        for c in self.members[1:]:
            if c.opt is not c0.opt:
                raise ValueError(
                    f"cohort members {c0.cid} and {c.cid} share arch_key "
                    f"{c0.arch_key!r} but hold distinct Optimizer instances; "
                    "construct one optimizer and pass it to every member "
                    "(or give them distinct arch_keys)")
            if (type(c.model) is not type(c0.model)
                    or [tuple(p.shape) for p in c.params] != shapes0):
                raise ValueError(
                    f"cohort members {c0.cid} and {c.cid} share arch_key "
                    f"{c0.arch_key!r} but hold different model structures; "
                    "the cohort would run member 0's network for everyone "
                    "(give them distinct arch_keys)")
            for attr in ("temperature", "distill_loss", "num_classes"):
                if getattr(c, attr) != getattr(c0, attr):
                    raise ValueError(
                        f"cohort members {c0.cid} and {c.cid} share arch_key "
                        f"{c0.arch_key!r} but differ in {attr}: "
                        f"{getattr(c0, attr)!r} vs {getattr(c, attr)!r}")
            if (dispatch.resolve(c.kernel_backend)
                    != dispatch.resolve(c0.kernel_backend)):
                raise ValueError(
                    f"cohort members {c0.cid} and {c.cid} share arch_key "
                    f"{c0.arch_key!r} but resolve to different kernel "
                    f"backends: {c0.kernel_backend!r} vs "
                    f"{c.kernel_backend!r}")
        C = len(self.members)
        # wave streaming only when it splits the cohort
        self._waved = 0 < wave_size < C
        self.wave_size = wave_size if self._waved else C
        # the mesh: a wave's lanes padded to a client-axis multiple, this
        # rank's contiguous block of them
        self.mesh = mesh
        self.c_pad = M.padded_size(self.wave_size, mesh)
        self.c_loc = self.c_pad // M.client_axis_size(mesh)
        self._k = mesh.coords[0] if mesh is not None else 0
        self.model = c0.model                 # the structure every lane runs
        self.names = [name for name, _ in self.model.named_parameters()]
        self.device = c0.device
        self.opt = c0.opt
        self.temperature = c0.temperature
        self.loss_kind = c0.distill_loss
        self.num_classes = c0.num_classes
        self.kernel_backend = dispatch.resolve(c0.kernel_backend)

        self.n = np.array([len(c.y) for c in self.members], np.int64)
        n_max = int(self.n.max())
        # each leaf's dim split over the model axis (None: whole)
        self._split = [M.model_split(name.split(".")[-1], p.shape, mesh)
                       for name, p in zip(self.names, c0.params)]
        self._mp_native = getattr(self.model, "model_parallel", False)
        # a waved cohort's host masters hold this rank's members alone:
        # member i's row (-1: a member of another rank)
        self._rows = np.full(C, -1, np.int64)
        self._rows[self._owned()] = np.arange(len(self._owned()))
        self._buffers = {}
        if mesh is not None:
            # the structure module stays on the host: its buffers (the
            # CNN's eval-mode statistics) go to the device with each call
            self._buffers = {n: b.to(self.device)
                             for n, b in self.model.named_buffers()}
            for i in self._owned():
                c = self.members[i]
                c._x, c._y = c._x.to(self.device), c._y.to(self.device)
        if mesh is not None and not self._waved:
            # this rank's lanes only; dummy lanes hold zeros
            lanes = self._lanes(0, C)
            x0 = c0._x
            x = torch.zeros((self.c_loc, n_max, *x0.shape[1:]),
                            dtype=x0.dtype, device=self.device)
            y = torch.zeros((self.c_loc, n_max), dtype=torch.int64,
                            device=self.device)
            m = torch.zeros((self.c_loc, n_max), dtype=torch.float32,
                            device=self.device)
            for j, i in enumerate(lanes):
                if i >= 0:
                    c = self.members[i]
                    x[j, : self.n[i]] = c._x
                    y[j, : self.n[i]] = c._y
                    m[j, : self.n[i]] = 1.0
        elif C == 1 and not self._waved:
            # a cohort of one reads its client's own tensors
            x, y = c0._x[None], c0._y[None]
            m = torch.ones((1, n_max), dtype=torch.float32,
                           device=self.device)
        else:
            # waved masters are stacked on the host
            x0, dev = c0._x, "cpu" if self._waved else self.device
            x = torch.zeros((C, n_max, *x0.shape[1:]), dtype=x0.dtype,
                            device=dev)
            y = torch.zeros((C, n_max), dtype=torch.int64, device=dev)
            m = torch.zeros((C, n_max), dtype=torch.float32, device=dev)
            for i, c in enumerate(self.members):
                x[i, : self.n[i]] = c._x
                y[i, : self.n[i]] = c._y
                m[i, : self.n[i]] = 1.0
        if self._waved:
            # the masters live on the host; a phase stages one wave at a
            # time (``_stage``)
            self.x = _np(x)
            self.y, self.sample_mask = _np(y), _np(m)
        else:
            self.x, self.y, self.sample_mask = x, y, m
        self.adopt_member_state()
        self.filter_kind = "none"
        self._filter_state: Dict[str, object] = {}
        self._pack_learned_filter_state()

    # ------------------------------------------------------- stacked state
    def adopt_member_state(self) -> None:
        """Stack the members' parameters and optimizer state leaf by leaf —
        at construction, and as the inverse of ``sync_to_clients`` (after
        ``load_state_dict``). In waved mode the stacked masters are host
        numpy and the members keep their own tensors. Unwaved, each
        member's parameters and momentum are rebound to views of its row
        of the stacked device tensors, so the device holds one copy of the
        state, and stacking peaks at the state plus one leaf of parameters
        and one of momentum."""
        if self.mesh is not None and not self._waved:
            self._adopt_local()
            return
        C = len(self.members)
        step = torch.tensor([c.opt_state["step"] for c in self.members],
                            dtype=torch.int64, device=self.device)
        if self.mesh is not None:
            # waved under a mesh: this rank's members' slices alone
            own = self._owned()
            self.params = [np.stack([_np(self._member_leaf(i, j, False))
                                     for i in own])
                           for j in range(len(self.names))]
            self.opt_state = {"mu": [np.stack([_np(self._member_leaf(
                i, j, True)) for i in own]) for j in range(len(self.names))],
                "step": _np(step)}
            for i in own:
                self.members[i].shard = None
            return

        def stack(leaves):
            if self._waved:
                return np.stack([_np(t) for t in leaves])
            out = torch.empty((C, *leaves[0].shape), dtype=leaves[0].dtype,
                              device=self.device)
            with torch.no_grad():
                for i, t in enumerate(leaves):
                    out[i].copy_(t)
            return out
        params, mu = [], []
        for j in range(len(self.names)):
            params.append(stack([c.params[j].detach() for c in self.members]))
            mu.append(stack([c.opt_state["mu"][j] for c in self.members]))
            if not self._waved:
                # the members' own tensors of leaf j are freed here
                for i, c in enumerate(self.members):
                    c.params[j].data = params[j][i]
                    c.opt_state["mu"][j] = mu[j][i]
        if self._waved:
            self.params = params
            self.opt_state = {"mu": mu, "step": _np(step)}
        else:
            self.params = [p.requires_grad_(True) for p in params]
            self.opt_state = {"mu": mu, "step": step}

    def _member_leaf(self, i: int, j: int, mu: bool) -> torch.Tensor:
        """This rank's slice of member ``i``'s leaf ``j`` (its momentum
        with ``mu``): from ``Client.shard`` (the slices placed at build or
        load; momentum None there is zero), else sliced from the member's
        whole tensors (after ``sync_to_clients``)."""
        c = self.members[i]
        shard = getattr(c, "shard", None)
        if shard is not None:
            if shard["mu"] is None and mu:
                return torch.zeros_like(shard["params"][j])
            return shard["mu" if mu else "params"][j]
        return self._mslice((c.opt_state["mu"][j] if mu
                             else c.params[j]).detach(), j)

    def _adopt_local(self) -> None:
        """Under a mesh, unwaved: this rank's lanes of every leaf (its
        model slice on a 2-D mesh) stacked on the device, leaf by leaf,
        each member's slice dropped once it is stacked; dummy lanes hold
        zeros."""
        lanes = self._lanes(0, len(self.members))
        step = torch.tensor([self.members[i].opt_state["step"] if i >= 0
                             else 0 for i in lanes],
                            dtype=torch.int64, device=self.device)

        def stack(j, mu):
            # the local shape, from the structure when no lane is real
            shape = self._mslice(self.members[0].params[j], j).shape
            out = torch.zeros((len(lanes), *shape),
                              dtype=self.members[0].params[j].dtype,
                              device=self.device)
            key = "mu" if mu else "params"
            for r, i in enumerate(lanes):
                shard = None if i < 0 else getattr(self.members[i], "shard",
                                                   None)
                if i < 0 or (shard is not None and shard[key] is None):
                    continue      # zeros: a dummy lane or a fresh momentum
                out[r].copy_(self._member_leaf(i, j, mu))
                if shard is not None:
                    shard[key][j] = None
            return out
        with torch.no_grad():
            params = [stack(j, False) for j in range(len(self.names))]
            mu = [stack(j, True) for j in range(len(self.names))]
        for i in lanes[lanes >= 0]:
            self.members[i].shard = None
        self.params = [p.requires_grad_(True) for p in params]
        self.opt_state = {"mu": mu, "step": step}

    def sync_to_clients(self) -> None:
        """Write the stacked parameters and optimizer state back onto the
        member ``Client`` objects (unwaved: rebind them to views of the
        stacked state, which copies nothing; under a mesh: gather every
        rank's lanes and slices, wave by wave, through the host)."""
        if self.mesh is not None:
            self._sync_gathered()
            return
        with torch.no_grad():
            for i, c in enumerate(self.members):
                if self._waved:
                    for p, s in zip(c.params, unstack_tree(self.params, i)):
                        p.copy_(torch.as_tensor(s))
                    mu = [torch.as_tensor(v[i]).to(self.device).clone()
                          for v in self.opt_state["mu"]]
                else:
                    for p, s in zip(c.params, self.params):
                        p.data = s.detach()[i]
                    mu = unstack_tree(self.opt_state["mu"], i)
                c.opt_state = {"mu": mu,
                               "step": int(self.opt_state["step"][i])}

    def _sync_gathered(self) -> None:
        """``sync_to_clients`` under a mesh: every leaf gathered whole to
        every rank's host (``gathered``), the members' shapes-only
        parameters made whole."""
        J = len(self.names)
        got = {i: ([None] * J, [None] * J) for i in range(len(self.members))}
        for lo, hi, j, p, mu, step in self.gathered(root=False):
            for r in range(hi - lo):
                got[lo + r][0][j], got[lo + r][1][j] = p[r], mu[r]
                self.members[lo + r].opt_state["step"] = int(step[r])
        with torch.no_grad():
            for i, (p, mu) in got.items():
                _rebind(self.members[i], p, mu)

    def gathered(self, root: bool = True):
        """The stacked state gathered whole to the host, a lane row of a
        leaf at a time, so a device holds at most one row of a leaf from
        every rank of the client axis: yields ``(lo, hi, j, params, mu,
        step)`` for each wave ``[lo, hi)`` and leaf ``j`` (``(hi - lo,
        ...)`` host tensors and the wave's steps), on every rank, or with
        ``root`` on the world's first rank alone (``None`` elsewhere).
        Every rank of the mesh iterates it to the end (its collectives)."""
        mesh, ax = self.mesh, M.model_axis_name(self.mesh)
        # to the root: a rank off the model axis's first line takes part
        # in the model axis's gathers alone
        sit_out = root and ax is not None and mesh.coord(ax) != 0

        def whole(t, j):
            s, rows = self._split[j], []
            for r in range(t.shape[0]):
                x = t[r:r + 1]
                if s is not None:
                    x = mesh.gather(x, ax, s + 1, to="cpu", root=root)
                if not sit_out:
                    # lanes k·c_loc + r of every rank k of the client axis
                    rows.append(mesh.gather(x, M.DEFAULT_CLIENT_AXIS, 0,
                                            to="cpu", root=root))
            if sit_out or rows[0] is None:
                return None
            out = torch.stack(rows, 1)
            return out.reshape(-1, *out.shape[2:])
        with torch.no_grad():
            for lo, hi in self._waves():
                params, opt = self._stage_state(lo, hi)
                step = None if sit_out else mesh.gather(
                    opt["step"], M.DEFAULT_CLIENT_AXIS, 0, to="cpu",
                    root=root)
                step = None if step is None else _np(step)
                for j in range(len(self.names)):
                    p = whole(params[j].detach(), j)
                    mu = whole(opt["mu"][j], j)
                    yield lo, hi, j, p, mu, step
                    del p, mu

    def local_state(self) -> Dict:
        """This rank's rows and slices of the stacked state, host copies
        (a mesh rank's restore point: ``load_local_state``)."""
        def host(t):
            return np.array(_np(t.detach()) if isinstance(t, torch.Tensor)
                            else t, copy=True)
        return {"params": [host(p) for p in self.params],
                "mu": [host(v) for v in self.opt_state["mu"]],
                "step": host(self.opt_state["step"])}

    def load_local_state(self, st: Dict) -> None:
        """Restore ``local_state`` output taken on this rank's layout."""
        mine = self.local_state()
        for key in ("params", "mu"):
            got = [tuple(np.shape(a)) for a in st[key]]
            if got != [a.shape for a in mine[key]]:
                raise ValueError(
                    f"a rank's state of shapes {got} does not fit this "
                    f"rank's layout {[a.shape for a in mine[key]]}")
        if self._waved:
            self.params = [np.array(a, copy=True) for a in st["params"]]
            self.opt_state = {"mu": [np.array(a, copy=True)
                                     for a in st["mu"]],
                              "step": np.array(st["step"], copy=True)}
            return
        self.params = [torch.tensor(a, device=self.device)
                       .requires_grad_(True) for a in st["params"]]
        self.opt_state = {"mu": [torch.tensor(a, device=self.device)
                                 for a in st["mu"]],
                          "step": torch.tensor(st["step"],
                                               device=self.device)}

    def load_members(self, entries: Sequence[Dict]) -> None:
        """Under a mesh: this rank's rows and slices of the members' whole
        checkpoint ``entries`` (one a member), each owned member read
        whole on the host one at a time, then stacked."""
        for i in self._owned():
            c = self.members[i]
            pw = [torch.zeros(p.shape, dtype=p.dtype) for p in c.params]
            mw = [torch.zeros(p.shape, dtype=p.dtype) for p in c.params]
            c.opt_state["step"] = c.read_state(entries[i], pw, mw,
                                               source=f"client {c.cid}")
            c.shard = {key: [self._mslice(t, j).to(self.device, copy=True)
                             for j, t in enumerate(ts)]
                       for key, ts in (("params", pw), ("mu", mw))}
            del pw, mw
        self.adopt_member_state()

    # ------------------------------------------------------------ the mesh
    def _lanes(self, lo: int, hi: int) -> np.ndarray:
        """The member index of each of this rank's lanes of wave
        ``[lo, hi)``, -1 for a dummy lane."""
        base = lo + self._k * self.c_loc
        idx = np.arange(base, base + self.c_loc)
        return np.where(idx < hi, idx, -1)

    def _owned(self) -> List[int]:
        """The members whose lanes live on this rank, in any wave."""
        return [int(i) for lo, hi in self._waves()
                for i in self._lanes(lo, hi) if i >= 0]

    def _collect(self, t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """A wave's per-lane results, whole over the client axis, its
        dummy lanes dropped."""
        if self.mesh is not None:
            t = self.mesh.gather(t, M.DEFAULT_CLIENT_AXIS, 0)
        return t[: hi - lo]

    def _mslice(self, t, j: int, stacked: bool = False):
        """This rank's model slice of leaf ``j`` (an unstacked leaf, or a
        stacked one's rows with ``stacked``)."""
        s = self._split[j]
        return t if s is None else M.model_block(t, s + int(stacked),
                                                 self.mesh)

    # ------------------------------------------------------ wave streaming
    def _waves(self):
        """The ``[lo, hi)`` member ranges of each wave (one wave covering
        the cohort when it is not waved)."""
        C = len(self.members)
        for lo in range(0, C, self.wave_size):
            yield lo, min(lo + self.wave_size, C)

    def _stage(self, arr, lo: int, hi: int, fill=0) -> torch.Tensor:
        """This rank's lanes of wave ``[lo, hi)`` of a stacked host array
        as a device tensor (a device tensor, or unwaved without a mesh the
        whole array, as it is). Dummy lanes hold ``fill``, or with
        ``None`` a copy of row ``lo`` (state ballast, never read back)."""
        if isinstance(arr, torch.Tensor) or (not self._waved
                                             and self.mesh is None):
            return torch.as_tensor(arr, device=self.device)
        arr = np.asarray(arr)
        lanes = self._lanes(lo, hi)
        real = lanes >= 0
        if real.all():
            out = arr[lanes]
        elif fill is None:
            out = arr[np.where(real, lanes, lo)]
        else:
            out = np.full((len(lanes), *arr.shape[1:]), fill, arr.dtype)
            out[real] = arr[lanes[real]]
        return torch.as_tensor(out, device=self.device)

    def _stage_master(self, arr: np.ndarray, lo: int, hi: int
                      ) -> torch.Tensor:
        """This rank's lanes of wave ``[lo, hi)`` of a waved master (rows
        ``_rows``) on the device; dummy lanes a copy of the wave's first
        real lane (state ballast, never read back), or zeros when the
        wave has none here."""
        lanes = self._lanes(lo, hi)
        real = lanes >= 0
        if not real.any():
            return torch.zeros((len(lanes), *arr.shape[1:]),
                               dtype=torch.from_numpy(arr[:0]).dtype,
                               device=self.device)
        rows = self._rows[np.where(real, lanes, lanes[real][0])]
        return torch.as_tensor(arr[rows], device=self.device)

    def _stage_state(self, lo: int, hi: int):
        if not self._waved:
            return self.params, self.opt_state
        params = [self._stage_master(p, lo, hi).requires_grad_(True)
                  for p in self.params]
        opt = {"mu": [self._stage_master(v, lo, hi)
                      for v in self.opt_state["mu"]],
               "step": self._stage(self.opt_state["step"], lo, hi,
                                   fill=None)}
        return params, opt

    def _write_state(self, params, opt, lo: int, hi: int) -> None:
        """A wave's trained state back to the host masters (dummy lanes
        dropped); unwaved, the device state was updated in place."""
        if not self._waved:
            return
        lanes = self._lanes(lo, hi)
        real = lanes >= 0
        rows = self._rows[lanes[real]]
        for h, d in zip(self.params, params):
            h[rows] = _np(d)[real]
        for h, d in zip(self.opt_state["mu"], opt["mu"]):
            h[rows] = _np(d)[real]
        self.opt_state["step"][lanes[real]] = _np(opt["step"])[real]

    # ------------------------------------------------------------ forwards
    def _forward(self, params: List[torch.Tensor], x: torch.Tensor,
                 train: bool, shared_x: bool = False) -> torch.Tensor:
        """Every lane's logits: x (C, B, ...) per lane, or (B, ...) shared
        by all (``shared_x``) -> (C, B, K). A cohort of one runs its module
        on its own parameters, as the loop engine does."""
        if self.model.training != train:
            self.model.train(train)
        one_lane = isinstance(params, _OneLane) or params[0].shape[0] == 1
        mp_mesh = (self.mesh if any(s is not None for s in self._split)
                   else None)
        if mp_mesh is not None and not self._mp_native:
            # a module that computes on whole leaves: gather the split ones
            with sharding.model_parallel(mp_mesh):
                params = [p if s is None else sharding.gather_from_model(
                    p, s + (0 if isinstance(params, _OneLane) else 1))
                    for p, s in zip(params, self._split)]
            mp_mesh = None
        with sharding.model_parallel(mp_mesh):
            if one_lane:
                lane = (params if isinstance(params, _OneLane)
                        else [p[0] for p in params])
                out = functional_call(
                    self.model, {**dict(zip(self.names, lane)),
                                 **self._buffers},
                    (x if shared_x else x[0],))
                return out[None]

            def one(p, xx):
                return functional_call(
                    self.model, {**dict(zip(self.names, p)),
                                 **self._buffers}, (xx,))
            return vmap(one, in_dims=(0, None if shared_x else 0))(params, x)

    # --------------------------------------------------------- train steps
    def _plan(self, draw_n: int, epochs: int, batch_size: int, part=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every member's epoch permutations, drawn from its own rng as the
        loop engine draws them, packed into (C, steps, B) index and weight
        arrays and (C, steps) validity. A member that ``part`` (C,) bool
        samples out draws nothing and keeps every step invalid."""
        C = len(self.members)
        ns = [draw_n] * C if draw_n >= 0 else [int(v) for v in self.n]
        steps = max(steps_per_epoch(n, batch_size) for n in ns) * epochs
        idx = np.zeros((C, steps, batch_size), np.int32)
        w = np.zeros((C, steps, batch_size), np.float32)
        valid = np.zeros((C, steps), bool)
        for i, c in enumerate(self.members):
            if part is not None and not part[i]:
                continue               # a no-op lane this round
            perms = [c.rng.permutation(ns[i]) for _ in range(epochs)]
            idx[i], w[i], valid[i] = padded_epoch_plan(perms, batch_size,
                                                       steps)
        return idx, w, valid

    @staticmethod
    def _mean_losses(losses: np.ndarray, valid: np.ndarray) -> List[float]:
        losses = np.asarray(losses, np.float64)
        valid = np.asarray(valid, np.float64)
        cnt = valid.sum(axis=1)
        tot = (losses * valid).sum(axis=1)
        return [float(t / c) if c else 0.0 for t, c in zip(tot, cnt)]

    def _apply(self, params, opt, grads, v: torch.Tensor):
        """One optimizer step, applied to the lanes where ``v`` is set,
        leaf by leaf and in place: ``sgd``'s update is elementwise within a
        leaf, so one leaf's update is the whole tree's at that leaf, with
        the same arithmetic. Each gradient (an entry of the list
        ``grads``) is released as it is used. In place, a step holds one
        leaf's new momentum and update at a time, not a new momentum tree
        and an update tree: two full trees fewer at the peak."""
        step = opt["step"]
        with torch.no_grad():
            for j, (p, m) in enumerate(zip(params, opt["mu"])):
                g, grads[j] = grads[j], None
                (u,), new = self.opt.update([g], {"mu": [m], "step": step},
                                            [p])
                del g
                keep = v.reshape((-1,) + (1,) * (p.ndim - 1))
                p.copy_(torch.where(keep, p + u, p))
                m.copy_(torch.where(keep, new["mu"][0], m))
                new_step = new["step"]        # the same for every leaf
                del u, new
        opt["step"] = torch.where(v, new_step, step)

    def _private(self, lo: int, hi: int):
        """A wave's private data: (x, y, the lanes' indices (lanes, 1))."""
        x, y = self._stage(self.x, lo, hi), self._stage(self.y, lo, hi)
        return x, y, torch.arange(x.shape[0], device=self.device)[:, None]

    def _run_steps(self, plan, batch_loss, data=None) -> List[float]:
        """The shared skeleton of the three training modes: wave by wave,
        step by step, ``batch_loss(wave_data, params, ib, wb) -> (C,)``
        losses (``wave_data = data(lo, hi)``, staged once a wave), their sum
        differentiated, the update gated per lane. The losses stay on the
        device until the phase's one read."""
        idx, w, valid = plan
        C, steps = valid.shape
        losses = np.zeros((C, steps), np.float32)
        for lo, hi in self._waves():
            params, opt = self._stage_state(lo, hi)
            wave_data = None if data is None else data(lo, hi)
            ib_all = self._stage(idx, lo, hi).to(torch.int64)
            wb_all = self._stage(w, lo, hi)
            v_all = self._stage(valid, lo, hi, fill=False)
            out = torch.zeros((ib_all.shape[0], steps), dtype=torch.float32,
                              device=self.device)
            one = params[0].shape[0] == 1
            inputs = _OneLane(p[0] for p in params) if one else params
            lanes = self._lanes(lo, hi)
            v_host = valid[lanes[lanes >= 0]]
            for s in range(steps):
                if not v_host[:, s].any():
                    continue           # a no-op step for every lane
                loss = batch_loss(wave_data, inputs, ib_all[:, s],
                                  wb_all[:, s])
                grads = list(torch.autograd.grad(loss.sum(), inputs))
                if one:
                    grads = [g[None] for g in grads]
                # dummy lanes of a padded wave never validate
                self._apply(params, opt, grads, v_all[:, s])
                out[:, s] = loss.detach()
            self._write_state(params, opt, lo, hi)
            losses[lo:hi] = _np(self._collect(out, lo, hi))
        return self._mean_losses(losses, valid)

    def local_train(self, epochs: int, batch_size: int,
                    part=None) -> List[float]:
        plan = self._plan(-1, epochs, batch_size, part=part)

        def batch_loss(data, params, ib, wb):
            x, y, lanes = data
            logits = self._forward(params, x[lanes, ib], True)
            return D.ce_loss_clients(logits, y[lanes, ib], wb)
        return self._run_steps(plan, batch_loss, self._private)

    def _kd_loss(self, logits, teacher, wb):
        if self.loss_kind == "mse":
            return D.kd_mse_loss_clients(logits, teacher, wb)
        return D.kd_kl_loss_clients(logits, teacher, self.temperature, wb,
                                    backend=self.kernel_backend)

    def distill(self, px: torch.Tensor, teacher: torch.Tensor,
                weight: torch.Tensor, epochs: int,
                batch_size: int, part=None) -> List[float]:
        """The shared proxy batch px (t, ...) on the device, the teacher
        (t, K) and its per-sample weight (t,): each lane's batch and its
        teacher rows are gathered from them."""
        idx, w, valid = self._plan(len(px), epochs, batch_size, part=part)

        def batch_loss(data, params, ib, wb):
            logits = self._forward(params, px[ib], True)
            return self._kd_loss(logits, teacher[ib], wb * weight[ib])
        return self._run_steps((idx, w, valid), batch_loss)

    def distill_private(self, teacher_by_class: torch.Tensor,
                        valid_by_class: torch.Tensor, epochs: int,
                        batch_size: int, part=None) -> List[float]:
        """FKD/PLS: each lane distills on its private data against the
        fused class-wise teacher, looked up by its labels."""
        plan = self._plan(-1, epochs, batch_size, part=part)
        vbc = valid_by_class.to(torch.float32)

        def batch_loss(data, params, ib, wb):
            x, y, lanes = data
            yb = y[lanes, ib]
            logits = self._forward(params, x[lanes, ib], True)
            return self._kd_loss(logits, teacher_by_class[yb], wb * vbc[yb])
        return self._run_steps(plan, batch_loss, self._private)

    # ------------------------------------------------------ batched reports
    def _by_wave(self, fn) -> torch.Tensor:
        """``fn(lo, hi, params)`` -> (wave lanes, ...) results, stacked over
        the waves (dummy lanes dropped) on the device."""
        outs = []
        with torch.no_grad():
            for lo, hi in self._waves():
                params, _ = self._stage_state(lo, hi)
                outs.append(self._collect(fn(lo, hi, params), lo, hi))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def proxy_logits(self, px: torch.Tensor, part=None) -> torch.Tensor:
        return _gate(self._by_wave(
            lambda lo, hi, p: self._forward(p, px, False, shared_x=True)),
            part)

    def classwise_means(self, part=None):
        """FKD/PLS: each member's per-class mean logits over its private
        data and per-class counts, device tensors; zero means and counts
        for a sampled-out member, which drop it from the fusion."""
        k = self.num_classes

        def fn(lo, hi, params):
            x, y = self._stage(self.x, lo, hi), self._stage(self.y, lo, hi)
            m = self._stage(self.sample_mask, lo, hi)
            logits = self._forward(params, x, False).to(torch.float32)
            oh = torch.nn.functional.one_hot(y, k).to(torch.float32) \
                * m[..., None]
            sums = oh.transpose(1, 2) @ logits
            cnt = torch.sum(oh, dim=1)
            return torch.cat([sums / torch.clamp_min(cnt[..., None], 1.0),
                              cnt[..., None]], dim=-1)
        out = _gate(self._by_wave(fn), part)
        return [(out[i, :, :-1], out[i, :, -1])
                for i in range(len(self.members))]

    def evaluate(self, x_test: torch.Tensor, y_test: torch.Tensor,
                 batch_size: int = 512) -> List[float]:
        """Every lane's accuracy on the shared test set, one read."""
        n = len(y_test)

        def fn(lo, hi, params):
            correct = torch.zeros((params[0].shape[0],), dtype=torch.int64,
                                  device=self.device)
            for s in range(0, n, batch_size):
                logits = self._forward(params, x_test[s:s + batch_size],
                                       False, shared_x=True)
                correct += (torch.argmax(logits, -1)
                            == y_test[s:s + batch_size]).sum(dim=1)
            return correct
        correct = _np(self._by_wave(fn))
        return [int(c) / max(n, 1) for c in correct]

    # -------------------------------------------------------------- filters
    @staticmethod
    def _check_kulsif_uniform(dres) -> None:
        for d in dres[1:]:
            if ((d.sigma, d.lam, dispatch.resolve(d.kernel_backend))
                    != (dres[0].sigma, dres[0].lam,
                        dispatch.resolve(dres[0].kernel_backend))):
                raise ValueError(
                    f"cohort KuLSIF DREs disagree on (sigma, lam, "
                    f"kernel_backend): "
                    f"{(dres[0].sigma, dres[0].lam, dres[0].kernel_backend)}"
                    f" vs {(d.sigma, d.lam, d.kernel_backend)}; give such "
                    "clients distinct arch_keys")

    def learn_dres(self, seed: int) -> None:
        """Fit every member's DRE from its ``client_generator(seed, pos)``
        stream (or its injected seeds), as the loop engine does. KMeans-DRE
        members of one configuration and one private-set size fit together
        (``learn_kmeans_batched``, wave by wave); anything else fits member
        by member."""
        if all(c.dre is None for c in self.members):
            return
        gens = [client_generator(seed, pos) for pos in self.positions]
        dres = [c.dre for c in self.members]
        # under a mesh each rank fits its own lanes' members, then every
        # rank takes every member's learned estimator
        fit = set(self._owned())
        if all(isinstance(d, KMeansDRE) for d in dres):
            d0 = dres[0]
            thrs_cfg = {None if d.threshold is None else float(d.threshold)
                        for d in dres}
            uniform = (len(set(self.n)) == 1
                       and len({d.num_centroids for d in dres}) == 1
                       and len(thrs_cfg) == 1
                       and len({d.calibration_q for d in dres}) == 1
                       and len({d.max_iter for d in dres}) == 1
                       and len({dispatch.resolve(d.kernel_backend)
                                for d in dres}) == 1)
            if uniform:
                self._learn_kmeans_uniform(d0, gens)
            else:
                for i, (c, g) in enumerate(zip(self.members, gens)):
                    if i in fit:
                        c.learn_dre(g)
        else:
            if all(isinstance(d, KuLSIFDRE) for d in dres):
                self._check_kulsif_uniform(dres)
            for i, (c, g) in enumerate(zip(self.members, gens)):
                if i in fit:
                    c.learn_dre(g)
        if self.mesh is not None:
            self._share_dres(fit)
        self._pack_filter_state()

    def _share_dres(self, fit) -> None:
        """Every member's learned estimator on every rank, gathered over
        the client axis from the ranks that fit it (on the host for the
        members this rank does not own; a KuLSIF member keeps its own
        private rows)."""
        mine = {}
        for i in fit:
            d = self.members[i].dre
            if isinstance(d, KMeansDRE):
                mine[i] = {"centroids": _np(d.centroids),
                           "threshold": float(d.threshold)}
            elif isinstance(d, KuLSIFDRE):
                mine[i] = {"alpha": _np(d.alpha), "aux": _np(d.aux),
                           "threshold": float(d.threshold)}
        for got in self.mesh.gather_objects(mine, M.DEFAULT_CLIENT_AXIS):
            for i, fields in got.items():
                if i in fit:
                    continue
                c = self.members[i]
                new = {k: v if k == "threshold" else torch.as_tensor(v)
                       for k, v in fields.items()}
                if isinstance(c.dre, KMeansDRE):
                    new["threshold"] = torch.tensor(new["threshold"],
                                                    dtype=torch.float32)
                else:
                    new["private"] = c._x.reshape(len(c.y), -1).to(
                        torch.float32)
                c.dre = dataclasses.replace(c.dre, **new)

    def _learn_kmeans_uniform(self, d0: KMeansDRE, gens) -> None:
        n0 = int(self.n[0])
        for lo, hi in self._waves():
            x = self._stage(self.x, lo, hi, fill=0)
            feats = x.reshape(x.shape[0], n0, -1).to(torch.float32)
            # dummy lanes fit all-zero rows from zero seeds (never read)
            zero = np.zeros((d0.num_centroids, feats.shape[-1]), np.float32)
            idx = self._lanes(lo, hi)

            def init(i):
                if i < 0:
                    return zero
                seeds = self.members[i].dre_init
                return (None if seeds is None
                        else torch.tensor(seeds, dtype=torch.float32,
                                          device=self.device))
            inits = [init(i) for i in idx]
            cents, thrs = learn_kmeans_batched(
                d0, feats, generators=[gens[i] if i >= 0 else None
                                       for i in idx],
                inits=inits)
            for r, i in enumerate(idx):
                if i >= 0:
                    c = self.members[i]
                    c.dre = dataclasses.replace(c.dre, centroids=cents[r],
                                                threshold=thrs[r])

    def _pack_filter_state(self) -> None:
        """Stack the members' learned DREs: device tensors (under a mesh,
        this rank's lanes, dummy lanes a copy of member 0's), or host
        masters in waved mode (staged by ``filter_masks`` one wave at a
        time)."""
        rows = np.arange(len(self.members))
        if self.mesh is not None and not self._waved:
            lanes = self._lanes(0, len(self.members))
            rows = np.where(lanes >= 0, lanes, 0)
        dres = [self.members[i].dre for i in rows]
        put = _np if self._waved else (lambda t: t)
        dev = "cpu" if self._waved else self.device
        if all(isinstance(d, KMeansDRE) for d in dres):
            kmax = max(d.centroids.shape[0] for d in dres)
            cents = []
            for d in dres:
                cc = d.centroids.to(dev, torch.float32)
                if cc.shape[0] < kmax:   # repeat the first centroid: the
                    cc = torch.cat([cc, cc[:1].expand(kmax - cc.shape[0],
                                                      -1)])  # minimum holds
                cents.append(cc)
            thrs = torch.stack([torch.as_tensor(d.threshold,
                                                dtype=torch.float32,
                                                device=dev).reshape(())
                                for d in dres])
            self.filter_kind = "kmeans"
            self._filter_state = {"centroids": put(torch.stack(cents)),
                                  "thresholds": put(thrs)}
        elif all(isinstance(d, KuLSIFDRE) for d in dres):
            self._check_kulsif_uniform(dres)
            n_max = int(self.n.max())
            # private sets padded with a far-away sentinel: its RBF kernel
            # mass underflows to exactly 0, which needs (1e6)^2/(2 sigma^2)
            # >> 88 in float32, so a padded cohort refuses sigmas near that
            padded = self._waved or int(self.n.min()) < n_max
            if padded and dres[0].sigma > 1e4:
                raise ValueError(
                    f"KuLSIF sentinel padding requires sigma <= 1e4 so the "
                    f"pad rows' RBF mass underflows to exactly 0; got "
                    f"sigma={dres[0].sigma!r} with a padded cohort — use "
                    "equal private-set sizes and no waves, or give such "
                    "clients distinct arch_keys")
            d = dres[0].private.shape[1]
            priv = torch.full((len(dres), n_max, d), 1e6,
                              dtype=torch.float32, device=dev)
            for r, (i, dr) in enumerate(zip(rows, dres)):
                priv[r, : self.n[i]] = dr.private
            self.filter_kind = "kulsif"
            self._filter_state = {
                "alpha": put(torch.stack([dr.alpha.to(dev) for dr in dres])),
                "aux": put(torch.stack([dr.aux.to(dev) for dr in dres])),
                "private": put(priv),
                "n": put(torch.as_tensor(self.n[rows], dtype=torch.float32,
                                         device=dev)),
                "thresholds": put(torch.tensor(
                    [float(dr.threshold) for dr in dres],
                    dtype=torch.float32, device=dev)),
                "sigma": float(dres[0].sigma),
                "lam": float(dres[0].lam)}
        else:  # unknown or mixed estimators: per-client mask calls
            self.filter_kind = "loop"

    def _pack_learned_filter_state(self) -> None:
        """Adopt DREs the members already learned."""
        d0 = self.members[0].dre
        if isinstance(d0, KMeansDRE):
            learned = all(isinstance(c.dre, KMeansDRE)
                          and c.dre.centroids is not None
                          for c in self.members)
        elif isinstance(d0, KuLSIFDRE):
            learned = all(isinstance(c.dre, KuLSIFDRE)
                          and c.dre.alpha is not None for c in self.members)
        elif d0 is not None:
            self.filter_kind = "loop"
            return
        else:
            learned = False
        if learned:
            self._pack_filter_state()

    def filter_masks(self, px: torch.Tensor, powner: torch.Tensor,
                     part=None) -> torch.Tensor:
        """Every member's two-stage ID mask on the proxy batch, (C, t);
        all False for a member that ``part`` samples out."""
        t = len(px)
        if self.filter_kind == "none" \
                and all(c.dre is None for c in self.members):
            return _gate(torch.ones((len(self.members), t),
                                         dtype=torch.bool,
                                         device=self.device), part)
        if self.filter_kind in ("none", "loop"):
            # no stacked state: each member's own filter, as the loop
            # engine runs it (failing loudly on an unlearned estimator;
            # sampled-out members skipped, as the loop engine skips them;
            # under a mesh, this rank's lanes, gathered)
            def one(i):
                if i < 0 or (part is not None and not part[i]):
                    return torch.zeros((t,), dtype=torch.bool,
                                       device=self.device)
                return self.members[i].filter_mask(px, powner).mask
            return torch.cat([
                self._collect(torch.stack([one(i) for i in
                                           self._lanes(lo, hi)]), lo, hi)
                for lo, hi in self._waves()])
        pxf = px.reshape(t, -1).to(torch.float32)
        st = self._filter_state
        cids = np.asarray([c.cid for c in self.members], np.int64)
        outs = []
        for lo, hi in self._waves():
            cid_w = self._stage(cids, lo, hi, fill=-1)   # dummies own nothing
            if self.filter_kind == "kmeans":
                masks = kmeans_id_masks(
                    self._stage(st["centroids"], lo, hi),
                    self._stage(st["thresholds"], lo, hi), cid_w, pxf,
                    powner, backend=self.kernel_backend)
            else:
                masks = kulsif_id_masks(
                    self._stage(st["alpha"], lo, hi),
                    self._stage(st["aux"], lo, hi),
                    self._stage(st["private"], lo, hi,
                                fill=np.float32(1e6)),
                    self._stage(st["n"], lo, hi, fill=np.float32(1.0)),
                    self._stage(st["thresholds"], lo, hi), cid_w,
                    st["sigma"], st["lam"], pxf, powner,
                    backend=self.kernel_backend)
            outs.append(self._collect(masks, lo, hi))
        return _gate(outs[0] if len(outs) == 1 else torch.cat(outs),
                          part)


class CohortEngine:
    """Engine over architecture-grouped cohorts; the ``LoopEngine``'s
    per-phase interface.

    The ``Client`` objects stay the source of private data, DRE
    configuration and rng streams, but their parameters and optimizer state
    live stacked in the cohorts for the engine's lifetime; call
    ``sync_to_clients()`` before reading them from the clients."""

    def __init__(self, clients: Sequence, wave_size: int = 0, mesh=None):
        self.clients = list(clients)
        self.device = self.clients[0].device
        self.wave_size = wave_size
        self.mesh = mesh
        self.cohorts = [_Cohort([self.clients[p] for p in group], group,
                                wave_size=wave_size, mesh=mesh)
                        for group in cohort_groups(
                            [c.arch_key for c in self.clients])]

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _scatter(self, per_cohort) -> List:
        out = [None] * len(self.clients)
        for cohort, values in zip(self.cohorts, per_cohort):
            for pos, v in zip(cohort.positions, values):
                out[pos] = v
        return out

    def _gather(self, per_cohort: List[torch.Tensor]) -> torch.Tensor:
        """Cohort-stacked results (m_i, ...) -> (C, ...) in client order."""
        pos = torch.as_tensor([p for c in self.cohorts for p in c.positions],
                              device=self.device)
        stacked = torch.cat(per_cohort)
        out = torch.empty_like(stacked)
        out[pos] = stacked
        return out

    def learn_dres(self, seed: int) -> None:
        for cohort in self.cohorts:
            cohort.learn_dres(seed)

    def _part_for(self, cohort: _Cohort, participants):
        """A fleet participation mask sliced to one cohort's members."""
        if participants is None:
            return None
        part = np.asarray(participants, bool)
        if part.shape != (len(self.clients),):
            raise ValueError(
                f"participation mask shape {part.shape} != "
                f"({len(self.clients)},)")
        return part[cohort.positions]

    # ------------------------------------------------ per-phase entry points
    def phase_local_train(self, epochs: int, batch_size: int,
                          participants=None) -> List[float]:
        return self._scatter([self.cohort_local_train(ci, epochs, batch_size,
                                                      participants)
                              for ci in range(len(self.cohorts))])

    def phase_classwise_report(self, participants=None):
        return self._scatter([self.cohort_classwise_report(ci, participants)
                              for ci in range(len(self.cohorts))])

    def phase_report(self, px, powner, participants=None):
        """(logits (C, t, K), masks (C, t) bool) on the device, in client
        order; sampled-out rows zero and all-False."""
        px_d = sample_tensor(px, self.device)
        owner_d = self._dev(powner)
        reports = [self.cohort_report(ci, px_d, owner_d, participants)
                   for ci in range(len(self.cohorts))]
        return (self._gather([lg for lg, _ in reports]),
                self._gather([mk for _, mk in reports]))

    def phase_distill(self, px, teacher, weight, epochs: int,
                      batch_size: int, participants=None) -> List[float]:
        px_d = sample_tensor(px, self.device)
        teacher_d = self._dev(teacher, torch.float32)
        weight_d = self._dev(weight, torch.float32)
        return self._scatter([self.cohort_distill(ci, px_d, teacher_d,
                                                  weight_d, epochs,
                                                  batch_size, participants)
                              for ci in range(len(self.cohorts))])

    def phase_distill_private(self, teacher_by_class, valid_by_class,
                              epochs: int, batch_size: int,
                              participants=None) -> List[float]:
        teacher_d = self._dev(teacher_by_class, torch.float32)
        valid_d = self._dev(valid_by_class)
        return self._scatter([self.cohort_distill_private(
            ci, teacher_d, valid_d, epochs, batch_size, participants)
            for ci in range(len(self.cohorts))])

    def phase_eval(self, x_test, y_test) -> List[float]:
        x_d = sample_tensor(x_test, self.device)
        y_d = self._dev(y_test, torch.int64)
        return self._scatter([c.evaluate(x_d, y_d) for c in self.cohorts])

    # ------------------------------------------------ per-cohort entry points
    # Concurrent-cohort scheduling drives each cohort on its own, so that
    # different cohorts' phases interleave on the round graph. Each call
    # returns values aligned to the cohort's positions
    # (``cohort_positions()[ci]``), which the scheduler scatters back.
    def cohort_positions(self) -> List[np.ndarray]:
        return [np.asarray(c.positions, int) for c in self.cohorts]

    def cohort_local_train(self, ci: int, epochs: int, batch_size: int,
                           participants=None) -> List[float]:
        c = self.cohorts[ci]
        return c.local_train(epochs, batch_size,
                             part=self._part_for(c, participants))

    def cohort_classwise_report(self, ci: int, participants=None):
        c = self.cohorts[ci]
        return c.classwise_means(part=self._part_for(c, participants))

    def cohort_report(self, ci: int, px, powner, participants=None):
        """(logits (m, t, K), masks (m, t) bool) for cohort ``ci``'s m
        members, on the device."""
        c = self.cohorts[ci]
        part = self._part_for(c, participants)
        px_d = sample_tensor(px, self.device)
        owner_d = self._dev(powner)
        return (c.proxy_logits(px_d, part=part),
                c.filter_masks(px_d, owner_d, part=part))

    def cohort_distill(self, ci: int, px, teacher, weight, epochs: int,
                       batch_size: int, participants=None) -> List[float]:
        c = self.cohorts[ci]
        return c.distill(sample_tensor(px, self.device),
                         self._dev(teacher, torch.float32),
                         self._dev(weight, torch.float32), epochs,
                         batch_size, part=self._part_for(c, participants))

    def cohort_distill_private(self, ci: int, teacher_by_class,
                               valid_by_class, epochs: int, batch_size: int,
                               participants=None) -> List[float]:
        c = self.cohorts[ci]
        return c.distill_private(self._dev(teacher_by_class, torch.float32),
                                 self._dev(valid_by_class), epochs,
                                 batch_size,
                                 part=self._part_for(c, participants))

    def sync_to_clients(self) -> None:
        for cohort in self.cohorts:
            cohort.sync_to_clients()

    # ------------------------------------------------- resumable service
    def state_dict(self) -> Dict:
        """Per-client state in the engine checkpoint format
        (``repro_torch.fed.state``): the stacked state (a waved cohort's
        host masters) is synced back onto the ``Client`` objects first, so
        the checkpoint is the loop engine's in layout and restores under
        either engine, waved or not. Under a mesh the state is gathered
        (``_Cohort.gathered``) to the world's first rank alone, which
        returns that format; every other rank returns its members'
        shuffling streams and its own rows and slices (``"shard"``), a
        restore point for that rank alone."""
        if self.mesh is None:
            self.sync_to_clients()
            return clients_state_dict(self.clients)
        whole: Dict[int, list] = {}
        for cohort in self.cohorts:
            J = len(cohort.names)
            for lo, hi, j, p, mu, step in cohort.gathered(root=True):
                if p is None:
                    continue
                for r in range(hi - lo):
                    e = whole.setdefault(cohort.positions[lo + r],
                                         [[None] * J, [None] * J, 0])
                    e[0][j], e[1][j], e[2] = p[r], mu[r], int(step[r])
        if self.mesh.rank == 0:
            return {"clients": [{"cid": int(c.cid),
                                 **c.state_dict(*whole.pop(pos))}
                                for pos, c in enumerate(self.clients)]}
        return {"clients": [{"cid": int(c.cid), "rng": rng_state_dict(c.rng)}
                            for c in self.clients],
                "shard": [cohort.local_state() for cohort in self.cohorts]}

    def load_state_dict(self, sd: Dict) -> None:
        """Load onto the clients, then re-stack every cohort from them;
        under a mesh each rank takes its own rows and slices of a whole
        checkpoint, or restores its own ``"shard"``."""
        if self.mesh is None:
            load_clients_state_dict(self.clients, sd)
            for cohort in self.cohorts:
                cohort.adopt_member_state()
            return
        entries = check_clients_entries(self.clients, sd)
        for c, e in zip(self.clients, entries):
            load_rng_state(c.rng, e["rng"])
        if "shard" in sd:
            for cohort, st in zip(self.cohorts, sd["shard"]):
                cohort.load_local_state(st)
            return
        for cohort in self.cohorts:
            cohort.load_members([entries[pos] for pos in cohort.positions])
