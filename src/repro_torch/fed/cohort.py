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
update per lane where the step is valid (``where_tree``), as the
reference's ``scan_steps`` does.

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
time for concurrent-cohort scheduling; the ``*_all`` names are aliases of
the per-phase ones.

Not ported yet: the device mesh (ROADMAP queue A item 10),
``state_dict``/``load_state_dict`` (item 8), and token (transformer)
clients on this engine (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from repro_torch.common.pytree import stack_trees, unstack_tree, where_tree
from repro_torch.core import distill as D
from repro_torch.core.dre import (KMeansDRE, KuLSIFDRE, kmeans_id_masks,
                                  kulsif_id_masks, learn_kmeans_batched)
from repro_torch.core.protocol import client_generator
from repro_torch.data.synthetic import sample_tensor
from repro_torch.fed.batching import padded_epoch_plan, steps_per_epoch
from repro_torch.kernels import dispatch


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


class _Cohort:
    """One architecture group: stacked state and its batched round phases."""

    def __init__(self, members: Sequence, positions: Sequence[int],
                 wave_size: int = 0):
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
        if C == 1 and not self._waved:
            # a cohort of one reads its client's own tensors
            x, y = c0._x[None], c0._y[None]
            m = torch.ones((1, n_max), dtype=torch.float32,
                           device=self.device)
        else:
            x0 = c0._x
            x = torch.zeros((C, n_max, *x0.shape[1:]), dtype=x0.dtype,
                            device=self.device)
            y = torch.zeros((C, n_max), dtype=torch.int64,
                            device=self.device)
            m = torch.zeros((C, n_max), dtype=torch.float32,
                            device=self.device)
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
        """Stack the members' parameters and optimizer state (host masters
        in waved mode, device tensors otherwise) — at construction, and as
        the inverse of ``sync_to_clients``."""
        params = stack_trees([[p.detach() for p in c.params]
                              for c in self.members])
        mu = stack_trees([c.opt_state["mu"] for c in self.members])
        step = torch.tensor([c.opt_state["step"] for c in self.members],
                            dtype=torch.int64, device=self.device)
        if self._waved:
            self.params = [_np(p) for p in params]
            self.opt_state = {"mu": [_np(v) for v in mu], "step": _np(step)}
        else:
            self.params = [p.requires_grad_(True) for p in params]
            self.opt_state = {"mu": mu, "step": step}

    def sync_to_clients(self) -> None:
        """Write the stacked parameters and optimizer state back onto the
        member ``Client`` objects."""
        with torch.no_grad():
            for i, c in enumerate(self.members):
                for p, s in zip(c.params, unstack_tree(self.params, i)):
                    p.copy_(torch.as_tensor(s))
                c.opt_state = {
                    "mu": [torch.as_tensor(v[i]).to(self.device).clone()
                           for v in self.opt_state["mu"]],
                    "step": int(self.opt_state["step"][i])}

    # ------------------------------------------------------ wave streaming
    def _waves(self):
        """The ``[lo, hi)`` member ranges of each wave (one wave covering
        the cohort when it is not waved)."""
        C = len(self.members)
        for lo in range(0, C, self.wave_size):
            yield lo, min(lo + self.wave_size, C)

    def _stage(self, arr, lo: int, hi: int, fill=0) -> torch.Tensor:
        """Rows ``[lo, hi)`` of a stacked array as a device tensor of
        ``wave_size`` rows (unwaved: the whole array on the device, a device
        tensor as it is). Rows past ``hi - lo`` are dummy lanes: ``fill`` a
        pad value, or ``None`` to repeat row ``lo`` (state ballast, never
        read back)."""
        if not self._waved:
            return torch.as_tensor(arr, device=self.device)
        arr = np.asarray(arr)
        n = hi - lo
        if n == self.wave_size:
            out = arr[lo:hi]
        elif fill is None:
            out = np.concatenate(
                [arr[lo:hi], np.repeat(arr[lo:lo + 1], self.wave_size - n,
                                       axis=0)])
        else:
            out = np.full((self.wave_size, *arr.shape[1:]), fill, arr.dtype)
            out[:n] = arr[lo:hi]
        return torch.as_tensor(out, device=self.device)

    def _stage_state(self, lo: int, hi: int):
        if not self._waved:
            return self.params, self.opt_state
        params = [self._stage(p, lo, hi, fill=None).requires_grad_(True)
                  for p in self.params]
        opt = {"mu": [self._stage(v, lo, hi, fill=None)
                      for v in self.opt_state["mu"]],
               "step": self._stage(self.opt_state["step"], lo, hi,
                                   fill=None)}
        return params, opt

    def _write_state(self, params, opt, lo: int, hi: int) -> None:
        """A wave's trained state back to the host masters (dummy lanes
        dropped); unwaved, the device state was updated in place."""
        if not self._waved:
            return
        n = hi - lo
        for h, d in zip(self.params, params):
            h[lo:hi] = _np(d)[:n]
        for h, d in zip(self.opt_state["mu"], opt["mu"]):
            h[lo:hi] = _np(d)[:n]
        self.opt_state["step"][lo:hi] = _np(opt["step"])[:n]

    # ------------------------------------------------------------ forwards
    def _forward(self, params: List[torch.Tensor], x: torch.Tensor,
                 train: bool, shared_x: bool = False) -> torch.Tensor:
        """Every lane's logits: x (C, B, ...) per lane, or (B, ...) shared
        by all (``shared_x``) -> (C, B, K). A cohort of one runs its module
        on its own parameters, as the loop engine does."""
        if self.model.training != train:
            self.model.train(train)
        if isinstance(params, _OneLane) or params[0].shape[0] == 1:
            lane = (params if isinstance(params, _OneLane)
                    else [p[0] for p in params])
            out = functional_call(self.model, dict(zip(self.names, lane)),
                                  (x if shared_x else x[0],))
            return out[None]

        def one(p, xx):
            return functional_call(self.model, dict(zip(self.names, p)),
                                   (xx,))
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
        """One optimizer step, applied to the lanes where ``v`` is set."""
        upd, new = self.opt.update(grads, opt, params)
        with torch.no_grad():
            for p, u in zip(params, upd):
                p.copy_(torch.where(
                    v.reshape((-1,) + (1,) * (p.ndim - 1)), p + u, p))
        opt["mu"] = where_tree(v, new["mu"], opt["mu"])
        opt["step"] = torch.where(v, new["step"], opt["step"])

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
            for s in range(steps):
                if not valid[lo:hi, s].any():
                    continue           # a no-op step for every lane
                loss = batch_loss(wave_data, inputs, ib_all[:, s],
                                  wb_all[:, s])
                grads = torch.autograd.grad(loss.sum(), inputs)
                if one:
                    grads = [g[None] for g in grads]
                # dummy lanes of a padded wave never validate
                self._apply(params, opt, grads, v_all[:, s])
                out[:, s] = loss.detach()
            self._write_state(params, opt, lo, hi)
            losses[lo:hi] = _np(out)[: hi - lo]
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
                outs.append(fn(lo, hi, params)[: hi - lo])
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
                for c, g in zip(self.members, gens):
                    c.learn_dre(g)
        else:
            if all(isinstance(d, KuLSIFDRE) for d in dres):
                self._check_kulsif_uniform(dres)
            for c, g in zip(self.members, gens):
                c.learn_dre(g)
        self._pack_filter_state()

    def _learn_kmeans_uniform(self, d0: KMeansDRE, gens) -> None:
        n0 = int(self.n[0])
        for lo, hi in self._waves():
            x = self._stage(self.x, lo, hi, fill=0)
            feats = x.reshape(x.shape[0], n0, -1).to(torch.float32)
            lanes = x.shape[0]
            # dummy lanes fit all-zero rows from zero seeds (never read)
            inits = [None if c.dre_init is None
                     else torch.tensor(c.dre_init, dtype=torch.float32,
                                       device=self.device)
                     for c in self.members[lo:hi]]
            inits += [np.zeros((d0.num_centroids, feats.shape[-1]),
                               np.float32)] * (lanes - (hi - lo))
            cents, thrs = learn_kmeans_batched(
                d0, feats, generators=gens[lo:hi] + [None] * (lanes - hi + lo),
                inits=inits)
            for i, c in enumerate(self.members[lo:hi]):
                c.dre = dataclasses.replace(c.dre, centroids=cents[i],
                                            threshold=thrs[i])

    def _pack_filter_state(self) -> None:
        """Stack the members' learned DREs: device tensors, or host masters
        in waved mode (staged by ``filter_masks`` one wave at a time)."""
        dres = [c.dre for c in self.members]
        put = _np if self._waved else (lambda t: t)
        if all(isinstance(d, KMeansDRE) for d in dres):
            kmax = max(d.centroids.shape[0] for d in dres)
            cents = []
            for d in dres:
                cc = d.centroids.to(torch.float32)
                if cc.shape[0] < kmax:   # repeat the first centroid: the
                    cc = torch.cat([cc, cc[:1].expand(kmax - cc.shape[0],
                                                      -1)])  # minimum holds
                cents.append(cc)
            thrs = torch.stack([torch.as_tensor(d.threshold,
                                                dtype=torch.float32,
                                                device=self.device).reshape(())
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
                              dtype=torch.float32, device=self.device)
            for i, dr in enumerate(dres):
                priv[i, : self.n[i]] = dr.private
            self.filter_kind = "kulsif"
            self._filter_state = {
                "alpha": put(torch.stack([dr.alpha for dr in dres])),
                "aux": put(torch.stack([dr.aux for dr in dres])),
                "private": put(priv),
                "n": put(torch.as_tensor(self.n, dtype=torch.float32,
                                         device=self.device)),
                "thresholds": put(torch.tensor(
                    [float(dr.threshold) for dr in dres],
                    dtype=torch.float32, device=self.device)),
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
            # sampled-out members skipped, as the loop engine skips them)
            return torch.stack([
                c.filter_mask(px, powner).mask
                if part is None or part[i]
                else torch.zeros((t,), dtype=torch.bool, device=self.device)
                for i, c in enumerate(self.members)])
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
            outs.append(masks[: hi - lo])
        return _gate(outs[0] if len(outs) == 1 else torch.cat(outs),
                          part)


class CohortEngine:
    """Engine over architecture-grouped cohorts; the ``LoopEngine``'s
    per-phase interface.

    The ``Client`` objects stay the source of private data, DRE
    configuration and rng streams, but their parameters and optimizer state
    live stacked in the cohorts for the engine's lifetime; call
    ``sync_to_clients()`` before reading them from the clients."""

    def __init__(self, clients: Sequence, wave_size: int = 0):
        self.clients = list(clients)
        self.device = self.clients[0].device
        self.wave_size = wave_size
        groups: Dict[object, Tuple[list, List[int]]] = {}
        for pos, c in enumerate(self.clients):
            key = c.arch_key if c.arch_key is not None else ("solo", pos)
            members, positions = groups.setdefault(key, ([], []))
            members.append(c)
            positions.append(pos)
        self.cohorts = [_Cohort(m, p, wave_size=wave_size)
                        for m, p in groups.values()]

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

    # -------------------------------------- historical names (thin aliases)
    def local_train_all(self, epochs: int, batch_size: int,
                        participants=None) -> List[float]:
        return self.phase_local_train(epochs, batch_size, participants)

    def classwise_means_all(self, participants=None):
        return self.phase_classwise_report(participants)

    def proxy_logits_and_masks(self, px, powner, participants=None):
        return self.phase_report(px, powner, participants)

    def distill_all(self, px, teacher, weight, epochs: int,
                    batch_size: int, participants=None) -> List[float]:
        return self.phase_distill(px, teacher, weight, epochs, batch_size,
                                  participants)

    def distill_private_all(self, teacher_by_class, valid_by_class,
                            epochs: int, batch_size: int,
                            participants=None) -> List[float]:
        return self.phase_distill_private(teacher_by_class, valid_by_class,
                                          epochs, batch_size, participants)

    def evaluate_all(self, x_test, y_test) -> List[float]:
        return self.phase_eval(x_test, y_test)

    def sync_to_clients(self) -> None:
        for cohort in self.cohorts:
            cohort.sync_to_clients()

    # ------------------------------------------------- resumable service
    def state_dict(self) -> Dict:
        raise NotImplementedError(
            "CohortEngine.state_dict is not ported yet: ROADMAP queue A "
            "item 8 (state and service, fed/state.py)")

    def load_state_dict(self, sd: Dict) -> None:
        raise NotImplementedError(
            "CohortEngine.load_state_dict is not ported yet: ROADMAP queue A "
            "item 8 (state and service, fed/state.py)")
