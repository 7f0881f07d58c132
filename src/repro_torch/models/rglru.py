"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The diagonal real-gated linear recurrence
    a_t = exp(-c · softplus(Λ) · sigmoid(r_t))           (recurrence gate)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)   (input gate i_t)
after a width-4 causal depthwise conv, as the Griffin recurrent block.

The reference's ``repro.models.rglru`` in PyTorch, with its names,
parameter names and layouts. The reference evaluates the recurrence
with ``jax.lax.associative_scan`` over the sequence; here a doubling
scan of ceil(log2 S) elementwise passes applies the same ``combine`` of
(a, b) pairs (log depth, no loop over time, and no cumulative sum of
log a, whose exponentials are unsafe in f32). Decode is the O(1)
single-step update with the conv's tail carried in the state. No TPU
kernel is on this path: the reference's scan is plain JAX.

Under a model axis (``models.sharding.model_parallel``) a rank runs the
recurrence on its own block of the width, as ``fed.mesh.model_split``
places the leaves (the projections on their contraction dim, ``conv``,
``conv_b``, ``lambda`` and the gate biases by width): the two input
branches are partial sums over the rank's block of d, all-reduced whole
and cut to its width block (``sharding.reduce_then_block``: twice the
bytes of a reduce-scatter); the conv, the recurrence gates (partial
sums over the local width, likewise one all-reduce) and the
doubling scan run per channel on the local block with no collective
inside the scan; ``wout`` is row-parallel, its partial outputs summed.
Decode carries the local block of the state.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding
from repro_torch.models.layers import _normal, init_rmsnorm, rmsnorm

_C = 8.0  # Griffin's fixed scalar c
CONV_W = 4


def init_rglru(d_model: int, *, generator: Optional[torch.Generator] = None,
               device=None, home=None) -> nn.ParameterDict:
    """Griffin's recurrent block: the input projections (two branches),
    the conv, the RG-LRU and the output projection, d_rnn = d. Λ is
    drawn so that a^c lies in [0.9, 0.999] (the paper's init)."""
    d_rnn = d_model
    std = 1.0 / math.sqrt(d_model)
    keep = device if home is None else home

    def w(shape, s):
        return _normal(shape, s, generator, device, home)
    u = torch.rand((d_rnn,), generator=generator, device=device) \
        * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    lam = torch.log(torch.expm1(-torch.log(u) / _C))   # softplus⁻¹
    return nn.ParameterDict({
        "norm": init_rmsnorm(d_model, device=keep),
        "wx": w((d_model, d_rnn), std),
        "wgate": w((d_model, d_rnn), std),
        "conv": w((CONV_W, d_rnn), 0.1),
        "conv_b": nn.Parameter(torch.zeros((d_rnn,), device=keep)),
        "lambda": nn.Parameter(lam.to(keep)),
        "wr": w((d_rnn, d_rnn), std),
        "br": nn.Parameter(torch.zeros((d_rnn,), device=keep)),
        "wi": w((d_rnn, d_rnn), std),
        "bi": nn.Parameter(torch.zeros((d_rnn,), device=keep)),
        "wout": w((d_rnn, d_model), std),
    })


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, d_rnn) recurrent state, f32
    conv: torch.Tensor    # (B, CONV_W - 1, d_rnn) the conv's tail


def rglru_zero_state(batch: int, d_rnn: int, dtype=torch.float32,
                     device=None) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_W - 1, d_rnn), dtype=dtype,
                         device=device))


def _shapes(d: int) -> dict:
    return {"wx": (d, d), "wgate": (d, d), "conv": (CONV_W, d),
            "conv_b": (d,), "lambda": (d,), "wr": (d, d), "br": (d,),
            "wi": (d, d), "bi": (d,), "wout": (d, d)}


def local_width(d: int) -> int:
    """The width of the state a rank carries under the installed model
    axis (d without one, or where the axis does not divide d)."""
    mp = sharding.model_parallel_state()
    return d // mp.size if sharding.splits(d) else d


def _branches(p: Mapping[str, torch.Tensor], xn: torch.Tensor):
    """The normed input xn (B, S, d) -> (branch, gate, leaves, split): the
    two input branches on this rank's width block (the whole width
    unsharded), the leaves the rest of the block reads (this rank's
    blocks under a model axis) and whether the block is split."""
    d = xn.shape[-1]
    mp = sharding.model_parallel_state()
    if mp is not None and not sharding.splits(d):
        # a width the axis does not divide: whole on every rank
        p = {k: sharding.whole(w, k, _shapes(d)[k])
             for k, w in p.items() if k != "norm"}
    if not sharding.splits(d):
        branch = torch.einsum("bsd,de->bse", xn, p["wx"])
        gate = torch.einsum("bsd,de->bse", xn, p["wgate"])
    else:
        lo, hi = sharding.block(d)
        shapes = _shapes(d)

        def leaf(name, dim):
            return sharding.part(p[name], name, shapes[name], dim, lo, hi)
        xs = sharding.scatter_to_model(xn, -1)
        branch, gate = sharding.reduce_then_block(torch.stack(
            [torch.einsum("bsd,de->bse", xs, leaf(w, 0))
             for w in ("wx", "wgate")]), -1)
        p = {"conv": leaf("conv", 1), "conv_b": leaf("conv_b", 0),
             "lambda": leaf("lambda", 0), "wr": leaf("wr", 0),
             "br": leaf("br", 0), "wi": leaf("wi", 0), "bi": leaf("bi", 0),
             "wout": leaf("wout", 0)}
    # jax.nn.gelu's default is the tanh approximation
    return branch, F.gelu(gate, approximate="tanh"), p, sharding.splits(d)


def _out(p, y: torch.Tensor, split: bool) -> torch.Tensor:
    out = torch.einsum("bse,ed->bsd", y, p["wout"])
    return sharding.reduce_from_model(out) if split else out


def _gates(p: Mapping[str, torch.Tensor], xc: torch.Tensor,
           split: bool = False):
    """xc (B, S, d_rnn) after the conv -> (a, β·i·x) in f32; ``split``:
    xc is this rank's width block, the gates' products partial sums over
    it, reduced and cut to the block."""
    if split:
        pr, pi = sharding.reduce_then_block(torch.stack(
            [torch.einsum("bsd,de->bse", xc, p[w]) for w in ("wr", "wi")]),
            -1)
    else:
        pr = torch.einsum("bsd,de->bse", xc, p["wr"])
        pi = torch.einsum("bsd,de->bse", xc, p["wi"])
    r = torch.sigmoid((pr + p["br"]).to(torch.float32))
    i = torch.sigmoid((pi + p["bi"]).to(torch.float32))
    log_a = -_C * F.softplus(p["lambda"]) * r             # (B, S, d) <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i * xc.to(torch.float32)


def _conv1d(p: Mapping[str, torch.Tensor], x: torch.Tensor,
            tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv of width CONV_W over x (B, S, d): left
    zero-padded, or continued from ``tail`` (B, CONV_W - 1, d) in
    decode."""
    if tail is None:
        xp = F.pad(x, (0, 0, CONV_W - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * p["conv"][i] for i in range(CONV_W))
    return out + p["conv_b"]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1: a doubling
    scan of (a, b) pairs under the reference's ``combine(l, r) = (a_l a_r,
    b_r + a_r b_l)``, ceil(log2 S) passes."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), the residual added."""
    branch, gate, p, split = _branches(p, rmsnorm(p["norm"], x, eps))
    a, b = _gates(p, _conv1d(p, branch), split)
    return x + _out(p, _scan(a, b).to(x.dtype) * gate, split)


def rglru_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 state: RGLRUState, eps: float = 1e-5):
    """x (B, 1, d) -> (y, the new state)."""
    branch, gate, p, split = _branches(p, rmsnorm(p["norm"], x, eps))
    xc = _conv1d(p, branch, tail=state.conv)
    new_tail = torch.cat([state.conv[:, 1:], branch.to(state.conv.dtype)],
                         dim=1)
    a, b = _gates(p, xc, split)
    h = a[:, 0] * state.h + b[:, 0]
    return x + _out(p, h[:, None].to(x.dtype) * gate, split), \
        RGLRUState(h, new_tail)
