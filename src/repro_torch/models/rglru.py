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
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

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


def _gates(p: Mapping[str, torch.Tensor], xc: torch.Tensor):
    """xc (B, S, d_rnn) after the conv -> (a, β·i·x) in f32."""
    r = torch.sigmoid((torch.einsum("bsd,de->bse", xc, p["wr"])
                       + p["br"]).to(torch.float32))
    i = torch.sigmoid((torch.einsum("bsd,de->bse", xc, p["wi"])
                       + p["bi"]).to(torch.float32))
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
    xn = rmsnorm(p["norm"], x, eps)
    branch = torch.einsum("bsd,de->bse", xn, p["wx"])
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(torch.einsum("bsd,de->bse", xn, p["wgate"]),
                  approximate="tanh")
    a, b = _gates(p, _conv1d(p, branch))
    out = _scan(a, b).to(x.dtype) * gate
    return x + torch.einsum("bse,ed->bsd", out, p["wout"])


def rglru_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 state: RGLRUState, eps: float = 1e-5):
    """x (B, 1, d) -> (y, the new state)."""
    xn = rmsnorm(p["norm"], x, eps)
    branch = torch.einsum("bsd,de->bse", xn, p["wx"])
    gate = F.gelu(torch.einsum("bsd,de->bse", xn, p["wgate"]),
                  approximate="tanh")
    xc = _conv1d(p, branch, tail=state.conv)
    new_tail = torch.cat([state.conv[:, 1:], branch.to(state.conv.dtype)],
                         dim=1)
    a, b = _gates(p, xc)
    h = a[:, 0] * state.h + b[:, 0]
    out = h[:, None].to(x.dtype) * gate
    return x + torch.einsum("bse,ed->bsd", out, p["wout"]), \
        RGLRUState(h, new_tail)
