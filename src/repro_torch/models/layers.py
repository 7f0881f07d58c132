"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU MLP.

The reference's ``repro.models.layers`` in PyTorch, with the same names,
parameter names and layouts (``wq (d, N, h)``, ``wk``/``wv (d, Nkv, h)``,
``wo (N, h, d)``, MLP ``wg``/``wu (d, f)``, ``wd (f, d)``) and the same
einsums, so parameters exported from the JAX package load without
transposes. Each ``init_*`` returns an ``nn.ParameterDict``; the forward
functions take any mapping of name to tensor (a ``ParameterDict`` or a
plain dict).

Ported: full-sequence attention (causal or full, and the plain route's
sliding window) through ``kernels.dispatch.flash_attention``. The
reference's mesh ``constrain`` (a no-op without a mesh), its
``chunked_attention``, ``attention_decode``, cross-attention
(``kv_override``) and bf16 partial sums are not ported yet (ROADMAP queue
A item 11).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch.kernels import dispatch

NEG_INF = -1e30  # large-negative in f32; avoids NaN from (-inf) - (-inf)


def _normal(shape, std: float, generator, device) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator,
                                    device=device) * std)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, *, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(torch.ones((d,),
                                                              device=device))})


def rmsnorm(p: Mapping[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32, result in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> cos, sin of shape (..., head_dim // 2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D//2), broadcast over batch and heads.
    Rotates the two halves of the head width (half-split, not
    interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(cfg, *, generator: Optional[torch.Generator] = None,
                   device=None) -> nn.ParameterDict:
    """Normal weights at std 1/√d; ``wo`` further scaled by
    1/√num_layers. Drawn on ``device`` from ``generator`` (a generator of
    that device)."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    std = 1.0 / math.sqrt(d)
    p = nn.ParameterDict({
        "wq": _normal((d, nq, h), std, generator, device),
        "wk": _normal((d, nkv, h), std, generator, device),
        "wv": _normal((d, nkv, h), std, generator, device),
        "wo": _normal((nq, h, d), std / math.sqrt(cfg.num_layers), generator,
                      device),
    })
    if cfg.qkv_bias:
        for name, heads in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = nn.Parameter(torch.zeros((heads, h), device=device))
    return p


def _qkv(p: Mapping[str, torch.Tensor], x: torch.Tensor):
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, n_kv, h) -> (B, S, n_kv*n_rep, h) by repeat (GQA)."""
    if n_rep == 1:
        return k
    b, s, nkv, h = k.shape
    k = k[:, :, :, None, :].expand(b, s, nkv, n_rep, h)
    return k.reshape(b, s, nkv * n_rep, h)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, N, H), k, v (B, Sk, N, H), mask broadcastable to
    (B, N, Sq, Sk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqnh,bknh->bnqk", q, k).to(torch.float32) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def make_mask(sq: int, sk: int, *, causal: bool, window: int = 0,
              device=None) -> torch.Tensor:
    """Boolean mask (1, 1, sq, sk). window > 0 = sliding causal window."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    if causal:
        m = kpos <= qpos
        if window > 0:
            m = m & (kpos > qpos - window)
    else:
        m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    return m[None, None]


def attention_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, *,
                      positions: Optional[torch.Tensor] = None,
                      causal: bool = True, window: int = 0,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Full-sequence self-attention, x (B, S, d) -> (B, S, d).

    ``backend`` picks the attention route (``kernels.dispatch``): the
    reference follows only the ambient policy here, the port also takes
    the client's ``kernel_backend``, so ``"torch"`` means plain attention
    too. The kv heads go to the dispatch unexpanded."""
    q, k, v = _qkv(p, x)
    if positions is not None:
        cos, sin = rope_angles(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = dispatch.flash_attention(q, k, v, causal=causal, window=window,
                                 backend=backend)
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, *,
             generator: Optional[torch.Generator] = None,
             device=None) -> nn.ParameterDict:
    std = 1.0 / math.sqrt(d_model)
    return nn.ParameterDict({
        "wg": _normal((d_model, d_ff), std, generator, device),
        "wu": _normal((d_model, d_ff), std, generator, device),
        "wd": _normal((d_ff, d_model), 1.0 / math.sqrt(d_ff), generator,
                      device),
    })


def mlp_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    u = torch.einsum("bsd,df->bsf", x, p["wu"])
    h = torch.nn.functional.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p["wd"])
