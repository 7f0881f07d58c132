"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU MLP.

The reference's ``repro.models.layers`` in PyTorch, with the same names,
parameter names and layouts (``wq (d, N, h)``, ``wk``/``wv (d, Nkv, h)``,
``wo (N, h, d)``, MLP ``wg``/``wu (d, f)``, ``wd (f, d)``) and the same
einsums, so parameters exported from the JAX package load without
transposes. Each ``init_*`` returns an ``nn.ParameterDict``; the forward
functions take any mapping of name to tensor (a ``ParameterDict`` or a
plain dict).

Ported: full-sequence attention (causal or full, and the plain route's
sliding window) through ``kernels.dispatch.flash_attention``. Under a
model axis (``models.sharding.model_parallel``, the 2-D cohort mesh) each
function takes this rank's slices of its leaves as
``launch.mesh.param_spec`` places them: attention runs its local query
heads (column-parallel ``wq``, the kv heads they read, row-parallel
``wo`` and an all-reduce), the MLP its local ff block (``wg``/``wu``
column-, ``wd`` row-parallel), and RMSNorm gathers a split scale; a block
whose heads or ff width the model axis does not divide runs whole on
every rank from gathered leaves. ``set_attention_options(chunk_q=...)``
routes full-sequence attention longer than ``chunk_q`` through
``chunked_attention`` (the reference's plain query-chunked route, no
kernel there either), and ``attention_decode`` is one token against a KV
cache (a ring buffer under a window). ``attention_forward(...,
kv_override=(k, v))`` is the vlm family's cross-attention (keys and
values given, no RoPE). ``set_attention_options(bf16_psum=True)`` gives
the partial-sum projections (attention out-projection, MLP
down-projection, the experts' dispatch and combine) a bf16 result, as
the reference's ``psum_einsum``: computed in f32, rounded once.
"""
from __future__ import annotations

import math
import threading
from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models import sharding

NEG_INF = -1e30  # large-negative in f32; avoids NaN from (-inf) - (-inf)

# ---------------------------------------------------------------------------
# attention execution options (the reference's, per thread)
# ---------------------------------------------------------------------------
_opts = threading.local()


def set_attention_options(*, chunk_q: int = 0,
                          bf16_psum: bool = False) -> None:
    """``chunk_q > 0``: full-sequence attention over more than ``chunk_q``
    queries runs ``chunked_attention`` (scores a (chunk_q, S) tile at a
    time). ``bf16_psum``: the projections whose results are partial sums
    over the model axis (attention out-projection, MLP down-projection,
    the experts' dispatch and combine) give bf16 (``psum_einsum``)."""
    _opts.chunk_q = chunk_q
    _opts.bf16_psum = bf16_psum


def get_chunk_q() -> int:
    return getattr(_opts, "chunk_q", 0)


def psum_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of a partial-sum-producing projection: under
    ``bf16_psum`` its result in bf16, computed in the operands' type and
    rounded once, as ``jnp.einsum(..., preferred_element_type=bf16)``
    does on f32 operands."""
    out = torch.einsum(spec, a, b)
    return out.to(torch.bfloat16) if getattr(_opts, "bf16_psum", False) \
        else out


def _normal(shape, std: float, generator, device, home=None
            ) -> nn.Parameter:
    """Drawn on ``device``, kept on ``home`` (default: ``device``)."""
    w = torch.randn(shape, generator=generator, device=device) * std
    return nn.Parameter(w if home is None else w.to(home))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, *, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(torch.ones((d,),
                                                              device=device))})


def rmsnorm(p: Mapping[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Statistics in f32, result in x's dtype. Under a model axis the
    scale is gathered whole when it is split (x is whole on every rank)."""
    dt = x.dtype
    scale = sharding.whole(p["scale"], "scale", (x.shape[-1],))
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dt)


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
                   device=None, home=None) -> nn.ParameterDict:
    """Normal weights at std 1/√d; ``wo`` further scaled by
    1/√num_layers. Drawn on ``device`` from ``generator`` (a generator of
    that device), each kept on ``home`` as it is drawn (default:
    ``device``)."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    std = 1.0 / math.sqrt(d)
    p = nn.ParameterDict({
        "wq": _normal((d, nq, h), std, generator, device, home),
        "wk": _normal((d, nkv, h), std, generator, device, home),
        "wv": _normal((d, nkv, h), std, generator, device, home),
        "wo": _normal((nq, h, d), std / math.sqrt(cfg.num_layers), generator,
                      device, home),
    })
    if cfg.qkv_bias:
        for name, heads in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = nn.Parameter(torch.zeros(
                (heads, h), device=device if home is None else home))
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
                      backend: Optional[str] = None,
                      kv_override=None) -> torch.Tensor:
    """Full-sequence attention, x (B, S, d) -> (B, S, d).

    ``backend`` picks the attention route (``kernels.dispatch``): the
    reference follows only the ambient policy here, the port also takes
    the client's ``kernel_backend``, so ``"torch"`` means plain attention
    too. The kv heads go to the dispatch unexpanded. ``kv_override``: (k,
    v) (B, Sk, n_kv, h) for cross-attention; x gives only the queries
    (``wq``, ``bq``), and neither side gets RoPE, as the reference's (which
    also projects x's own k and v and drops them)."""
    mp = sharding.model_parallel_state()
    if kv_override is not None:
        if mp is not None:
            raise NotImplementedError(
                "cross-attention under a model axis is not ported yet: "
                "ROADMAP queue A item 11")
        q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        k, v = kv_override
    else:
        if mp is not None:
            if cfg.num_heads % mp.size == 0:
                return _attention_heads(p, x, cfg, mp, positions=positions,
                                        causal=causal, window=window,
                                        backend=backend)
            # heads the model axis does not divide: whole on every rank
            p = {k: sharding.whole(w, k, _attn_shape(k, cfg))
                 for k, w in p.items()}
        q, k, v = _qkv(p, x)
        if positions is not None:
            cos, sin = rope_angles(positions, cfg.resolved_head_dim,
                                   cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    chunk = get_chunk_q()
    if chunk and x.shape[1] > chunk:
        n_rep = cfg.num_heads // cfg.num_kv_heads
        o = chunked_attention(q, _expand_kv(k, n_rep), _expand_kv(v, n_rep),
                              causal=causal, window=window, chunk_q=chunk)
    else:
        o = dispatch.flash_attention(q, k, v, causal=causal, window=window,
                                     backend=backend)
    return psum_einsum("bsnh,nhd->bsd", o, p["wo"])


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0,
                      chunk_q: int = 512) -> torch.Tensor:
    """Query-chunked attention, q/k/v (B, S, N, h) with k/v expanded to N
    heads: a loop over query tiles, so a step holds (B, N, C, Sk) scores,
    not (B, N, Sq, Sk). The reference's ``lax.scan`` route (the last tile
    padded to C rows, as there)."""
    b, sq, n, h = q.shape
    sk = k.shape[1]
    c = min(chunk_q, sq)
    pad = (-sq) % c
    if pad:
        q = torch.cat([q, q.new_zeros((b, pad, n, h))], dim=1)
    scale = 1.0 / math.sqrt(h)
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for ci in range((sq + pad) // c):
        qc = q[:, ci * c:(ci + 1) * c]
        logits = torch.einsum("bqnh,bknh->bnqk", qc, k).to(torch.float32) \
            * scale
        qpos = ci * c + torch.arange(c, device=q.device)[:, None]
        if causal:
            m = kpos <= qpos
            if window > 0:
                m = m & (kpos > qpos - window)
        else:
            m = torch.ones((c, sk), dtype=torch.bool, device=q.device)
        logits = torch.where(m[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bnqk,bknh->bqnh", probs, v))
    return torch.cat(outs, dim=1)[:, :sq]


def attention_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window: int = 0):
    """One decode token, x (B, 1, d), against a KV cache (B, C, n_kv, h)
    at position ``pos`` (an int). Returns (out (B, 1, d), new_k, new_v):
    the caches with this token's key and value written at ``pos``
    (``pos mod C``, a ring buffer, when ``window`` > 0), new tensors as
    the reference's ``dynamic_update_slice`` makes them. Grouped-query
    einsums: the cache is never expanded to the query heads."""
    if sharding.model_parallel_state() is not None:
        raise NotImplementedError(
            "decode under a model axis is not ported yet: ROADMAP queue A "
            "item 11")
    b = x.shape[0]
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    nrep = nq // nkv
    q, k, v = _qkv(p, x)
    s_cache = cache_k.shape[1]
    slot = pos % s_cache if window > 0 else pos
    cos, sin = rope_angles(torch.tensor([pos], device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    new_k, new_v = cache_k.clone(), cache_v.clone()
    new_k[:, slot] = k[:, 0].to(cache_k.dtype)
    new_v[:, slot] = v[:, 0].to(cache_v.dtype)
    kpos = torch.arange(s_cache, device=x.device)
    # a ring slot is valid once pos >= C; before that only slots <= pos
    valid = (torch.ones_like(kpos, dtype=torch.bool)
             if window > 0 and pos >= s_cache else kpos <= pos)
    h = q.shape[-1]
    qg = q.reshape(b, 1, nkv, nrep, h)
    scale = 1.0 / math.sqrt(h)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg,
                          new_k.to(qg.dtype)).to(torch.float32) * scale
    logits = torch.where(valid[None, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    og = torch.einsum("bgrqk,bkgh->bqgrh", probs, new_v.to(x.dtype))
    o = og.reshape(b, 1, nq, h)
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"]), new_k, new_v


def _attn_shape(name: str, cfg) -> tuple:
    """The whole shape of attention leaf ``name``."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {"wq": (d, nq, h), "wk": (d, nkv, h), "wv": (d, nkv, h),
            "wo": (nq, h, d), "bq": (nq, h), "bk": (nkv, h),
            "bv": (nkv, h)}[name]


def _attention_heads(p, x, cfg, mp, *, positions, causal, window, backend):
    """Attention over this rank's block of query heads: ``wq`` (and
    ``bq``) column-parallel, the kv heads those queries read (this rank's
    own ``wk``/``wv`` slice when the kv heads split alike, else cut from
    the gathered leaves), ``wo`` row-parallel and the partial outputs
    summed over the model axis. The kernel sees the local GQA ratio; kv
    heads are repeated per query only when the local block does not map
    onto whole groups."""
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    n = nq // mp.size
    lo, hi = mp.index * n, (mp.index + 1) * n
    group = nq // nkv
    kv_lo, kv_hi = lo // group, (hi - 1) // group + 1
    xf = sharding.copy_to_model(x)

    def leaf(name, dim, a, b):
        return sharding.part(p[name], name, _attn_shape(name, cfg), dim, a, b)
    q = torch.einsum("bsd,dnh->bsnh", xf, leaf("wq", 1, lo, hi))
    k = torch.einsum("bsd,dnh->bsnh", xf, leaf("wk", 1, kv_lo, kv_hi))
    v = torch.einsum("bsd,dnh->bsnh", xf, leaf("wv", 1, kv_lo, kv_hi))
    if "bq" in p:
        q = q + leaf("bq", 0, lo, hi)
        k = k + leaf("bk", 0, kv_lo, kv_hi)
        v = v + leaf("bv", 0, kv_lo, kv_hi)
    if positions is not None:
        cos, sin = rope_angles(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kv_of = torch.arange(lo, hi) // group - kv_lo    # each query's kv head
    ratio = n // (kv_hi - kv_lo)
    if n % (kv_hi - kv_lo) or not torch.equal(
            kv_of, torch.arange(n) // ratio):
        idx = kv_of.to(k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    o = dispatch.flash_attention(q, k, v, causal=causal, window=window,
                                 backend=backend)
    out = psum_einsum("bsnh,nhd->bsd", o, leaf("wo", 0, lo, hi))
    return sharding.reduce_from_model(out)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, *,
             generator: Optional[torch.Generator] = None,
             device=None, home=None) -> nn.ParameterDict:
    std = 1.0 / math.sqrt(d_model)
    return nn.ParameterDict({
        "wg": _normal((d_model, d_ff), std, generator, device, home),
        "wu": _normal((d_model, d_ff), std, generator, device, home),
        "wd": _normal((d_ff, d_model), 1.0 / math.sqrt(d_ff), generator,
                      device, home),
    })


def mlp_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU. Under a model axis (``d_ff``: the whole ff width) the ff
    block splits: ``wg``/``wu`` column-, ``wd`` row-parallel, the partial
    outputs summed; an ff width the axis does not divide runs whole on
    every rank from gathered leaves."""
    mp = sharding.model_parallel_state()
    if mp is not None:
        d = x.shape[-1]
        shapes = {"wg": (d, d_ff), "wu": (d, d_ff), "wd": (d_ff, d)}
        if d_ff % mp.size:
            p = {k: sharding.whole(w, k, shapes[k]) for k, w in p.items()}
        else:
            n = d_ff // mp.size
            lo, hi = mp.index * n, (mp.index + 1) * n
            xf = sharding.copy_to_model(x)

            def leaf(name, dim):
                return sharding.part(p[name], name, shapes[name], dim, lo, hi)
            g = torch.einsum("bsd,df->bsf", xf, leaf("wg", 1))
            u = torch.einsum("bsd,df->bsf", xf, leaf("wu", 1))
            h = torch.nn.functional.silu(g) * u
            return sharding.reduce_from_model(
                psum_einsum("bsf,fd->bsd", h, leaf("wd", 0)))
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    u = torch.einsum("bsd,df->bsf", x, p["wu"])
    h = torch.nn.functional.silu(g) * u
    return psum_einsum("bsf,fd->bsd", h, p["wd"])
