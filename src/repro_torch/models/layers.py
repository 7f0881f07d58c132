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
cache (a ring buffer under a window); under a model axis it runs the
local query heads against a cache of the kv heads they read
(``local_kv_heads``: a rank's own kv heads where they split, else the
shared ones whole). ``attention_forward(..., kv_override=(k, v))`` is
the vlm family's cross-attention (keys and values given, no RoPE; under
a model axis ``project_kv``'s local kv heads), ``attention_given_kv``
its decode against cached keys. ``set_attention_options(bf16_psum=True)``
gives the partial-sum projections (attention out-projection, MLP
down-projection, the experts' dispatch and combine) a bf16 result, as
the reference's ``psum_einsum``: computed in f32, rounded once; under a
model axis each rank rounds its partial product and the ranks' bf16
values are summed (``models.sharding``).
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
    if mp is not None and cfg.num_heads % mp.size == 0:
        return _attention_heads(p, x, cfg, mp, positions=positions,
                                causal=causal, window=window,
                                backend=backend, kv=kv_override)
    if mp is not None:
        # heads the model axis does not divide: whole on every rank
        p = {k: sharding.whole(w, k, _attn_shape(k, cfg))
             for k, w in p.items()}
    if kv_override is not None:
        q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        k, v = kv_override
    else:
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
    einsums: the cache is never expanded to the query heads. Under a
    model axis the cache holds ``local_kv_heads``: the local query heads
    attend to it, ``wo`` is row-parallel and the partial outputs are
    summed."""
    mp = sharding.model_parallel_state()
    if mp is not None and cfg.num_heads % mp.size == 0:
        q, k, v, kv_of, wo = _head_projections(p, x, cfg, mp)
        o, new_k, new_v = _decode_heads(q, k, v, cfg, cache_k, cache_v, pos,
                                        window, kv_of)
        out = torch.einsum("bsnh,nhd->bsd", o, wo)
        return sharding.reduce_from_model(out), new_k, new_v
    if mp is not None:
        p = {k: sharding.whole(w, k, _attn_shape(k, cfg))
             for k, w in p.items()}
    q, k, v = _qkv(p, x)
    o, new_k, new_v = _decode_heads(q, k, v, cfg, cache_k, cache_v, pos,
                                    window, None)
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"]), new_k, new_v


def _decode_heads(q, k, v, cfg, cache_k, cache_v, pos, window, kv_of):
    """``attention_decode``'s core on projected q (B, 1, n, h) and k, v
    (B, 1, n_kv, h): RoPE at ``pos``, the token written into the caches,
    the grouped scores. ``kv_of``: each query head's cache head when the
    heads do not map onto whole groups in order (the cache's heads are
    then picked per query), else None."""
    b, _, nq, _ = q.shape
    s_cache = cache_k.shape[1]
    slot = pos % s_cache if window > 0 else pos
    cos, sin = rope_angles(torch.tensor([pos], device=q.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    new_k, new_v = cache_k.clone(), cache_v.clone()
    new_k[:, slot] = k[:, 0].to(cache_k.dtype)
    new_v[:, slot] = v[:, 0].to(cache_v.dtype)
    kpos = torch.arange(s_cache, device=q.device)
    # a ring slot is valid once pos >= C; before that only slots <= pos
    valid = (torch.ones_like(kpos, dtype=torch.bool)
             if window > 0 and pos >= s_cache else kpos <= pos)
    h = q.shape[-1]
    ck, cv = new_k, new_v
    if kv_of is not None:
        idx = kv_of.to(ck.device)
        ck, cv = ck.index_select(2, idx), cv.index_select(2, idx)
    nkv = ck.shape[2]
    qg = q.reshape(b, 1, nkv, nq // nkv, h)
    scale = 1.0 / math.sqrt(h)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg,
                          ck.to(qg.dtype)).to(torch.float32) * scale
    logits = torch.where(valid[None, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    og = torch.einsum("bgrqk,bkgh->bqgrh", probs, cv.to(q.dtype))
    return og.reshape(b, 1, nq, h), new_k, new_v


def _attn_shape(name: str, cfg) -> tuple:
    """The whole shape of attention leaf ``name``."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {"wq": (d, nq, h), "wk": (d, nkv, h), "wv": (d, nkv, h),
            "wo": (nq, h, d), "bq": (nq, h), "bk": (nkv, h),
            "bv": (nkv, h)}[name]


def _head_block(cfg, mp):
    """This rank's query heads ``[lo, hi)`` (the model axis divides them),
    the kv heads they read ``[kv_lo, kv_hi)``, and each local query's head
    among those (a tensor) when the block does not map onto whole groups
    in order, else None."""
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    n = nq // mp.size
    lo, hi = mp.index * n, (mp.index + 1) * n
    group = nq // nkv
    kv_lo, kv_hi = lo // group, (hi - 1) // group + 1
    kv_of = torch.arange(lo, hi) // group - kv_lo    # each query's kv head
    ratio = n // (kv_hi - kv_lo)
    if n % (kv_hi - kv_lo) == 0 and torch.equal(kv_of,
                                                torch.arange(n) // ratio):
        kv_of = None
    return lo, hi, kv_lo, kv_hi, kv_of


def local_kv_heads(cfg) -> int:
    """The kv heads a rank's cache holds: those its query heads read
    under the installed model axis (its own block where the kv heads
    split, else the shared ones whole), all of them without one or when
    the axis does not divide the query heads."""
    mp = sharding.model_parallel_state()
    if mp is None or cfg.num_heads % mp.size:
        return cfg.num_kv_heads
    _, _, kv_lo, kv_hi, _ = _head_block(cfg, mp)
    return kv_hi - kv_lo


def project_kv(p: Mapping[str, torch.Tensor], src: torch.Tensor, cfg):
    """Keys and values of ``src`` (B, Sk, d) by ``p``'s ``wk``/``wv`` (no
    bias, no RoPE: the vlm's cross keys), (B, Sk, n_kv, h) each,
    unexpanded; under a model axis the kv heads this rank's query heads
    read (``local_kv_heads``), as ``attention_forward(kv_override=)`` and
    ``attention_given_kv`` take them."""
    mp = sharding.model_parallel_state()
    wk, wv = p["wk"], p["wv"]
    if mp is not None and cfg.num_heads % mp.size == 0:
        _, _, kv_lo, kv_hi, _ = _head_block(cfg, mp)
        src = sharding.copy_to_model(src)
        wk, wv = (sharding.part(p[n], n, _attn_shape(n, cfg), 1, kv_lo,
                                kv_hi) for n in ("wk", "wv"))
    elif mp is not None:
        wk, wv = (sharding.whole(p[n], n, _attn_shape(n, cfg))
                  for n in ("wk", "wv"))
    return (torch.einsum("bvd,dnh->bvnh", src, wk),
            torch.einsum("bvd,dnh->bvnh", src, wv))


def attention_given_kv(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                       cfg, k: torch.Tensor, v: torch.Tensor
                       ) -> torch.Tensor:
    """x's queries (``wq``, ``bq``; no RoPE) against the keys and values
    ``k``, ``v`` (B, Sk, n_kv, h), every key visible, by the plain scores
    (no kernel, as the reference's decode of the vlm's cross block); the
    out-projection without ``psum_einsum``, as there. Under a model axis
    the local query heads against ``project_kv``'s local kv heads, ``wo``
    row-parallel and the partial outputs summed."""
    mp = sharding.model_parallel_state()
    split = mp is not None and cfg.num_heads % mp.size == 0
    if split:
        q, k, v, kv_of, wo = _head_projections(p, x, cfg, mp, kv=(k, v))
        if kv_of is not None:
            idx = kv_of.to(k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
    else:
        if mp is not None:
            p = {n: sharding.whole(w, n, _attn_shape(n, cfg))
                 for n, w in p.items()}
        q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        wo = p["wo"]
    nrep = q.shape[2] // k.shape[2]
    mask = torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    att = attention_scores(q, _expand_kv(k.to(q.dtype), nrep),
                           _expand_kv(v.to(q.dtype), nrep), mask)
    out = torch.einsum("bsnh,nhd->bsd", att, wo)
    return sharding.reduce_from_model(out) if split else out


def _attention_heads(p, x, cfg, mp, *, positions, causal, window, backend,
                     kv=None):
    """Attention over this rank's block of query heads
    (``_head_projections``; ``kv``: given, for cross-attention, without
    RoPE), ``wo`` row-parallel and the partial outputs summed over the
    model axis. The kernel sees the local GQA ratio; kv heads are
    repeated per query only when the local block does not map onto whole
    groups."""
    q, k, v, kv_of, wo = _head_projections(p, x, cfg, mp, kv)
    if kv is None and positions is not None:
        cos, sin = rope_angles(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if kv_of is not None:
        idx = kv_of.to(k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    chunk = get_chunk_q()
    if chunk and x.shape[1] > chunk:
        n_rep = q.shape[2] // k.shape[2]
        o = chunked_attention(q, _expand_kv(k, n_rep), _expand_kv(v, n_rep),
                              causal=causal, window=window, chunk_q=chunk)
    else:
        o = dispatch.flash_attention(q, k, v, causal=causal, window=window,
                                     backend=backend)
    out = psum_einsum("bsnh,nhd->bsd", o, wo)
    return sharding.reduce_from_model(out)


def _head_projections(p, x, cfg, mp, kv=None):
    """This rank's block of query heads (the model axis divides them):
    q (``wq`` column-parallel, ``bq``), the kv heads those queries read
    (this rank's own ``wk``/``wv`` slice when the kv heads split alike,
    else cut from the gathered leaves; ``kv``: given, as ``project_kv``
    gives them) and the rows of ``wo`` for the block. Returns (q, k, v,
    ``_head_block``'s per-query kv heads or None, wo)."""
    lo, hi, kv_lo, kv_hi, kv_of = _head_block(cfg, mp)
    xf = sharding.copy_to_model(x)

    def leaf(name, dim, a, b):
        return sharding.part(p[name], name, _attn_shape(name, cfg), dim, a, b)
    q = torch.einsum("bsd,dnh->bsnh", xf, leaf("wq", 1, lo, hi))
    if "bq" in p:
        q = q + leaf("bq", 0, lo, hi)
    if kv is not None:
        k, v = kv
    else:
        k = torch.einsum("bsd,dnh->bsnh", xf, leaf("wk", 1, kv_lo, kv_hi))
        v = torch.einsum("bsd,dnh->bsnh", xf, leaf("wv", 1, kv_lo, kv_hi))
        if "bq" in p:
            k = k + leaf("bk", 0, kv_lo, kv_hi)
            v = v + leaf("bv", 0, kv_lo, kv_hi)
    return q, k, v, kv_of, leaf("wo", 0, lo, hi)


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
