"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, a sequential scan with an
exponential-gating stabilizer).

The reference's ``repro.models.ssm`` in PyTorch, with its names,
parameter names and layouts (``wq``/``wk``/``wv (d_in, N, h)``, the
sLSTM's block-diagonal recurrent weights ``rz``/``ri``/``rf``/``ro (N,
h, h)``) and its arithmetic. The mLSTM trains in the chunkwise-parallel
form: within a chunk an (L, L) decay-weighted product, across chunks a
Python loop carrying the (B, N, h, h) matrix state (the reference's
``lax.scan``). The sLSTM runs a Python loop over time, by one of two
routes (``set_slstm_custom_vjp``): the reference's custom VJP as a
``torch.autograd.Function`` (the forward saves each step's input state;
the backward takes each step's VJP in reverse and accumulates the
recurrent weights' gradient with the batch axis kept, summed once after
the loop), or plain autograd through the loop. Decode carries state that
is O(1) in the sequence length. No TPU kernel is on this path: the
reference's scans are plain JAX, and these are plain PyTorch.

Under a model axis (``models.sharding.model_parallel``) each block takes
this rank's slices as ``fed.mesh.model_split`` places them, with no
collective inside the chunk loop or the time loop. mLSTM: ``wup`` and
``wgate`` column-parallel (a block of d_in), ``u`` gathered whole, the
gate preactivations from the contraction-split ``wi``/``wf`` summed over
the axis, and ``wdown`` row-parallel; where ``wq``/``wk``/``wv`` split on
heads the chunk loop runs the local heads (its output is the rank's
block of d_in), where they split on ``h`` (heads the axis does not
divide) the projections' h blocks are gathered, so the scores contract
over the whole of h, and every head runs on every rank. sLSTM: the four
input projections' partial sums (``wz``/``wi``/``wf`` split on their
contraction dim; the replicated ``wo`` cut alike) reduced in one
all-reduce before the loop, the recurrent matrices (split on ``h``, not
on heads) gathered whole once a forward, and the recurrence run whole
on every rank: it is bound by its per-step launches, not its arithmetic,
so local heads would save no time and would need a gather of its output
(and heads the axis divides); its gated MLP contraction-split in, the
odd ff width whole, ``wdown`` column-parallel out and gathered. The
sLSTM's custom backward runs under ``vmap`` (the cohort engine's client
axis) one lane at a time.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding
from repro_torch.models.layers import _normal, init_rmsnorm, rmsnorm

CHUNK = 256
_CLAMP = 8.0  # clamp on the input-gate preactivation (exp() in f32 range)

# The reference's sLSTM time-scan unroll factor: an XLA lever (it lets
# XLA merge the recurrent-weight gradient's per-step all-reduces under a
# sharded batch). The port's loop has no unroll and no collectives, so the
# setting is kept for the reference's callers and changes no result.
SLSTM_UNROLL = 1


def set_slstm_unroll(k: int) -> None:
    """Kept from the reference (an XLA collective lever); the port's
    results do not depend on it."""
    global SLSTM_UNROLL
    SLSTM_UNROLL = max(1, int(k))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(d_model: int, num_heads: int, *,
               generator: Optional[torch.Generator] = None, device=None,
               home=None) -> nn.ParameterDict:
    """Pre-up-projection mLSTM block (projection factor 2): normal
    weights at std 1/√d (inputs of width d) and 1/√(2d) (width 2d), the
    forget-gate bias 3 (open at init)."""
    d_in = 2 * d_model
    h = d_in // num_heads
    std, std_i = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_in)
    keep = device if home is None else home

    def w(shape, s):
        return _normal(shape, s, generator, device, home)
    return nn.ParameterDict({
        "norm": init_rmsnorm(d_model, device=keep),
        "wup": w((d_model, d_in), std),
        "wgate": w((d_model, d_in), std),
        "wq": w((d_in, num_heads, h), std_i),
        "wk": w((d_in, num_heads, h), std_i),
        "wv": w((d_in, num_heads, h), std_i),
        "wi": w((d_in, num_heads), std_i),
        "bi": nn.Parameter(torch.zeros((num_heads,), device=keep)),
        "wf": w((d_in, num_heads), std_i),
        "bf": nn.Parameter(torch.full((num_heads,), 3.0, device=keep)),
        "wdown": w((d_in, d_model), std_i),
    })


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, N, hk, hv) matrix memory
    n: torch.Tensor   # (B, N, hk) normalizer


def mlstm_zero_state(batch: int, num_heads: int, head_dim: int,
                     dtype=torch.float32, device=None) -> MLSTMState:
    return MLSTMState(
        c=torch.zeros((batch, num_heads, head_dim, head_dim), dtype=dtype,
                      device=device),
        n=torch.zeros((batch, num_heads, head_dim), dtype=dtype,
                      device=device))


def _mlstm_gates(p: Mapping[str, torch.Tensor], u: torch.Tensor):
    """u (B, S, d_in) -> per-head q, k, v and (log i, log f) in f32."""
    q = torch.einsum("bsd,dnh->bsnh", u, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", u, p["wk"]) / math.sqrt(
        p["wk"].shape[-1])
    v = torch.einsum("bsd,dnh->bsnh", u, p["wv"])
    log_i, log_f = _log_gates(torch.einsum("bsd,dn->bsn", u, p["wi"]),
                              torch.einsum("bsd,dn->bsn", u, p["wf"]),
                              p["bi"], p["bf"])
    return q, k, v, log_i, log_f


def _log_gates(pre_i, pre_f, bi, bf):
    log_i = torch.clamp((pre_i + bi).to(torch.float32), -_CLAMP, _CLAMP)
    log_f = F.logsigmoid((pre_f + bf).to(torch.float32))
    return log_i, log_f


def _mlstm_shapes(d: int, num_heads: int) -> dict:
    d_in = 2 * d
    h = d_in // num_heads
    return {"wup": (d, d_in), "wgate": (d, d_in),
            "wq": (d_in, num_heads, h), "wk": (d_in, num_heads, h),
            "wv": (d_in, num_heads, h), "wi": (d_in, num_heads),
            "wf": (d_in, num_heads), "bi": (num_heads,),
            "bf": (num_heads,), "wdown": (d_in, d)}


def _mlstm_split(d: int, num_heads: int) -> Optional[int]:
    """Under a model axis, the dim of ``wq`` the split compute follows: 1
    (local heads) or 2 (h blocks, gathered); None without an axis, or
    where d_in or that dim does not split (the block then runs whole on
    every rank from gathered leaves)."""
    mp = sharding.model_parallel_state()
    if mp is None or (2 * d) % mp.size:
        return None
    s = mp.split_dim("wq", _mlstm_shapes(d, num_heads)["wq"])
    return s if s in (1, 2) else None


def mlstm_local_heads(d: int, num_heads: int) -> int:
    """The heads whose state a rank carries under the installed model
    axis (all of them without one)."""
    mp = sharding.model_parallel_state()
    return num_heads // mp.size if _mlstm_split(d, num_heads) == 1 \
        else num_heads


def _mlstm_in(p: Mapping[str, torch.Tensor], xn: torch.Tensor,
              num_heads: int):
    """The normed input xn (B, S, d) -> (q, k, v, log i, log f, out):
    this rank's heads' (all of them unsharded) projections and gates, and
    ``out(o)``, o (B, S, heads·h) the chunk loop's output, the block's
    projection back to d (summed over the model axis)."""
    dt = xn.dtype
    d = xn.shape[-1]
    split = _mlstm_split(d, num_heads)
    mp = sharding.model_parallel_state()
    shapes = _mlstm_shapes(d, num_heads)
    if split is None:
        if mp is not None:
            p = {k: sharding.whole(w, k, shapes.get(k, (d,)))
                 for k, w in p.items() if k != "norm"}
        u = torch.einsum("bsd,de->bse", xn, p["wup"])
        gate = F.silu(torch.einsum("bsd,de->bse", xn, p["wgate"]))
        q, k, v, log_i, log_f = _mlstm_gates(p, u)

        def out(o):
            return torch.einsum("bse,ed->bsd", o.to(dt) * gate, p["wdown"])
        return q, k, v, log_i, log_f, out

    def leaf(name, dim, lo, hi):
        return sharding.part(p[name], name, shapes[name], dim, lo, hi)
    h = shapes["wq"][2]
    e_lo, e_hi = sharding.block(2 * d)
    xf = sharding.copy_to_model(xn)
    u_loc = torch.einsum("bsd,de->bse", xf, leaf("wup", 1, e_lo, e_hi))
    gate = F.silu(torch.einsum("bsd,de->bse", xf,
                               leaf("wgate", 1, e_lo, e_hi)))
    # u whole on every rank; its gradient, partial on each (its heads' or
    # its h block's), summed over the axis
    u = sharding.copy_to_model(sharding.gather_from_model(u_loc, -1))
    pre = sharding.reduce_from_model(torch.stack(
        [torch.einsum("bsd,dn->bsn", u_loc, leaf(w, 0, e_lo, e_hi))
         for w in ("wi", "wf")], dim=-2))                 # (B, S, 2, N)
    if split == 1:
        n_lo, n_hi = sharding.block(num_heads)
        q, k, v = (torch.einsum("bsd,dnh->bsnh", u, leaf(w, 1, n_lo, n_hi))
                   for w in ("wq", "wk", "wv"))
        pre = sharding.scatter_to_model(pre, -1)
        bi, bf = leaf("bi", 0, n_lo, n_hi), leaf("bf", 0, n_lo, n_hi)
    else:
        h_lo, h_hi = sharding.block(h)
        q, k, v = (sharding.gather_from_model(torch.einsum(
            "bsd,dnh->bsnh", u, leaf(w, 2, h_lo, h_hi)), -1)
            for w in ("wq", "wk", "wv"))
        bi, bf = sharding.whole_all([p["bi"], p["bf"]], ["bi", "bf"],
                                    shapes["bi"])
    k = k / math.sqrt(h)
    log_i, log_f = _log_gates(pre[..., 0, :], pre[..., 1, :], bi, bf)

    def out(o):
        if split == 2:                  # every head ran: this rank's block
            o = sharding.scatter_to_model(o, -1)
        return sharding.reduce_from_model(torch.einsum(
            "bse,ed->bsd", o.to(dt) * gate, leaf("wdown", 0, e_lo, e_hi)))
    return q, k, v, log_i, log_f, out


def _mlstm_chunk(q, k, v, log_i, log_f, state: MLSTMState):
    """One chunk, parallel within: q, k, v (B, L, N, h), gates (B, L, N)
    f32. Returns (out (B, L, N, h), the chunk-end state)."""
    L = q.shape[1]
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    c0, n0 = state.c.to(torch.float32), state.n.to(torch.float32)
    A = torch.cumsum(log_f, dim=1)                        # (B, L, N)
    # the intra-chunk decay D[t, s] = exp(A_t - A_s + log_i_s), s <= t;
    # above the diagonal the exponent is clamped, so that the zeroed
    # entries' gradient is 0 · finite, not 0 · inf
    expo = A[:, :, None, :] - A[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    D = torch.where(tri, torch.exp(torch.clamp_max(expo, _CLAMP * 4)),
                    0.0)                                  # (B, L, L, N)
    scores = torch.einsum("btnh,bsnh->btsn", qf, kf) * D
    intra = torch.einsum("btsn,bsnh->btnh", scores, vf)
    intra_n = torch.einsum("btsn,bsnh->btnh", D, kf)
    # the carried-in state's contribution
    decay_t = torch.exp(A)                                # (B, L, N)
    inter = torch.einsum("btnh,bnhg->btng", qf, c0) * decay_t[..., None]
    inter_n = n0[:, None] * decay_t[..., None]
    num = intra + inter
    nn_ = intra_n + inter_n
    denom = torch.clamp_min(torch.abs(torch.einsum("btnh,btnh->btn", qf,
                                                   nn_)), 1.0)
    out = num / denom[..., None]
    # the chunk-end state
    aL = A[:, -1, :]                                      # (B, N)
    w = torch.exp(aL[:, None, :] - A + log_i)             # (B, L, N)
    c_new = c0 * torch.exp(aL)[..., None, None] \
        + torch.einsum("bsn,bsnh,bsng->bnhg", w, kf, vf)
    n_new = n0 * torch.exp(aL)[..., None] \
        + torch.einsum("bsn,bsnh->bnh", w, kf)
    return out, MLSTMState(c_new, n_new)


def mlstm_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  num_heads: int, *, chunk: int = CHUNK,
                  eps: float = 1e-5) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), the residual added: training and
    prefill. The sequence is padded to a multiple of the chunk with zeros
    in q, k, v, log i and log f, as the reference pads it."""
    b, s, _ = x.shape
    xn = rmsnorm(p["norm"], x, eps)
    q, k, v, log_i, log_f, proj = _mlstm_in(p, xn, num_heads)
    n, h = q.shape[2], q.shape[-1]
    L = min(chunk, s)
    pad = (-s) % L
    if pad:
        def padf(a):
            return torch.cat([a, a.new_zeros((b, pad) + a.shape[2:])], 1)
        q, k, v, log_i, log_f = map(padf, (q, k, v, log_i, log_f))
    state = mlstm_zero_state(b, n, h, device=x.device)
    outs = []
    for c in range(0, s + pad, L):
        out, state = _mlstm_chunk(q[:, c:c + L], k[:, c:c + L],
                                  v[:, c:c + L], log_i[:, c:c + L],
                                  log_f[:, c:c + L], state)
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :s]
    return x + proj(out.reshape(b, s, -1))


def mlstm_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 state: MLSTMState, num_heads: int, eps: float = 1e-5):
    """x (B, 1, d) -> (y, the new state)."""
    b = x.shape[0]
    xn = rmsnorm(p["norm"], x, eps)
    q, k, v, log_i, log_f, proj = _mlstm_in(p, xn, num_heads)
    qf, kf, vf = (a[:, 0].to(torch.float32) for a in (q, k, v))
    i_t = torch.exp(log_i[:, 0])                          # (B, N)
    f_t = torch.exp(log_f[:, 0])
    c = state.c.to(torch.float32) * f_t[..., None, None] \
        + i_t[..., None, None] * torch.einsum("bnh,bng->bnhg", kf, vf)
    n = state.n.to(torch.float32) * f_t[..., None] + i_t[..., None] * kf
    num = torch.einsum("bnh,bnhg->bng", qf, c)
    denom = torch.clamp_min(torch.abs(torch.einsum("bnh,bnh->bn", qf, n)),
                            1.0)
    return x + proj((num / denom[..., None]).reshape(b, 1, -1)), \
        MLSTMState(c, n)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(d_model: int, num_heads: int, *,
               generator: Optional[torch.Generator] = None, device=None,
               home=None) -> nn.ParameterDict:
    """Post-up-projection sLSTM block: the sLSTM at width d and a gated
    MLP of width 4d/3. Input weights at std 1/√d, the block-diagonal
    recurrent weights (N, h, h) at 1/√h, the forget-gate bias 3."""
    h = d_model // num_heads
    d_ff = (4 * d_model) // 3
    std = 1.0 / math.sqrt(d_model)
    keep = device if home is None else home

    def w(shape, s):
        return _normal(shape, s, generator, device, home)

    def bias(v):
        return nn.Parameter(torch.full((d_model,), v, device=keep))
    p = {"norm": init_rmsnorm(d_model, device=keep)}
    for g in "zifo":
        p["w" + g] = w((d_model, d_model), std)
    for g in "zifo":
        p["r" + g] = w((num_heads, h, h), 1.0 / math.sqrt(h))
    for g in "zifo":
        p["b" + g] = bias(3.0 if g == "f" else 0.0)
    p["norm2"] = init_rmsnorm(d_model, device=keep)
    p["wup"] = w((d_model, d_ff), std)
    p["wgate"] = w((d_model, d_ff), std)
    p["wdown"] = w((d_ff, d_model), 1.0 / math.sqrt(d_ff))
    return nn.ParameterDict(p)


class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, D)
    c: torch.Tensor   # (B, D)
    n: torch.Tensor   # (B, D)
    m: torch.Tensor   # (B, D) log-space stabilizer


def slstm_zero_state(batch: int, d_model: int, dtype=torch.float32,
                     device=None) -> SLSTMState:
    z = torch.zeros((batch, d_model), dtype=dtype, device=device)
    return SLSTMState(z, z, z, torch.full((batch, d_model), -1e9,
                                          dtype=torch.float32,
                                          device=device))


def _local_step(recs, state: SLSTMState) -> SLSTMState:
    """The step's arithmetic given its preactivations ``recs`` (z, i, f,
    o; the input and recurrent contributions summed)."""
    rz, ri, rf, ro = recs
    z = torch.tanh(rz)
    i_pre = ri.to(torch.float32)
    f_pre = rf.to(torch.float32)
    o = torch.sigmoid(ro)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state.m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(log_f + state.m - m_new)
    c = f_s * state.c.to(torch.float32) + i_s * z.to(torch.float32)
    n = f_s * state.n.to(torch.float32) + i_s
    h = (o.to(torch.float32) * c / torch.clamp_min(n, 1e-6)).to(
        state.h.dtype)
    return SLSTMState(h, c.to(state.c.dtype), n.to(state.n.dtype), m_new)


def _recs(rmats, hprev: torch.Tensor, wx_t, num_heads: int):
    """The four preactivations: ``wx_t`` plus ``hprev`` through each
    block-diagonal recurrent weight."""
    b, d = hprev.shape
    hh = hprev.reshape(b, num_heads, -1)
    return tuple(w + torch.einsum("bnh,nhg->bng", hh, r).reshape(b, d)
                 for w, r in zip(wx_t, rmats))


def _slstm_step(rmats, num_heads: int, state: SLSTMState,
                zi_fi_oi) -> SLSTMState:
    """One timestep; ``rmats``: the recurrent weights (rz, ri, rf, ro)
    whole; ``zi_fi_oi``: the precomputed Wx + b (B, D) each."""
    return _local_step(_recs(rmats, state.h, zi_fi_oi, num_heads), state)


class _SLSTMScan(torch.autograd.Function):
    """The reference's ``_slstm_scan`` custom VJP: ``apply(num_heads, rz,
    ri, rf, ro, wz, wi, wf, wo)`` with each w (S, B, D) time-major ->
    (hs (S, B, D), then each step's input state h, c, n, m (S, B, D),
    not differentiable). The forward keeps each step's input state; the
    backward runs the steps in reverse, takes each step's VJP (autograd of
    ``_local_step`` from its saved state) and accumulates the recurrent
    weights' gradient with the batch axis kept, (B, N, h, h), summed over
    the batch once after the loop. Under ``vmap`` each lane runs on its
    own."""

    @staticmethod
    def forward(num_heads, rz, ri, rf, ro, wz, wi, wf, wo):
        rmats, wx = (rz, ri, rf, ro), (wz, wi, wf, wo)
        s, b, d = wz.shape
        state = slstm_zero_state(b, d, wz.dtype, device=wz.device)
        prev = [[] for _ in range(4)]
        hs = []
        for t in range(s):
            for acc, v in zip(prev, state):
                acc.append(v)
            state = _local_step(_recs(rmats, state.h,
                                      tuple(w[t] for w in wx), num_heads),
                                state)
            hs.append(state.h)
        return (torch.stack(hs), *(torch.stack(a) for a in prev))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.num_heads = inputs[0]
        ctx.save_for_backward(*inputs[1:], *output[1:])
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def vmap(info, in_dims, num_heads, *ts):
        lanes = []
        for i in range(info.batch_size):
            lanes.append(_SLSTMScan.apply(num_heads, *(
                t if bd is None else t.select(bd, i)
                for t, bd in zip(ts, in_dims[1:]))))
        return (tuple(torch.stack(outs) for outs in zip(*lanes)),
                (0,) * 5)

    @staticmethod
    def backward(ctx, g_hs, *_):
        saved = ctx.saved_tensors
        rmats, wx, prev = saved[:4], saved[4:8], saved[8:]
        n_h = ctx.num_heads
        s, b, d = wx[0].shape
        hd = d // n_h
        st_dt = wx[0].dtype
        dR = [torch.zeros((b, n_h, hd, hd), dtype=torch.float32,
                          device=g_hs.device) for _ in range(4)]
        dh = torch.zeros((b, d), dtype=st_dt, device=g_hs.device)
        dc = torch.zeros_like(dh)
        dn = torch.zeros_like(dh)
        dm = torch.zeros((b, d), dtype=torch.float32, device=g_hs.device)
        dwx = [[None] * s for _ in range(4)]
        for t in range(s - 1, -1, -1):
            st = SLSTMState(*(a[t] for a in prev))
            with torch.enable_grad():
                recs = tuple(r.detach().requires_grad_(True) for r in
                             _recs(rmats, st.h, tuple(w[t] for w in wx),
                                   n_h))
                leaves = SLSTMState(*(a.detach().requires_grad_(True)
                                      for a in st))
                new = _local_step(recs, leaves)
                grads = torch.autograd.grad(
                    tuple(new), recs + tuple(leaves),
                    (dh + g_hs[t], dc, dn, dm), allow_unused=True)
            d_recs = [torch.zeros_like(r) if g is None else g
                      for g, r in zip(grads[:4], recs)]
            d_state = [torch.zeros_like(a) if g is None else g
                       for g, a in zip(grads[4:], leaves)]
            # dR accumulated WITH the batch axis, as the reference's
            hprev = st.h.reshape(b, n_h, hd).to(torch.float32)
            drs = [dr.reshape(b, n_h, hd).to(torch.float32)
                   for dr in d_recs]
            for acc, dr in zip(dR, drs):
                acc += torch.einsum("bnh,bng->bnhg", hprev, dr)
            # the cotangent into h_{t-1} through the recurrent products
            dh_prev = d_state[0].to(torch.float32)
            for dr, r in zip(drs, rmats):
                dh_prev = dh_prev + torch.einsum(
                    "bng,nhg->bnh", dr, r.to(torch.float32)).reshape(b, d)
            for j in range(4):
                dwx[j][t] = d_recs[j]          # wx enters additively
            dh = dh_prev.to(g_hs.dtype)
            dc, dn, dm = d_state[1], d_state[2], d_state[3]
        d_rmats = [torch.sum(a, dim=0).to(r.dtype)
                   for a, r in zip(dR, rmats)]
        return (None, *d_rmats, *(torch.stack(g) for g in dwx))


USE_SLSTM_CUSTOM_VJP = True


def set_slstm_custom_vjp(on: bool) -> None:
    """True (the default, as the reference's): the sLSTM's backward is
    ``_SLSTMScan``'s; False: plain autograd through the time loop."""
    global USE_SLSTM_CUSTOM_VJP
    USE_SLSTM_CUSTOM_VJP = bool(on)


def _slstm_in(p: Mapping[str, torch.Tensor], xn: torch.Tensor,
              num_heads: int):
    """The normed input xn (B, S, d) -> (the four preactivations Wx + b
    (B, S, d) each, the recurrent weights (N, h, h) each), whole on every
    rank. Under a model axis the input projections are cut on their
    contraction dim (``wo``, replicated, alike) and their partial sums
    reduced in one all-reduce; the biases and recurrent weights are
    gathered whole."""
    d = xn.shape[-1]
    h = d // num_heads
    mp = sharding.model_parallel_state()
    if mp is None:
        return (tuple(torch.einsum("bsd,de->bse", xn, p["w" + g])
                      + p["b" + g] for g in "zifo"),
                tuple(p["r" + g] for g in "zifo"))
    bias = sharding.whole_all([p["b" + g] for g in "zifo"],
                              ["b" + g for g in "zifo"], (d,))
    rmats = tuple(sharding.whole_all([p["r" + g] for g in "zifo"],
                                     ["r" + g for g in "zifo"],
                                     (num_heads, h, h)))
    if d % mp.size:
        wx = tuple(torch.einsum("bsd,de->bse", xn, sharding.whole(
            p["w" + g], "w" + g, (d, d))) for g in "zifo")
    else:
        lo, hi = sharding.block(d)
        xs = sharding.scatter_to_model(xn, -1)
        wx = sharding.reduce_from_model(torch.stack([
            torch.einsum("bsd,de->bse", xs, sharding.part(
                p["w" + g], "w" + g, (d, d), 0, lo, hi)) for g in "zifo"]))
    return tuple(w + b for w, b in zip(wx, bias)), rmats


def _gated_mlp(p, x, eps):
    """The sLSTM block's gated MLP (width 4d/3). Under a model axis
    ``wup``/``wgate`` are cut on their contraction dim, their partial sums
    reduced in one all-reduce (the odd ff width stays whole), and
    ``wdown`` runs column-parallel, its output blocks gathered."""
    xn2 = rmsnorm(p["norm2"], x, eps)
    mp = sharding.model_parallel_state()
    d = x.shape[-1]
    f = (4 * d) // 3
    wdown = p["wdown"]
    if mp is None or d % mp.size:
        shapes = {"wup": (d, f), "wgate": (d, f)}
        w = {k: sharding.whole(p[k], k, shapes[k]) for k in shapes}
        u = torch.einsum("bsd,df->bsf", xn2, w["wup"])
        g = torch.einsum("bsd,df->bsf", xn2, w["wgate"])
        if mp is not None:
            wdown = sharding.whole(wdown, "wdown", (f, d))
    else:
        lo, hi = sharding.block(d)
        xs = sharding.scatter_to_model(xn2, -1)
        u, g = sharding.reduce_from_model(torch.stack([
            torch.einsum("bsd,df->bsf", xs, sharding.part(
                p[k], k, (d, f), 0, lo, hi)) for k in ("wup", "wgate")]))
    # jax.nn.gelu's default is the tanh approximation
    y = u * F.gelu(g, approximate="tanh")
    if mp is None or d % mp.size:
        return torch.einsum("bsf,fd->bsd", y, wdown)
    return sharding.gather_from_model(torch.einsum(
        "bsf,fd->bsd", sharding.copy_to_model(y),
        sharding.part(wdown, "wdown", (f, d), 1, lo, hi)), -1)


def slstm_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): a sequential loop over time, then the
    gated MLP, each with its residual."""
    b, s, d = x.shape
    xn = rmsnorm(p["norm"], x, eps)
    wx, rmats = _slstm_in(p, xn, num_heads)
    if USE_SLSTM_CUSTOM_VJP:
        hs = _SLSTMScan.apply(num_heads, *rmats,
                              *(w.transpose(0, 1) for w in wx))[0]
        h = hs.transpose(0, 1)
    else:
        state = slstm_zero_state(b, d, x.dtype, device=x.device)
        hs = []
        for t in range(s):
            state = _slstm_step(rmats, num_heads, state,
                                tuple(w[:, t] for w in wx))
            hs.append(state.h)
        h = torch.stack(hs, dim=1)
    x = x + h
    return x + _gated_mlp(p, x, eps)


def slstm_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 state: SLSTMState, num_heads: int, eps: float = 1e-5):
    """x (B, 1, d) -> (y, the new state)."""
    wx, rmats = _slstm_in(p, rmsnorm(p["norm"], x, eps), num_heads)
    state = _slstm_step(rmats, num_heads, state, tuple(w[:, 0] for w in wx))
    x = x + state.h[:, None]
    return x + _gated_mlp(p, x, eps), state
