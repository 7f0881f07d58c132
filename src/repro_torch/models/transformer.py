"""The backbone of ``repro.models.transformer`` as an ``nn.Module``, for
the families ``dense``, ``moe``, ``ssm`` and ``hybrid``, with its losses
and decode.

dense / moe: pre-norm GQA attention + SwiGLU (or, family ``moe``, a
mixture of experts: ``models.moe``) blocks, RoPE on positions
``arange(S)``, causal (a sliding window when the config or
``window_override`` asks). ssm (xLSTM): groups of an mLSTM and an sLSTM
block (``models.ssm``), ``num_layers // 2`` of them. hybrid (Griffin):
groups of ``hybrid_period - 1`` RG-LRU blocks (``models.rglru``, each
with a SwiGLU MLP) and one local-attention block whose window is
``local_window`` whatever ``cfg.attention`` says, ``num_layers //
hybrid_period`` of them. Then a final RMSNorm and an LM head (``lm_head
(d, V)`` applied as ``x @ head``, or the transposed embedding when
``tie_embeddings``). The reference scans stacked per-layer (or
per-group) parameters with ``lax.scan``; here a Python loop runs one
module per layer or group (``remat``: each under
``torch.utils.checkpoint``), and ``load_jax_params`` splits the
reference's stacked ``blocks`` (a leading layer or group axis, and
hybrid's ``rec`` leaves a second ``(period - 1)`` axis) into them.
``cross_entropy`` and ``train_loss`` are the LM objective (CE plus the
experts' load-balance loss), ``init_cache`` and ``decode_step`` one
token at a time against a KV cache or the recurrent state.

Parameters are f32, as the reference's ``init_params`` makes them by
default (the simulator never passes ``ArchConfig.dtype``). Under a model
axis (``models.sharding.model_parallel``) the dense and moe module
computes on this rank's slices of its leaves (``layers``): a vocab-split
``embed`` looks up its local rows and sums over the axis, a vocab-split
head gives local logits that are gathered whole, and a leaf split any
other way is gathered before use; the residual stream stays whole on
every rank. The ssm and hybrid families under a model axis, and the vlm
and audio families at all, are not ported yet (ROADMAP queue A item 11).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytree import host_values, targets
from repro_torch.common.types import ArchConfig, AttentionKind
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import sharding
from repro_torch.models import ssm as SSM

# ``lookup`` multiplies by the tokens' one-hot rows up to this vocab (the
# token scenario's, tens of labels); a larger vocab gathers rows
# (``_EmbedRows``)
ONEHOT_VOCAB_MAX = 1024
FAMILIES = ("dense", "moe", "ssm", "hybrid")
RECURRENT = ("ssm", "hybrid")


def refuse_family(cfg: ArchConfig) -> None:
    """Raise for a family the port does not build yet, naming its item."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            "ROADMAP queue A item 11")


def _refuse_model_axis(cfg: ArchConfig) -> None:
    """The recurrent families have no model-axis split yet."""
    if cfg.family in RECURRENT \
            and sharding.model_parallel_state() is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) under a model axis is not "
            "ported yet: ROADMAP queue A item 11")


class _EmbedRows(torch.autograd.Function):
    """``embed[tokens]`` with a backward that sums in a fixed order: the
    batch's distinct tokens (sorted), each one's gradient rows summed by a
    one-hot product over the (tokens, distinct) pairs, written into their
    rows. The same bits from run to run on the card and on the CPU at
    any one thread count, where ``embed[tokens]``'s backward accumulates
    rows in an order that changes from run to run. Not under ``vmap``
    (``torch.unique``)."""

    @staticmethod
    def forward(ctx, embed, tokens):
        flat = tokens.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.shape = tuple(embed.shape)
        return embed.index_select(0, flat).reshape(*tokens.shape,
                                                   embed.shape[1])

    @staticmethod
    def backward(ctx, g):
        flat, = ctx.saved_tensors
        uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
        onehot = (inv[:, None] == torch.arange(
            len(uniq), device=flat.device)).to(g.dtype)
        rows = onehot.T @ g.reshape(-1, ctx.shape[1])
        out = g.new_zeros(ctx.shape)
        out.index_copy_(0, uniq, rows)
        return out, None


class Transformer(nn.Module):
    """``init_params`` + ``forward`` + ``features`` of the reference for
    the dense, moe, ssm and hybrid families. ``kernel_backend`` routes
    attention (``kernels.dispatch``; None = the ambient policy)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 kernel_backend: Optional[str] = None, home=None):
        """Weights drawn on ``device`` from ``generator``, each leaf kept
        on ``home`` as soon as it is drawn (default: ``device``), so
        ``device`` holds one leaf's draw at a time, not the model."""
        super().__init__()
        refuse_family(cfg)
        self.cfg = cfg
        self.kernel_backend = kernel_backend
        d = cfg.d_model
        keep = device if home is None else home
        self.embed = L._normal((cfg.vocab_size, d), 0.02, generator, device,
                               home)
        self.final_norm = L.init_rmsnorm(d, device=keep)
        self.lm_head = (None if cfg.tie_embeddings else L._normal(
            (d, cfg.vocab_size), 1.0 / math.sqrt(d), generator, device,
            home))

        draw = dict(generator=generator, device=device, home=home)

        def block():
            # the reference's split order: attention, then the MLP or
            # the experts
            attn = L.init_attention(cfg, **draw)
            if cfg.moe is not None:
                ffn = ("moe", MOE.init_moe(d, cfg.d_ff, cfg.moe.num_experts,
                                           **draw))
            else:
                ffn = ("mlp", L.init_mlp(d, cfg.d_ff, **draw))
            return nn.ModuleDict({"ln1": L.init_rmsnorm(d, device=keep),
                                  "attn": attn,
                                  "ln2": L.init_rmsnorm(d, device=keep),
                                  ffn[0]: ffn[1]})

        def xlstm_group():
            return nn.ModuleDict({
                "mlstm": SSM.init_mlstm(d, cfg.num_heads, **draw),
                "slstm": SSM.init_slstm(d, cfg.num_heads, **draw)})

        def griffin_group():
            def rec():
                return nn.ModuleDict({
                    "rglru": RG.init_rglru(d, **draw),
                    "ln2": L.init_rmsnorm(d, device=keep),
                    "mlp": L.init_mlp(d, cfg.d_ff, **draw)})
            attn = L.init_attention(cfg, **draw)
            return nn.ModuleDict({
                "rec": nn.ModuleList(rec() for _ in
                                     range(cfg.hybrid_period - 1)),
                "attn": nn.ModuleDict({
                    "ln1": L.init_rmsnorm(d, device=keep), "attn": attn,
                    "ln2": L.init_rmsnorm(d, device=keep),
                    "mlp": L.init_mlp(d, cfg.d_ff, **draw)})})

        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(
                xlstm_group() for _ in range(cfg.num_layers // 2))
        elif cfg.family == "hybrid":
            self.blocks = nn.ModuleList(
                griffin_group()
                for _ in range(cfg.num_layers // cfg.hybrid_period))
        else:
            self.blocks = nn.ModuleList(block()
                                        for _ in range(cfg.num_layers))

    @property
    def window(self) -> int:
        return (self.cfg.local_window
                if self.cfg.attention == AttentionKind.SLIDING else 0)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, V)."""
        return self.forward_aux(tokens)[0]

    def _block(self, blk, x, positions, window):
        """One block: x -> (x, the experts' aux loss or None)."""
        cfg = self.cfg
        h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        x = x + L.attention_forward(blk["attn"], h, cfg,
                                    positions=positions, causal=True,
                                    window=window,
                                    backend=self.kernel_backend)
        h = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
        if "moe" in blk:
            y, aux = MOE.moe_forward(
                blk["moe"], h, top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
                num_experts=cfg.moe.num_experts, d_ff=cfg.d_ff)
            return x + y, aux
        return x + L.mlp_forward(blk["mlp"], h, cfg.d_ff), None

    def _group(self, grp, x, positions, window):
        """One recurrent group (family ssm or hybrid): x -> (x, None)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            x = SSM.mlstm_forward(grp["mlstm"], x, cfg.num_heads)
            return SSM.slstm_forward(grp["slstm"], x, cfg.num_heads), None
        for rec in grp["rec"]:
            x = RG.rglru_forward(rec["rglru"], x, cfg.norm_eps)
            h = L.rmsnorm(rec["ln2"], x, cfg.norm_eps)
            x = x + L.mlp_forward(rec["mlp"], h)
        pa = grp["attn"]
        h = L.rmsnorm(pa["ln1"], x, cfg.norm_eps)
        # the local window whatever cfg.attention says, as the reference
        x = x + L.attention_forward(pa["attn"], h, cfg, positions=positions,
                                    causal=True, window=cfg.local_window,
                                    backend=self.kernel_backend)
        h = L.rmsnorm(pa["ln2"], x, cfg.norm_eps)
        return x + L.mlp_forward(pa["mlp"], h), None

    def forward_aux(self, tokens: torch.Tensor, *, remat: bool = False,
                    window_override: Optional[int] = None):
        """The reference's ``forward``: tokens (B, S) int -> (logits
        (B, S, V), the experts' aux loss summed over the layers, 0-d f32).
        ``window_override``: sliding-window attention of that width;
        ``remat``: each block recomputed in the backward
        (``torch.utils.checkpoint``)."""
        cfg = self.cfg
        _refuse_model_axis(cfg)
        x = self.lookup(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        window = (window_override if window_override is not None
                  else self.window)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        run = self._group if cfg.family in RECURRENT else self._block
        for blk in self.blocks:
            if remat:
                x, a = checkpoint(run, blk, x, positions, window,
                                  use_reentrant=False)
            else:
                x, a = run(blk, x, positions, window)
            if a is not None:
                aux = aux + a
        return self.head(x), aux

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the LM head: x (B, S, d) -> (B, S, V)."""
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        if sharding.model_parallel_state() is not None:
            return self._head_sharded(x)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return torch.einsum("bsd,dv->bsv", x, head)

    def _head_sharded(self, x: torch.Tensor) -> torch.Tensor:
        """The LM head under a model axis: column-parallel on a vocab
        split (local logits, gathered whole), else whole on every rank."""
        cfg, d, v = self.cfg, self.cfg.d_model, self.cfg.vocab_size
        if cfg.tie_embeddings:
            name, w, shape, vdim = "embed", self.embed, (v, d), 0
        else:
            name, w, shape, vdim = "lm_head", self.lm_head, (d, v), 1
        if sharding.model_parallel_state().split_dim(name, shape) != vdim:
            w = sharding.whole(w, name, shape)
            return torch.einsum("bsd,dv->bsv", x, w.T if vdim == 0 else w)
        xf = sharding.copy_to_model(x)
        logits = torch.einsum("bsd,dv->bsv", xf, w.T if vdim == 0 else w)
        return sharding.gather_from_model(logits, -1)

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        """Pooled input embeddings (B, d): the reference's
        model-independent filter space for token data."""
        return torch.mean(self.lookup(tokens), dim=1)

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` (..., S) -> (..., S, d), as a
        product with the tokens' one-hot rows. The forward is exact (each
        output is one weight times 1 plus zeros, for finite weights), and
        the backward is a matrix product, which sums in a fixed order: the
        same gradient bits from run to run, on the CPU at any one thread
        count and on the card, under ``vmap`` and without it.
        ``embed[tokens]``'s backward accumulates rows in an order that
        changes from run to run on more than one thread.
        The one-hot operand is (..., S, V): cheap at the token scenario's
        vocab of 32 labels; above ``ONEHOT_VOCAB_MAX`` the rows are
        gathered and the backward sums each distinct token's rows by a
        product as small as the batch (``_EmbedRows``), again in a fixed
        order. (The comparison, unlike ``F.one_hot``, needs no range
        check on the host, so the one-hot route runs under ``vmap``.)"""
        mp = sharding.model_parallel_state()
        if mp is not None:
            return self._lookup_sharded(tokens, mp)
        if self.embed.shape[0] > ONEHOT_VOCAB_MAX:
            return _EmbedRows.apply(self.embed, tokens)
        vocab = torch.arange(self.embed.shape[0], device=tokens.device)
        onehot = (tokens[..., None] == vocab).to(self.embed.dtype)
        return onehot @ self.embed

    def _lookup_sharded(self, tokens: torch.Tensor, mp) -> torch.Tensor:
        """``lookup`` under a model axis: on a vocab split, this rank's
        rows' one-hot product summed over the axis (every other rank's
        rows contribute exact zeros); else from the gathered table."""
        shape = (self.cfg.vocab_size, self.cfg.d_model)
        if mp.split_dim("embed", shape) != 0:
            emb = sharding.whole(self.embed, "embed", shape)
            vocab = torch.arange(shape[0], device=tokens.device)
            return (tokens[..., None] == vocab).to(emb.dtype) @ emb
        n = shape[0] // mp.size
        vocab = torch.arange(mp.index * n, (mp.index + 1) * n,
                             device=tokens.device)
        onehot = (tokens[..., None] == vocab).to(self.embed.dtype)
        return sharding.reduce_from_model(onehot @ self.embed)

    # ------------------------------------------------------------ weights
    def load_jax_params(self, params: Dict[str, Any],
                        into=None) -> "Transformer":
        """Copy the reference's ``init_params`` pytree, as numpy arrays,
        into this module (no transposes), or, with ``into`` (tensors
        aligned with ``parameters()``, e.g. the SGD momentum), into those
        tensors: ``blocks`` leaves carry a leading layer (or group) axis,
        split across the per-layer (per-group) modules, and a nested
        stack (hybrid's ``rec``) a second axis, split across its list."""
        dst = targets(self, into)

        def load(node, ref, idx, path):
            if isinstance(node, torch.Tensor):
                _copy(dst(node), np.asarray(ref)[idx])
            elif isinstance(node, nn.ModuleList):
                for j, child in enumerate(node):
                    load(child, ref, idx + (j,), path)
            else:
                if set(node.keys()) != set(ref):
                    raise ValueError(
                        f"{path}: reference leaves {sorted(ref)}, model "
                        f"has {sorted(node.keys())}")
                for name, child in node.items():
                    load(child, ref[name], idx, f"{path}.{name}")
        with torch.no_grad():
            _copy(dst(self.embed), params["embed"])
            _copy(dst(self.final_norm["scale"]),
                  params["final_norm"]["scale"])
            if self.lm_head is not None:
                _copy(dst(self.lm_head), params["lm_head"])
            for i, blk in enumerate(self.blocks):
                load(blk, params["blocks"], (i,), "blocks")
        return self

    def jax_params(self, values=None) -> Dict[str, Any]:
        """The inverse of ``load_jax_params``: this module's weights, or
        ``values`` (tensors aligned with ``parameters()``), as the
        reference's pytree of numpy arrays (blocks stacked on a leading
        layer or group axis, a nested list on a second)."""
        host = host_values(self, values)

        def tree(node):
            if isinstance(node, torch.Tensor):
                return host[id(node)]
            if isinstance(node, nn.ModuleList):
                return _stack([tree(child) for child in node])
            return {name: tree(child) for name, child in node.items()}
        out: Dict[str, Any] = {"embed": host[id(self.embed)],
                               "final_norm": {"scale": host[id(
                                   self.final_norm["scale"])]}}
        if self.lm_head is not None:
            out["lm_head"] = host[id(self.lm_head)]
        out["blocks"] = tree(self.blocks)
        return out


def _stack(trees):
    """Stack same-structured trees of arrays leaf by leaf (axis 0)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} given, parameter has "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean CE in f32; labels < 0 are masked out; ``z_loss`` adds
    ``z·logsumexp²`` per token."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(
        lf, torch.clamp_min(labels, 0).to(torch.int64)[..., None],
        dim=-1)[..., 0]
    ce = lse - ll
    if z_loss:
        ce = ce + z_loss * torch.square(lse)
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def train_loss(model: Transformer, batch: Dict[str, torch.Tensor], *,
               remat: bool = False, aux_weight: float = 0.01):
    """batch {tokens, labels} -> (ce + aux_weight·aux, {ce, aux})."""
    logits, aux = model.forward_aux(batch["tokens"], remat=remat)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, window_override: Optional[int] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """The decode cache for ``batch`` rows and ``cache_len`` positions,
    the reference's leaves (names, shapes, dtypes):

    dense/moe: ``{k, v}`` (L, B, C, n_kv, h), C = ``cache_len``, or the
    window when ``window_override`` is set (a ring buffer).
    ssm: per group (G = L // 2) the mLSTM's ``mlstm_c`` (G, B, N, h, h)
    and ``mlstm_n`` (G, B, N, h) in f32 (h = 2d / N), the sLSTM's
    ``slstm_h`` (G, B, d) in ``dtype``, ``slstm_c``/``slstm_n`` in f32 and
    ``slstm_m`` in f32 filled with -1e9.
    hybrid: per group (G = L // period) and RG-LRU block (period - 1)
    ``rg_h`` (G, period - 1, B, d) in f32 and ``rg_conv`` (G, period - 1,
    B, CONV_W - 1, d), and the local attention's ring ``k``/``v`` (G, B,
    W, n_kv, h), W = min(local_window, cache_len), in ``dtype``."""
    refuse_family(cfg)
    f32 = torch.float32

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    h, nkv, d = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.d_model
    if cfg.family == "ssm":
        g, n = cfg.num_layers // 2, cfg.num_heads
        hh = 2 * d // n
        return {"mlstm_c": zeros((g, batch, n, hh, hh), f32),
                "mlstm_n": zeros((g, batch, n, hh), f32),
                "slstm_h": zeros((g, batch, d)),
                "slstm_c": zeros((g, batch, d), f32),
                "slstm_n": zeros((g, batch, d), f32),
                "slstm_m": torch.full((g, batch, d), -1e9, dtype=f32,
                                      device=device)}
    if cfg.family == "hybrid":
        per = cfg.hybrid_period
        g = cfg.num_layers // per
        w = min(cfg.local_window, cache_len)
        return {"rg_h": zeros((g, per - 1, batch, d), f32),
                "rg_conv": zeros((g, per - 1, batch, RG.CONV_W - 1, d)),
                "k": zeros((g, batch, w, nkv, h)),
                "v": zeros((g, batch, w, nkv, h))}
    c = min(cache_len, window_override) if window_override else cache_len
    return {"k": zeros((cfg.num_layers, batch, c, nkv, h)),
            "v": zeros((cfg.num_layers, batch, c, nkv, h))}


def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int, *,
                window_override: Optional[int] = None):
    """One decode step: tokens (B, 1) int at position ``pos`` -> (logits
    (B, 1, V), the new cache). The experts run at the default capacity
    factor, as the reference's decode does. Hybrid's attention runs its
    ring at the cache's own length, as the reference's does: past
    ``cache_len`` the window is ``cache_len``, not ``local_window``."""
    cfg = model.cfg
    _refuse_model_axis(cfg)
    x = model.lookup(tokens)
    if cfg.family == "ssm":
        x, new = _decode_ssm(model, x, cache)
    elif cfg.family == "hybrid":
        x, new = _decode_hybrid(model, x, cache, pos)
    else:
        window = window_override or 0
        ring = window if (window and cache["k"].shape[2] == window) else 0
        x, new = _decode_attention(model, x, cache, pos, ring)
    return model.head(x), new


def _decode_attention(model, x, cache, pos, ring):
    cfg = model.cfg
    new_k, new_v = [], []
    for i, blk in enumerate(model.blocks):
        h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        att, nk, nv = L.attention_decode(blk["attn"], h, cfg, cache["k"][i],
                                         cache["v"][i], pos, window=ring)
        x = x + att
        h = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
        if "moe" in blk:
            y, _ = MOE.moe_forward(blk["moe"], h, top_k=cfg.moe.top_k)
            x = x + y
        else:
            x = x + L.mlp_forward(blk["mlp"], h, cfg.d_ff)
        new_k.append(nk)
        new_v.append(nv)
    return x, {"k": torch.stack(new_k), "v": torch.stack(new_v)}


def _decode_ssm(model, x, cache):
    n = model.cfg.num_heads
    names = ("mlstm_c", "mlstm_n", "slstm_h", "slstm_c", "slstm_n",
             "slstm_m")
    new = {k: [] for k in names}
    for i, grp in enumerate(model.blocks):
        x, mst = SSM.mlstm_decode(grp["mlstm"], x, SSM.MLSTMState(
            cache["mlstm_c"][i], cache["mlstm_n"][i]), n)
        x, sst = SSM.slstm_decode(grp["slstm"], x, SSM.SLSTMState(
            *(cache[k][i] for k in names[2:])), n)
        for k, v in zip(names, (*mst, *sst)):
            new[k].append(v)
    return x, {k: torch.stack(v) for k, v in new.items()}


def _decode_hybrid(model, x, cache, pos):
    cfg = model.cfg
    w = cache["k"].shape[2]
    new = {k: [] for k in ("rg_h", "rg_conv", "k", "v")}
    for i, grp in enumerate(model.blocks):
        hs, convs = [], []
        for j, rec in enumerate(grp["rec"]):
            x, st = RG.rglru_decode(rec["rglru"], x, RG.RGLRUState(
                cache["rg_h"][i, j], cache["rg_conv"][i, j]), cfg.norm_eps)
            h = L.rmsnorm(rec["ln2"], x, cfg.norm_eps)
            x = x + L.mlp_forward(rec["mlp"], h)
            hs.append(st.h)
            convs.append(st.conv)
        pa = grp["attn"]
        h = L.rmsnorm(pa["ln1"], x, cfg.norm_eps)
        att, nk, nv = L.attention_decode(pa["attn"], h, cfg, cache["k"][i],
                                         cache["v"][i], pos, window=w)
        x = x + att
        h = L.rmsnorm(pa["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_forward(pa["mlp"], h)
        for k, v in zip(new, (torch.stack(hs), torch.stack(convs), nk, nv)):
            new[k].append(v)
    return x, {k: torch.stack(v) for k, v in new.items()}
