"""The backbone of ``repro.models.transformer`` as an ``nn.Module``, for
every family of the reference (dense, moe, vlm, audio, ssm, hybrid), with
its losses and decode.

dense / moe: pre-norm GQA attention + SwiGLU (or, family ``moe``, a
mixture of experts: ``models.moe``) blocks, RoPE on positions
``arange(S)``, causal (a sliding window when the config or
``window_override`` asks). audio (hubert): the same blocks over frame
embeddings, bidirectional (``causal=False``, RoPE kept, as the
reference's ``_dense_block``), the input a ``frame_proj (stub_dim, d)``
projection in place of ``embed`` (the stubbed frontend's last layer).
vlm (llama-3.2-vision): ``num_layers // cross_attn_every`` groups of
``cross_attn_every - 1`` causal self blocks and one cross block whose
keys and values are the vision embeddings (B, V, d) projected by its own
``wk``/``wv`` (no bias, no RoPE), its attention and MLP outputs scaled
by ``tanh`` of the scalar gates ``gate_attn`` and ``gate_mlp`` (zero at
init). ssm (xLSTM): groups of an mLSTM and an sLSTM block
(``models.ssm``), ``num_layers // 2`` of them. hybrid (Griffin): groups
of ``hybrid_period - 1`` RG-LRU blocks (``models.rglru``, each with a
SwiGLU MLP) and one local-attention block whose window is
``local_window`` whatever ``cfg.attention`` says, ``num_layers //
hybrid_period`` of them. Then a final RMSNorm and an LM head (``lm_head
(d, V)`` applied as ``x @ head``, or the transposed embedding when
``tie_embeddings``). The reference scans stacked per-layer (or
per-group) parameters with ``lax.scan``; here a Python loop runs one
module per layer or group (``remat``: each under
``torch.utils.checkpoint``), and ``load_jax_params`` splits the
reference's stacked ``blocks`` (a leading layer or group axis; hybrid's
``rec`` and vlm's ``self`` leaves a second axis) into them.
``cross_entropy`` and ``train_loss`` are the LM objective (CE plus the
experts' load-balance loss; audio's frame-level unit prediction),
``init_cache`` and ``decode_step`` one token at a time against a KV
cache (vlm: and the cross keys and values precomputed per group) or the
recurrent state. The audio family is encoder-only: no cache, no decode.

Parameters are f32, as the reference's ``init_params`` makes them by
default (the simulator never passes ``ArchConfig.dtype``). Under a model
axis (``models.sharding.model_parallel``) every family computes on this
rank's slices of its leaves, as ``fed.mesh.model_split`` places them
(``layers``, ``ssm``, ``rglru``): a vocab-split ``embed`` looks up its
local rows and sums over the axis, a vocab-split head gives local logits
that are gathered whole, audio's ``frame_proj`` (split on the frames'
features) sums its partial products, the vlm's cross block runs its
local query heads against the local kv heads of the vision keys (its
scalar gates replicated), and a leaf split any other way is gathered
before use; the residual stream stays whole on every rank. Decode under
the axis carries a rank's own share of the cache (``init_cache``):
attention caches of the kv heads its query heads read, the mLSTM state
of its heads, the RG-LRU state of its width block, the sLSTM state
whole. ``shard(mesh)`` cuts a whole module to this rank's slices; its
``jax_params`` then gathers them to the reference's tree and
``load_jax_params`` takes this rank's blocks of one.
"""
from __future__ import annotations

import contextlib
import math
import threading
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
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
RECURRENT = ("ssm", "hybrid")
NO_VISION = ("the vlm family's forward needs vision= (B, "
             "num_vision_tokens, d_model)")


def refuse_family(cfg: ArchConfig) -> None:
    """Raise for a family the reference does not know either."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


class _Gated(nn.Module):
    """Named children, sub-modules and parameters alike, read as a
    mapping (``keys``, ``items``, ``[name]``, ``in``): the vlm's cross
    block, whose scalar gates sit beside its norms, attention and MLP."""

    def __init__(self, children: Dict[str, Any]):
        super().__init__()
        self._names = list(children)
        for name, child in children.items():
            setattr(self, name, child)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def keys(self):
        return list(self._names)

    def items(self):
        return [(name, self[name]) for name in self._names]


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
        if flat.device.type == "meta":
            uniq, inv = _meta_unique(flat, ctx.shape[0])
        else:
            uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
        onehot = (inv[:, None] == torch.arange(
            len(uniq), device=flat.device)).to(g.dtype)
        rows = onehot.T @ g.reshape(-1, ctx.shape[1])
        out = g.new_zeros(ctx.shape)
        out.index_copy_(0, uniq, rows)
        return out, None


_meta = threading.local()


@contextlib.contextmanager
def meta_distinct_tokens(count: Optional[int]):
    """The number of distinct tokens ``_EmbedRows``' backward takes on the
    meta device (``launch.dryrun``), where ``torch.unique`` has no kernel
    and no data to count: ``count``, or None for the most a batch can hold,
    min(vocab, tokens)."""
    prev = getattr(_meta, "distinct", None)
    _meta.distinct = count
    try:
        yield
    finally:
        _meta.distinct = prev


def _meta_unique(flat: torch.Tensor, vocab: int):
    """``torch.unique(flat, sorted=True, return_inverse=True)``'s outputs
    on the meta device, at ``meta_distinct_tokens``' count: written by ops
    that move the bytes the real op does (``flat`` read, both written)."""
    u = getattr(_meta, "distinct", None)
    u = min(vocab, flat.numel()) if u is None else u
    return (torch.zeros(u, dtype=flat.dtype, device=flat.device),
            flat.clone())


class Transformer(nn.Module):
    """``init_params`` + ``forward`` + ``features`` of the reference for
    every family. ``kernel_backend`` routes attention
    (``kernels.dispatch``; None = the ambient policy)."""

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
        self.mesh = None                  # set by ``shard``
        self._splits: Dict[int, Optional[int]] = {}
        d = cfg.d_model
        keep = device if home is None else home
        if cfg.family == "audio":
            # the frontend stub's output projection stands in for embed
            self.embed = None
            self.frame_proj = L._normal(
                (cfg.frontend_stub_dim, d),
                1.0 / math.sqrt(cfg.frontend_stub_dim), generator, device,
                home)
        else:
            self.embed = L._normal((cfg.vocab_size, d), 0.02, generator,
                                   device, home)
            self.frame_proj = None
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

        def vlm_group():
            selfs = nn.ModuleList(block()
                                  for _ in range(cfg.cross_attn_every - 1))
            attn = L.init_attention(cfg, **draw)
            mlp = L.init_mlp(d, cfg.d_ff, **draw)

            def gate():                     # tanh-gated, zero at init
                return nn.Parameter(torch.zeros((), device=keep))
            return nn.ModuleDict({"self": selfs, "cross": _Gated({
                "ln1": L.init_rmsnorm(d, device=keep), "attn": attn,
                "gate_attn": gate(), "ln2": L.init_rmsnorm(d, device=keep),
                "mlp": mlp, "gate_mlp": gate()})})

        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(
                xlstm_group() for _ in range(cfg.num_layers // 2))
        elif cfg.family == "vlm":
            self.blocks = nn.ModuleList(
                vlm_group()
                for _ in range(cfg.num_layers // cfg.cross_attn_every))
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

    def forward(self, tokens: Optional[torch.Tensor] = None,
                **kw) -> torch.Tensor:
        """tokens (B, S) int (audio: ``frames=``; vlm: also ``vision=``)
        -> logits (B, S, V)."""
        return self.forward_aux(tokens, **kw)[0]

    def _block(self, blk, x, positions, window, causal=True):
        """One block: x -> (x, the experts' aux loss or None)."""
        cfg = self.cfg
        h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        x = x + L.attention_forward(blk["attn"], h, cfg,
                                    positions=positions, causal=causal,
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
            x = x + L.mlp_forward(rec["mlp"], h, cfg.d_ff)
        pa = grp["attn"]
        h = L.rmsnorm(pa["ln1"], x, cfg.norm_eps)
        # the local window whatever cfg.attention says, as the reference
        x = x + L.attention_forward(pa["attn"], h, cfg, positions=positions,
                                    causal=True, window=cfg.local_window,
                                    backend=self.kernel_backend)
        h = L.rmsnorm(pa["ln2"], x, cfg.norm_eps)
        return x + L.mlp_forward(pa["mlp"], h, cfg.d_ff), None

    def _vlm_group(self, grp, x, positions, window, vision):
        """One vlm group: its causal self blocks, then the gated cross
        block on ``vision``'s keys and values: x -> (x, None)."""
        cfg = self.cfg
        for blk in grp["self"]:
            x, _ = self._block(blk, x, positions, window)
        pc = grp["cross"]
        h = L.rmsnorm(pc["ln1"], x, cfg.norm_eps)
        att = L.attention_forward(pc["attn"], h, cfg, causal=False,
                                  backend=self.kernel_backend,
                                  kv_override=self.vision_kv(pc, vision))
        # a bf16 partial sum (bf16_psum) meets the f32 gate in f32, as
        # jnp promotes the pair
        x = x + torch.tanh(pc["gate_attn"]) * att.to(x.dtype)
        h = L.rmsnorm(pc["ln2"], x, cfg.norm_eps)
        y = L.mlp_forward(pc["mlp"], h, cfg.d_ff)
        return x + torch.tanh(pc["gate_mlp"]) * y.to(x.dtype), None

    def vision_kv(self, pc, vision: torch.Tensor):
        """A cross block's keys and values from the vision embeddings
        (B, V, d): (B, V, n_kv, h) each, unexpanded, no bias (under a
        model axis the kv heads this rank's query heads read)."""
        return L.project_kv(pc["attn"], vision, self.cfg)

    def forward_aux(self, tokens: Optional[torch.Tensor] = None, *,
                    frames: Optional[torch.Tensor] = None,
                    vision: Optional[torch.Tensor] = None,
                    remat: bool = False,
                    window_override: Optional[int] = None):
        """The reference's ``forward``: tokens (B, S) int, or for audio
        ``frames`` (B, S, stub_dim), and for vlm ``vision`` (B, V, d) ->
        (logits (B, S, V), the experts' aux loss summed over the layers,
        0-d f32). ``window_override``: sliding-window attention of that
        width; ``remat``: each block (group) recomputed in the backward
        (``torch.utils.checkpoint``)."""
        cfg = self.cfg
        if cfg.family == "audio":
            if frames is None:
                raise ValueError("the audio family's forward takes frames= "
                                 "(B, S, frontend_stub_dim)")
            x = self._frames_in(frames)
        else:
            x = self.lookup(tokens)
        if cfg.family == "vlm" and vision is None:
            raise ValueError(NO_VISION)
        positions = torch.arange(x.shape[1], device=x.device)
        window = (window_override if window_override is not None
                  else self.window)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in RECURRENT:
            run = self._group
        elif cfg.family == "vlm":
            def run(grp, x, positions, window):
                return self._vlm_group(grp, x, positions, window, vision)
        else:
            causal = cfg.family != "audio"       # the encoder sees both ways

            def run(blk, x, positions, window):
                return self._block(blk, x, positions, window, causal)
        for blk in self.blocks:
            if remat:
                x, a = checkpoint(run, blk, x, positions, window,
                                  use_reentrant=False)
            else:
                x, a = run(blk, x, positions, window)
            if a is not None:
                aux = aux + a
        return self.head(x), aux

    def _frames_in(self, frames: torch.Tensor) -> torch.Tensor:
        """Audio's input projection (B, S, stub_dim) -> (B, S, d); under a
        model axis split on the frames' features, each rank's partial
        product over its feature block summed over the axis."""
        cfg = self.cfg
        shape = (cfg.frontend_stub_dim, cfg.d_model)
        mp = sharding.model_parallel_state()
        if mp is None:
            return torch.einsum("bsf,fd->bsd", frames, self.frame_proj)
        if not sharding.splits(shape[0]):
            return torch.einsum("bsf,fd->bsd", frames, sharding.whole(
                self.frame_proj, "frame_proj", shape))
        lo, hi = sharding.block(shape[0])
        w = sharding.part(self.frame_proj, "frame_proj", shape, 0, lo, hi)
        return sharding.reduce_from_model(torch.einsum(
            "bsf,fd->bsd", sharding.scatter_to_model(frames, -1), w))

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

    def features(self, tokens: Optional[torch.Tensor] = None, *,
                 frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pooled input embeddings (B, d): the reference's
        model-independent filter space for token data; without tokens the
        frames themselves, pooled (B, stub_dim), as the reference's."""
        x = self.lookup(tokens) if tokens is not None else frames
        return torch.mean(x, dim=1)

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
        if self.embed is None:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) has no "
                             "token embedding: it takes frames")
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
    def shard(self, mesh) -> "Transformer":
        """Cut every leaf, in place, to this rank's block over ``mesh``'s
        model axis (``fed.mesh.model_split`` by the leaf's name), for
        compute under ``models.sharding.model_parallel(mesh)``."""
        from repro_torch.fed.mesh import model_block, model_split
        with torch.no_grad():
            for name, p in self.named_parameters():
                s = model_split(name.rsplit(".", 1)[-1], tuple(p.shape),
                                mesh)
                self._splits[id(p)] = s
                if s is not None:
                    p.data = model_block(p.data, s, mesh).clone()
        self.mesh = mesh
        return self

    def whole_values(self, values=None):
        """``values`` (tensors aligned with ``parameters()``; default the
        parameters), each gathered whole over the model axis when this
        module is ``shard``-ed (every rank must call)."""
        params = list(self.parameters())
        vals = params if values is None else list(values)
        if self.mesh is None:
            return vals
        from repro_torch.fed.mesh import model_axis_name
        ax = model_axis_name(self.mesh)
        return [v if self._splits[id(p)] is None else
                self.mesh.gather(v.detach(), ax, self._splits[id(p)])
                for p, v in zip(params, vals)]

    def _local(self, param: torch.Tensor, arr):
        """This rank's block of the whole array ``arr`` of ``param``."""
        s = self._splits.get(id(param)) if self.mesh is not None else None
        if s is None:
            return arr
        from repro_torch.fed.mesh import model_block
        return model_block(np.asarray(arr), s, self.mesh)

    def load_jax_params(self, params: Dict[str, Any],
                        into=None) -> "Transformer":
        """Copy the reference's ``init_params`` pytree, as numpy arrays,
        into this module (no transposes), or, with ``into`` (tensors
        aligned with ``parameters()``, e.g. the SGD momentum), into those
        tensors: ``blocks`` leaves carry a leading layer (or group) axis,
        split across the per-layer (per-group) modules, and a nested
        stack (hybrid's ``rec``, vlm's ``self``) a second axis, split
        across its list; the vlm's gates are (G,). Audio's ``frame_proj``
        stands where ``embed`` is. A ``shard``-ed module takes this rank's
        blocks of the whole tree."""
        dst = targets(self, into)

        def put(param, arr):
            _copy(dst(param), self._local(param, arr))

        def load(node, ref, idx, path):
            if isinstance(node, torch.Tensor):
                put(node, np.asarray(ref)[idx])
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
            for name in ("embed", "frame_proj"):
                if getattr(self, name) is not None:
                    put(getattr(self, name), params[name])
            put(self.final_norm["scale"], params["final_norm"]["scale"])
            if self.lm_head is not None:
                put(self.lm_head, params["lm_head"])
            for i, blk in enumerate(self.blocks):
                load(blk, params["blocks"], (i,), "blocks")
        return self

    def jax_params(self, values=None) -> Dict[str, Any]:
        """The inverse of ``load_jax_params``: this module's weights, or
        ``values`` (tensors aligned with ``parameters()``), as the
        reference's pytree of numpy arrays (blocks stacked on a leading
        layer or group axis, a nested list on a second); a ``shard``-ed
        module's slices gathered whole (every rank must call)."""
        host = host_values(self, self.whole_values(values))

        def tree(node):
            if isinstance(node, torch.Tensor):
                return host[id(node)]
            if isinstance(node, nn.ModuleList):
                return _stack([tree(child) for child in node])
            return {name: tree(child) for name, child in node.items()}
        out: Dict[str, Any] = {
            name: host[id(getattr(self, name))]
            for name in ("embed", "frame_proj")
            if getattr(self, name) is not None}
        out["final_norm"] = {"scale": host[id(self.final_norm["scale"])]}
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
    """batch {tokens, labels} (vlm: and vision; audio: {frames, labels},
    frame-level unit prediction) -> (ce + aux_weight·aux, {ce, aux})."""
    fam = model.cfg.family
    if fam == "audio":
        logits, aux = model.forward_aux(frames=batch["frames"], remat=remat)
    else:
        kw = {"vision": batch["vision"]} if fam == "vlm" else {}
        logits, aux = model.forward_aux(batch["tokens"], remat=remat, **kw)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, window_override: Optional[int] = None,
               device=None, vision: Optional[torch.Tensor] = None,
               params: Optional[Transformer] = None
               ) -> Dict[str, Any]:
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
    W, n_kv, h), W = min(local_window, cache_len), in ``dtype``.
    vlm: per group (G = L // cross_attn_every) and self block ``k``/``v``
    (G, per - 1, B, C, n_kv, h) as dense's, and ``cross`` {``ck``,
    ``cv``} (G, B, V, n_kv, h): the keys and values of ``vision`` (B, V,
    d) under each group's cross block of ``params`` (the model), in
    ``dtype``, or zeros of V = num_vision_tokens when either is missing.
    audio: encoder-only, no cache (ValueError), as the reference.
    ``device``: where the leaves go (default: ``vision``'s device, else
    the default device). Under a model axis the leaves are this rank's:
    n_kv the kv heads its query heads read (``layers.local_kv_heads``), the
    mLSTM's N its heads (``ssm.mlstm_local_heads``), the RG-LRU's d its
    width block (``rglru.local_width``); the sLSTM's state is whole."""
    refuse_family(cfg)
    f32 = torch.float32
    if device is None and vision is not None:
        device = vision.device

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    h, d = cfg.resolved_head_dim, cfg.d_model
    nkv = L.local_kv_heads(cfg)
    if cfg.family == "ssm":
        g = cfg.num_layers // 2
        hh = 2 * d // cfg.num_heads
        n = SSM.mlstm_local_heads(d, cfg.num_heads)
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
        dl = RG.local_width(d)
        return {"rg_h": zeros((g, per - 1, batch, dl), f32),
                "rg_conv": zeros((g, per - 1, batch, RG.CONV_W - 1, dl)),
                "k": zeros((g, batch, w, nkv, h)),
                "v": zeros((g, batch, w, nkv, h))}
    if cfg.family == "audio":
        raise ValueError(f"no decode cache for family {cfg.family!r} "
                         f"({cfg.name}): encoder-only")
    c = min(cache_len, window_override) if window_override else cache_len
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        g = cfg.num_layers // per
        cache: Dict[str, Any] = {
            "k": zeros((g, per - 1, batch, c, nkv, h)),
            "v": zeros((g, per - 1, batch, c, nkv, h))}
        if vision is not None and params is not None:
            kv = [params.vision_kv(grp["cross"], vision)
                  for grp in params.blocks]
            cache["cross"] = {
                "ck": torch.stack([k for k, _ in kv]).to(dtype),
                "cv": torch.stack([v for _, v in kv]).to(dtype)}
        else:
            nv = cfg.num_vision_tokens
            cache["cross"] = {"ck": zeros((g, batch, nv, nkv, h)),
                              "cv": zeros((g, batch, nv, nkv, h))}
        return cache
    return {"k": zeros((cfg.num_layers, batch, c, nkv, h)),
            "v": zeros((cfg.num_layers, batch, c, nkv, h))}


def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: int, *,
                window_override: Optional[int] = None):
    """One decode step: tokens (B, 1) int at position ``pos`` -> (logits
    (B, 1, V), the new cache). The experts run at the default capacity
    factor, as the reference's decode does. Hybrid's attention runs its
    ring at the cache's own length, as the reference's does: past
    ``cache_len`` the window is ``cache_len``, not ``local_window``. The
    vlm's cross blocks attend to the cache's ``cross`` keys and values by
    the plain scores (``layers.attention_scores``, no kernel, as the
    reference's decode). Audio has no decode (ValueError)."""
    cfg = model.cfg
    if cfg.family == "audio":
        raise ValueError(f"decode unsupported for family {cfg.family!r} "
                         f"({cfg.name}): encoder-only")
    x = model.lookup(tokens)
    if cfg.family == "ssm":
        x, new = _decode_ssm(model, x, cache)
    elif cfg.family == "hybrid":
        x, new = _decode_hybrid(model, x, cache, pos)
    elif cfg.family == "vlm":
        window = window_override or 0
        ring = window if (window and cache["k"].shape[3] == window) else 0
        x, new = _decode_vlm(model, x, cache, pos, ring)
    else:
        window = window_override or 0
        ring = window if (window and cache["k"].shape[2] == window) else 0
        x, new = _decode_attention(model, x, cache, pos, ring)
    return model.head(x), new


def _decode_block(cfg, blk, x, ck, cv, pos, ring):
    """One dense (or experts') block's decode step: x -> (x, new k, new
    v)."""
    h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    att, nk, nv = L.attention_decode(blk["attn"], h, cfg, ck, cv, pos,
                                     window=ring)
    x = x + att
    h = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
    if "moe" in blk:
        y, _ = MOE.moe_forward(blk["moe"], h, top_k=cfg.moe.top_k,
                               num_experts=cfg.moe.num_experts,
                               d_ff=cfg.d_ff)
        return x + y, nk, nv
    return x + L.mlp_forward(blk["mlp"], h, cfg.d_ff), nk, nv


def _decode_attention(model, x, cache, pos, ring):
    new_k, new_v = [], []
    for i, blk in enumerate(model.blocks):
        x, nk, nv = _decode_block(model.cfg, blk, x, cache["k"][i],
                                  cache["v"][i], pos, ring)
        new_k.append(nk)
        new_v.append(nv)
    return x, {"k": torch.stack(new_k), "v": torch.stack(new_v)}


def _decode_vlm(model, x, cache, pos, ring):
    cfg = model.cfg
    new_k, new_v = [], []
    for i, grp in enumerate(model.blocks):
        ks, vs = [], []
        for j, blk in enumerate(grp["self"]):
            x, nk, nv = _decode_block(cfg, blk, x, cache["k"][i, j],
                                      cache["v"][i, j], pos, ring)
            ks.append(nk)
            vs.append(nv)
        new_k.append(torch.stack(ks))
        new_v.append(torch.stack(vs))
        pc = grp["cross"]
        h = L.rmsnorm(pc["ln1"], x, cfg.norm_eps)
        att = L.attention_given_kv(pc["attn"], h, cfg,
                                   cache["cross"]["ck"][i],
                                   cache["cross"]["cv"][i])
        x = x + torch.tanh(pc["gate_attn"]) * att
        h = L.rmsnorm(pc["ln2"], x, cfg.norm_eps)
        y = L.mlp_forward(pc["mlp"], h, cfg.d_ff)
        x = x + torch.tanh(pc["gate_mlp"]) * y.to(x.dtype)
    return x, dict(cache, k=torch.stack(new_k), v=torch.stack(new_v))


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
            x = x + L.mlp_forward(rec["mlp"], h, cfg.d_ff)
            hs.append(st.h)
            convs.append(st.conv)
        pa = grp["attn"]
        h = L.rmsnorm(pa["ln1"], x, cfg.norm_eps)
        att, nk, nv = L.attention_decode(pa["attn"], h, cfg, cache["k"][i],
                                         cache["v"][i], pos, window=w)
        x = x + att
        h = L.rmsnorm(pa["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_forward(pa["mlp"], h, cfg.d_ff)
        for k, v in zip(new, (torch.stack(hs), torch.stack(convs), nk, nv)):
            new[k].append(v)
    return x, {k: torch.stack(v) for k, v in new.items()}
