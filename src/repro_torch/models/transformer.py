"""The dense transformer backbone (``repro.models.transformer``, family
``dense``) as an ``nn.Module``.

Pre-norm GQA attention + SwiGLU blocks, RoPE on positions ``arange(S)``,
causal, a final RMSNorm and an LM head (``lm_head (d, V)`` applied as
``x @ head``, or the transposed embedding when ``tie_embeddings``). The
reference scans stacked per-layer parameters with ``lax.scan``; here a
Python loop runs one module per layer, and ``load_jax_params`` splits the
reference's stacked ``blocks`` (leading layer axis) into them.

Parameters are f32, as the reference's ``init_params`` makes them by
default (the simulator never passes ``ArchConfig.dtype``). Under a model
axis (``models.sharding.model_parallel``) the module computes on this
rank's slices of its leaves (``layers``): a vocab-split ``embed`` looks up
its local rows and sums over the axis, a vocab-split head gives local
logits that are gathered whole, and a leaf split any other way is
gathered before use; the residual stream stays whole on every rank. The other
families (moe, vlm, audio, ssm, hybrid), decode and the training-loss
helpers are not ported yet (ROADMAP queue A item 11).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.common.pytree import host_values, targets
from repro_torch.common.types import ArchConfig, AttentionKind
from repro_torch.models import layers as L
from repro_torch.models import sharding


class Transformer(nn.Module):
    """``init_params`` + ``forward`` + ``features`` of the reference for
    the dense family. ``kernel_backend`` routes attention
    (``kernels.dispatch``; None = the ambient policy)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 kernel_backend: Optional[str] = None, home=None):
        """Weights drawn on ``device`` from ``generator``, each leaf kept
        on ``home`` as soon as it is drawn (default: ``device``), so
        ``device`` holds one leaf's draw at a time, not the model."""
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
                "ROADMAP queue A item 11")
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
        self.blocks = nn.ModuleList(
            nn.ModuleDict({
                "ln1": L.init_rmsnorm(d, device=keep),
                "attn": L.init_attention(cfg, generator=generator,
                                         device=device, home=home),
                "ln2": L.init_rmsnorm(d, device=keep),
                "mlp": L.init_mlp(d, cfg.d_ff, generator=generator,
                                  device=device, home=home),
            }) for _ in range(cfg.num_layers))

    @property
    def window(self) -> int:
        return (self.cfg.local_window
                if self.cfg.attention == AttentionKind.SLIDING else 0)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, V)."""
        cfg = self.cfg
        x = self.lookup(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.blocks:
            h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
            x = x + L.attention_forward(blk["attn"], h, cfg,
                                        positions=positions, causal=True,
                                        window=self.window,
                                        backend=self.kernel_backend)
            h = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
            x = x + L.mlp_forward(blk["mlp"], h, cfg.d_ff)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        if sharding.model_parallel_state() is not None:
            return self._head_sharded(x)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
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
        vocab of 32 labels, not meant for a vocab of tens of thousands.
        (The comparison, unlike ``F.one_hot``, needs no range check on
        the host, so it runs under ``vmap``.)"""
        mp = sharding.model_parallel_state()
        if mp is not None:
            return self._lookup_sharded(tokens, mp)
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
        tensors: ``blocks`` leaves carry a leading layer axis, which is
        split across the per-layer modules."""
        blocks = params["blocks"]
        dst = targets(self, into)
        with torch.no_grad():
            _copy(dst(self.embed), params["embed"])
            _copy(dst(self.final_norm["scale"]),
                  params["final_norm"]["scale"])
            if self.lm_head is not None:
                _copy(dst(self.lm_head), params["lm_head"])
            for i, blk in enumerate(self.blocks):
                for part, leaves in blk.items():
                    if set(leaves.keys()) != set(blocks[part]):
                        raise ValueError(
                            f"blocks.{part}: reference leaves "
                            f"{sorted(blocks[part])}, model has "
                            f"{sorted(leaves.keys())}")
                    for name, p in leaves.items():
                        _copy(dst(p), np.asarray(blocks[part][name])[i])
        return self

    def jax_params(self, values=None) -> Dict[str, Any]:
        """The inverse of ``load_jax_params``: this module's weights, or
        ``values`` (tensors aligned with ``parameters()``), as the
        reference's pytree of numpy arrays (blocks stacked on a leading
        layer axis)."""
        host = host_values(self, values)
        out: Dict[str, Any] = {"embed": host[id(self.embed)],
                               "final_norm": {"scale": host[id(
                                   self.final_norm["scale"])]}}
        if self.lm_head is not None:
            out["lm_head"] = host[id(self.lm_head)]
        out["blocks"] = {
            part: {name: np.stack([host[id(blk[part][name])]
                                   for blk in self.blocks])
                   for name in leaves.keys()}
            for part, leaves in self.blocks[0].items()}
        return out


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} given, parameter has "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)
