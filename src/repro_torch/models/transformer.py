"""The dense transformer backbone (``repro.models.transformer``, family
``dense``) as an ``nn.Module``.

Pre-norm GQA attention + SwiGLU blocks, RoPE on positions ``arange(S)``,
causal, a final RMSNorm and an LM head (``lm_head (d, V)`` applied as
``x @ head``, or the transposed embedding when ``tie_embeddings``). The
reference scans stacked per-layer parameters with ``lax.scan``; here a
Python loop runs one module per layer, and ``load_jax_params`` splits the
reference's stacked ``blocks`` (leading layer axis) into them.

Parameters are f32, as the reference's ``init_params`` makes them by
default (the simulator never passes ``ArchConfig.dtype``). The other
families (moe, vlm, audio, ssm, hybrid), decode and the training-loss
helpers are not ported yet (ROADMAP queue A item 11).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.common.types import ArchConfig, AttentionKind
from repro_torch.models import layers as L


class Transformer(nn.Module):
    """``init_params`` + ``forward`` + ``features`` of the reference for
    the dense family. ``kernel_backend`` routes attention
    (``kernels.dispatch``; None = the ambient policy)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 kernel_backend: Optional[str] = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
                "ROADMAP queue A item 11")
        self.cfg = cfg
        self.kernel_backend = kernel_backend
        d = cfg.d_model
        self.embed = nn.Parameter(torch.randn((cfg.vocab_size, d),
                                              generator=generator,
                                              device=device) * 0.02)
        self.final_norm = L.init_rmsnorm(d, device=device)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.randn((d, cfg.vocab_size), generator=generator,
                        device=device) * (1.0 / math.sqrt(d))))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({
                "ln1": L.init_rmsnorm(d, device=device),
                "attn": L.init_attention(cfg, generator=generator,
                                         device=device),
                "ln2": L.init_rmsnorm(d, device=device),
                "mlp": L.init_mlp(d, cfg.d_ff, generator=generator,
                                  device=device),
            }) for _ in range(cfg.num_layers))

    @property
    def window(self) -> int:
        return (self.cfg.local_window
                if self.cfg.attention == AttentionKind.SLIDING else 0)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, V)."""
        cfg = self.cfg
        x = self.embed[tokens]
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.blocks:
            h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
            x = x + L.attention_forward(blk["attn"], h, cfg,
                                        positions=positions, causal=True,
                                        window=self.window,
                                        backend=self.kernel_backend)
            h = L.rmsnorm(blk["ln2"], x, cfg.norm_eps)
            x = x + L.mlp_forward(blk["mlp"], h)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return torch.einsum("bsd,dv->bsv", x, head)

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        """Pooled input embeddings (B, d): the reference's
        model-independent filter space for token data."""
        return torch.mean(self.embed[tokens], dim=1)

    # ------------------------------------------------------------ weights
    def load_jax_params(self, params: Dict[str, Any]) -> "Transformer":
        """Copy the reference's ``init_params`` pytree, as numpy arrays,
        into this module (no transposes): ``blocks`` leaves carry a leading
        layer axis, which is split across the per-layer modules."""
        blocks = params["blocks"]
        with torch.no_grad():
            _copy(self.embed, params["embed"])
            _copy(self.final_norm["scale"], params["final_norm"]["scale"])
            if self.lm_head is not None:
                _copy(self.lm_head, params["lm_head"])
            for i, blk in enumerate(self.blocks):
                for part, leaves in blk.items():
                    if set(leaves.keys()) != set(blocks[part]):
                        raise ValueError(
                            f"blocks.{part}: reference leaves "
                            f"{sorted(blocks[part])}, model has "
                            f"{sorted(leaves.keys())}")
                    for name, p in leaves.items():
                        _copy(p, np.asarray(blocks[part][name])[i])
        return self

    def export_params(self) -> Dict[str, Any]:
        """The inverse of ``load_jax_params``: this module's weights as
        the reference's pytree of numpy arrays (blocks stacked on a leading
        layer axis)."""
        def host(t):
            return t.detach().cpu().numpy()
        out: Dict[str, Any] = {"embed": host(self.embed),
                               "final_norm": {"scale": host(
                                   self.final_norm["scale"])}}
        if self.lm_head is not None:
            out["lm_head"] = host(self.lm_head)
        out["blocks"] = {
            part: {name: np.stack([host(blk[part][name])
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
