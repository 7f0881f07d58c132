"""EdgeFD's transformer clients: a backbone as a simulator client model.

``TransformerClientModel`` is the reference's
``repro.core.fd_trainer.TransformerClientModel`` as an ``nn.Module``: the
classifier output is the LAST position's next-token logits (the FD
'sample logit' for LM clients), so ``num_classes == cfg.vocab_size`` and
the generic client CE/distill machinery trains the backbone unchanged.
The mesh-collective trainer of that module (``fd_loss``,
``make_fd_train_step``, ``fd_round_local``) is not ported yet (ROADMAP
queue A item 11).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.common.types import ArchConfig
from repro_torch.models.transformer import Transformer


def proxy_features(model: Transformer, proxy_tokens: torch.Tensor
                   ) -> torch.Tensor:
    """The reference's filter space for token data: pooled input
    embeddings (model-independent across heterogeneous clients)."""
    return model.features(proxy_tokens)


class TransformerClientModel(nn.Module):
    """A dense transformer whose output is the last position's logits.

    ``kernel_backend`` routes the backbone's attention
    (``kernels.dispatch``): the client's own setting, so ``"torch"`` means
    plain attention too (the reference's attention follows only the
    ambient policy)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 kernel_backend: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.backbone = Transformer(cfg, generator=generator, device=device,
                                    kernel_backend=kernel_backend)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.backbone(tokens)[:, -1]

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        return proxy_features(self.backbone, tokens)

    def load_jax_params(self, params: Dict[str, Any]
                        ) -> "TransformerClientModel":
        self.backbone.load_jax_params(params)
        return self

    def export_params(self) -> Dict[str, Any]:
        return self.backbone.export_params()
