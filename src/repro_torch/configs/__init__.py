"""Architecture registry: ``--arch <id>`` resolution + reduced smoke variants.

The ten records are data copied from the reference ``repro.configs``
(same names, aliases and published widths). Only the ``dense`` family has
a model in the port (``repro_torch.models.transformer``); the others are
here so that ``get_arch`` and ``reduced`` resolve every name the
reference resolves.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.types import ArchConfig, MoEConfig
from repro_torch.configs import (
    granite_8b,
    granite_moe_1b,
    hubert_xlarge,
    internlm2_20b,
    llama32_vision_90b,
    llama3_405b,
    phi3_5_moe,
    qwen2_5_3b,
    recurrentgemma_2b,
    xlstm_350m,
)
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES,
                                  TRAIN_4K)

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        qwen2_5_3b.CONFIG,
        phi3_5_moe.CONFIG,
        internlm2_20b.CONFIG,
        llama32_vision_90b.CONFIG,
        llama3_405b.CONFIG,
        hubert_xlarge.CONFIG,
        xlstm_350m.CONFIG,
        recurrentgemma_2b.CONFIG,
        granite_moe_1b.CONFIG,
        granite_8b.CONFIG,
    )
}

# short aliases for --arch
ALIASES = {
    "qwen2.5-3b": "qwen2.5-3b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "internlm2-20b": "internlm2-20b",
    "llama-3.2-vision-90b": "llama-3.2-vision-90b",
    "llama32-vision": "llama-3.2-vision-90b",
    "llama3-405b": "llama3-405b",
    "hubert-xlarge": "hubert-xlarge",
    "xlstm-350m": "xlstm-350m",
    "recurrentgemma-2b": "recurrentgemma-2b",
    "granite-moe-1b-a400m": "granite-moe-1b-a400m",
    "granite-moe": "granite-moe-1b-a400m",
    "granite-8b": "granite-8b",
}


def get_arch(name: str) -> ArchConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests.

    Keeps the family-defining structure (GQA ratio, MoE top-k, hybrid
    pattern, cross-attn cadence) while shrinking every dimension.
    """
    n_heads = max(2, min(4, cfg.num_heads))
    n_kv = max(1, min(n_heads, max(1, n_heads * cfg.num_kv_heads // cfg.num_heads)))
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=min(4, cfg.moe.num_experts),
                        top_k=min(2, cfg.moe.top_k),
                        capacity_factor=cfg.moe.capacity_factor)
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        d_ff=0 if cfg.d_ff == 0 else d_model * 3,
        vocab_size=vocab,
        head_dim=d_model // n_heads,
        moe=moe,
        local_window=min(cfg.local_window, 64),
        num_vision_tokens=min(cfg.num_vision_tokens, 16) if cfg.num_vision_tokens else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        hybrid_period=cfg.hybrid_period,
        frontend_stub_dim=d_model if cfg.frontend_stub_dim else 0,
        name=cfg.name + "-reduced",
    )
    if cfg.hybrid_period:
        changes["num_layers"] = max(layers, cfg.hybrid_period)
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ARCHS", "get_arch", "reduced", "SHAPES",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
