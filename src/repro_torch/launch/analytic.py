"""Analytic (napkin-math) FLOPs and HBM-traffic model per (arch × shape).

The reference's ``repro.launch.analytic``, its arithmetic in the same
order, so every float comes out bitwise equal. The dry run
(``launch.dryrun``) reports it beside what it counts on the meta device
(``FlopCounterMode``'s matmul FLOPs of the port's own step): the model
counts the work a step needs, the count what the port's code does. It is
pure arithmetic over ``ArchConfig`` and ``InputShape`` and holds no
device constant.

All numbers are GLOBAL per step; the roofline divides by the rank count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.common.types import ArchConfig, AttentionKind, InputShape

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CostModel:
    flops: float            # global FLOPs per step
    hbm_bytes: float        # global HBM bytes touched per step
    detail: dict


def _attn_flops_fwd(cfg: ArchConfig, batch: int, s: int,
                    window: Optional[int]) -> float:
    """QKᵀ + PV einsum flops per full forward (all layers), causal-halved."""
    h = cfg.resolved_head_dim
    if cfg.attention == AttentionKind.RECURRENT:
        # mLSTM chunkwise: intra-chunk (S·Lc) scores + state updates ≈ linear
        lc = 256
        d_in = 2 * cfg.d_model
        per_layer = 2 * 2 * batch * s * lc * d_in          # scores + out
        per_layer += 2 * 2 * batch * s * (d_in // cfg.num_heads) * d_in  # state
        return cfg.num_layers / 2 * per_layer              # mLSTM half of blocks
    kv_len = min(window, s) if window else s
    eff = kv_len if window else s / 2                      # causal half
    n_attn_layers = cfg.num_layers
    if cfg.attention == AttentionKind.LOCAL_HYBRID:
        n_attn_layers = cfg.num_layers // cfg.hybrid_period
        eff = min(cfg.local_window, s)
    if cfg.attention == AttentionKind.ENCODER:
        eff = s                                            # bidirectional
    flops = 2 * 2 * batch * s * eff * cfg.num_heads * h * n_attn_layers
    if cfg.cross_attn_every:
        n_cross = cfg.num_layers // cfg.cross_attn_every
        flops += 2 * 2 * batch * s * cfg.num_vision_tokens * cfg.num_heads * h * n_cross
    return flops


def step_cost(cfg: ArchConfig, shape: InputShape, *,
              window: Optional[int] = None,
              opt_bytes_per_param: float = 8.0) -> CostModel:
    """FLOPs + HBM model. Train = 3× forward matmul flops (fwd+bwd) +
    optimizer traffic; decode = 1 token vs full weight read + cache IO."""
    b, s = shape.global_batch, shape.seq_len
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    d = cfg.d_model
    h = cfg.resolved_head_dim

    if shape.mode == "train":
        tokens = b * s
        mm = 6.0 * n_active * tokens                # fwd 2NT + bwd 4NT
        attn = 3.0 * _attn_flops_fwd(cfg, b, s, window)
        flops = mm + attn
        # HBM: params read ×2 (fwd+bwd) + grads written + adam m,v r/w
        p_traffic = n_total * BF16 * 3 + n_total * opt_bytes_per_param * 2
        # activations: ~12 live (B,S,d) tensors per layer in bf16 with remat
        act = 12 * tokens * d * BF16 * cfg.num_layers
        logits = tokens * cfg.vocab_size * BF16 * 2
        hbm = p_traffic + act + logits
        detail = {"matmul_flops": mm, "attn_flops": attn,
                  "param_bytes": p_traffic, "act_bytes": act,
                  "logit_bytes": logits}
    elif shape.mode == "prefill":
        tokens = b * s
        mm = 2.0 * n_active * tokens
        attn = _attn_flops_fwd(cfg, b, s, window)
        flops = mm + attn
        act = 4 * tokens * d * BF16 * cfg.num_layers
        hbm = n_total * BF16 + act + tokens * cfg.vocab_size * BF16
        detail = {"matmul_flops": mm, "attn_flops": attn}
    else:  # decode: one token per sequence
        mm = 2.0 * n_active * b
        cache_len = min(window, s) if window else s
        if cfg.attention == AttentionKind.RECURRENT:
            d_in = 2 * d
            hh = d_in // cfg.num_heads
            attn = cfg.num_layers / 2 * b * (2 * cfg.num_heads * hh * hh * 2)
            cache_bytes = (cfg.num_layers / 2) * b * cfg.num_heads * hh * (hh + 1) * F32 * 2
        elif cfg.attention == AttentionKind.LOCAL_HYBRID:
            n_attn = cfg.num_layers // cfg.hybrid_period
            w = min(cfg.local_window, s)
            attn = 2 * 2 * b * w * cfg.num_heads * h * n_attn
            cache_bytes = n_attn * b * w * cfg.num_kv_heads * h * BF16 * 2 * 2
            cache_bytes += (cfg.num_layers - n_attn) * b * d * F32 * 2
        else:
            n_attn = cfg.num_layers
            attn = 2 * 2 * b * cache_len * cfg.num_heads * h * n_attn
            cache_bytes = n_attn * b * cache_len * cfg.num_kv_heads * h * BF16 * 2 * 2
            if cfg.cross_attn_every:
                n_cross = cfg.num_layers // cfg.cross_attn_every
                attn += 2 * 2 * b * cfg.num_vision_tokens * cfg.num_heads * h * n_cross
                cache_bytes += n_cross * b * cfg.num_vision_tokens \
                    * cfg.num_kv_heads * h * BF16 * 2
        flops = mm + attn
        hbm = n_total * BF16 + cache_bytes + b * cfg.vocab_size * BF16
        detail = {"matmul_flops": mm, "attn_flops": attn,
                  "cache_bytes": cache_bytes, "param_bytes": n_total * BF16}
    return CostModel(flops=flops, hbm_bytes=hbm, detail=detail)
