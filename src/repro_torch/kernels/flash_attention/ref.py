"""Plain PyTorch version of the flash-attention kernel.

``attention`` is op for op the reference's oracle
(``repro.kernels.flash_attention.ref.attention``): layout (B, N, S, h),
k/v already GQA-expanded, f32 math, masked logits set to −1e30, a softmax
over the keys. ``attention_gqa`` adds the reference wrapper's GQA
expansion by repeat (``repro.kernels.flash_attention.ops._ref_gqa``), whose
autograd sums the grouped kv gradients. The CPU path, the tests and
``chip_smoke.py`` call these; a CUDA tensor goes to the kernel
(``ops.py``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, N, Sq, h); k, v (B, N, Sk, h), kv already GQA-expanded.
    Returns (B, N, Sq, h) f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnqh,bnkh->bnqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    sq, sk = q.shape[2], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
        if window > 0:
            mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bnkh->bnqh", probs, v.to(torch.float32))


def expand_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Repeat each of k's and v's Nkv heads N/Nkv times along axis 1, so
    query head n reads kv head n // (N/Nkv)."""
    n, nkv = q.shape[1], k.shape[1]
    if nkv != n:
        rep = n // nkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return k, v


def attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q (B, N, Sq, h); k, v (B, Nkv, Sk, h) with Nkv dividing N. Returns
    (B, N, Sq, h) in q's dtype."""
    k, v = expand_gqa(q, k, v)
    return attention(q, k, v, causal=causal).to(q.dtype)
