"""Mixture-of-Experts layer: top-k router + fixed-capacity expert dispatch.

The reference's ``repro.models.moe`` in PyTorch, with its parameter names
and layouts (``router (d, E)``, ``wg``/``wu (E, d, f)``, ``wd (E, f, d)``)
and its arithmetic: softmax router, top-k (ties to the lower expert
index, as ``lax.top_k``: a stable descending sort), gates renormalised
over the k chosen, the Switch load-balance loss ``E·Σ_e f_e·p_e / k``,
and a fixed capacity ``C = min(ceil(cf·S·k/E), S)`` per expert per batch
row, slots filled in token order with each token's k slots adjacent
(``repeat_interleave``), overflowing slots dropped. Dispatch and combine
are dense one-hot einsums over the capacity buffer, as in the reference
(which has no kernel here either). Under ``layers.set_attention_options(
bf16_psum=True)`` dispatch and combine give bf16 (``psum_einsum``); the
experts' FFN then runs on the bf16 buffer cast to the weights' f32 (the
type ``jnp.einsum`` promotes the pair to; ``torch.einsum`` would refuse
the mix), and the combined slots are summed in bf16, as the reference's.

Under a model axis (``models.sharding.model_parallel``) whose split of
the experts' leaves is on the expert dim (``fed.mesh.model_split``) each
rank runs its own block of experts: the router (gathered whole) and the
dispatch run the same on every rank, a rank fills and runs only its
experts' capacity buffers and combines their outputs, and the ranks'
partial combines are summed over the axis.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch.models import sharding
from repro_torch.models.layers import _normal, psum_einsum


def init_moe(d_model: int, d_ff: int, num_experts: int, *,
             generator: Optional[torch.Generator] = None, device=None,
             home=None) -> nn.ParameterDict:
    """Normal weights: router and up projections at std 1/√d, the down
    projection at 1/√f; drawn on ``device`` from ``generator`` in the
    order router, wg, wu, wd, each kept on ``home``."""
    std = 1.0 / math.sqrt(d_model)
    e, d, f = num_experts, d_model, d_ff
    return nn.ParameterDict({
        "router": _normal((d, e), std, generator, device, home),
        "wg": _normal((e, d, f), std, generator, device, home),
        "wu": _normal((e, d, f), std, generator, device, home),
        "wd": _normal((e, f, d), 1.0 / math.sqrt(f), generator, device,
                      home),
    })


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot rows by comparison (no host-side range check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor, *,
                top_k: int, capacity_factor: float = 1.25,
                num_experts: Optional[int] = None,
                d_ff: Optional[int] = None):
    """x (B, S, d) -> (out (B, S, d), aux loss 0-d f32). Under a model
    axis (``num_experts``, ``d_ff``: the whole widths) each rank runs its
    block of experts where the axis splits them on the expert dim, else
    the experts run whole on every rank from gathered leaves."""
    b, s, d = x.shape
    mp = sharding.model_parallel_state()
    local = None
    if mp is not None:
        e, f = num_experts, d_ff
        shapes = {"router": (d, e), "wg": (e, d, f), "wu": (e, d, f),
                  "wd": (e, f, d)}
        if e % mp.size == 0 and all(mp.split_dim(k, shapes[k]) == 0
                                    for k in ("wg", "wu", "wd")):
            local = sharding.block(e)
            p = {k: w if k != "router" else sharding.whole(w, k, shapes[k])
                 for k, w in p.items()}
        else:
            p = {k: sharding.whole(w, k, shapes[k]) for k, w in p.items()}
    e = p["router"].shape[-1]
    cap = max(1, int(math.ceil(capacity_factor * s * top_k / e)))
    cap = min(cap, s)

    logits = torch.einsum("bsd,de->bse", x, p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[..., :top_k]                     # (b, s, k)
    expert_idx = order.indices[..., :top_k]
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # aux load-balance loss: E * sum_e f_e * p_e
    me = torch.mean(probs, dim=(0, 1))                        # (e,)
    one_hot_all = _one_hot(expert_idx, e, torch.float32)      # (b, s, k, e)
    ce = torch.mean(torch.sum(one_hot_all, dim=2), dim=(0, 1))
    aux = e * torch.sum(me * ce / top_k)

    # position of each (token, k) slot within its expert's capacity buffer
    flat_one_hot = one_hot_all.reshape(b, s * top_k, e)
    pos_in_expert = torch.cumsum(flat_one_hot, dim=1) - flat_one_hot
    pos = torch.sum(pos_in_expert * flat_one_hot, dim=-1)    # (b, s*k)
    keep = pos < cap
    pos = torch.clamp_max(pos, cap - 1).to(torch.int64)

    gates_flat = gate_vals.reshape(b, s * top_k) * keep.to(torch.float32)
    # dispatch (b, s*k, e, cap) in the activation dtype
    cap_one_hot = _one_hot(pos, cap, x.dtype)
    dispatch = (flat_one_hot.to(x.dtype)[..., None]
                * cap_one_hot[:, :, None, :]
                * keep[..., None, None].to(x.dtype))
    combine = dispatch * gates_flat[..., None, None].to(x.dtype)

    xf = torch.repeat_interleave(x, top_k, dim=1)      # (b, s*k, d)
    if local is not None:
        # this rank's experts: its capacity buffers and its share of the
        # combine (the gates' gradient gathered from every rank's share)
        dispatch = dispatch[:, :, local[0]:local[1]]
        combine = sharding.scatter_to_model(combine, 2)
        xf = sharding.copy_to_model(xf)
    expert_in = psum_einsum("btec,btd->becd", dispatch, xf)
    # bf16 under bf16_psum: promoted to the weights' type, as jnp.einsum
    expert_in = expert_in.to(torch.promote_types(expert_in.dtype,
                                                 p["wg"].dtype))
    g = torch.einsum("becd,edf->becf", expert_in, p["wg"])
    u = torch.einsum("becd,edf->becf", expert_in, p["wu"])
    h = torch.nn.functional.silu(g) * u
    expert_out = torch.einsum("becf,efd->becd", h, p["wd"])
    yf = psum_einsum("btec,becd->btd", combine, expert_out)
    if local is not None:
        yf = sharding.reduce_from_model(yf)
    # a token's k slots are adjacent: their sum merges the top-k
    return yf.reshape(b, s, top_k, d).sum(dim=2), aux
