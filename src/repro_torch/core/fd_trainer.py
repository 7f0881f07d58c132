"""EdgeFD as a first-class trainer for the large-architecture backbones.

The reference's ``repro.core.fd_trainer``. ``TransformerClientModel`` is
a backbone as a simulator client: the classifier output is the LAST
position's next-token logits (the FD 'sample logit' for LM clients), so
``num_classes == cfg.vocab_size`` and the generic client CE/distill
machinery trains the backbone unchanged.

The trainer of the protocol at production scale: homogeneous-family
clients are ranks of a ``torch.distributed`` group, each with a private
token shard and a KMeans-DRE's centroids on pooled embedding features.
A round, on every rank (``make_fd_train_step``): predict the proxy
tokens' last-position logits, filter them with the two-stage mask
(owner provenance ∪ the plain ``kmeans.min_dist_to_centroids`` test, as
the reference's), form the ensemble teacher with one all-reduce
(``aggregation.masked_mean_logits_psum``) and take one step of
``CE(private) + λ·T²·KL(student ∥ teacher)`` (``fd_loss``: the fused KL
loss on the card). ``fd_round_local`` is the single-process form that
iterates the clients and aggregates like the hub; the two agree.

The dense, moe, ssm and hybrid families only: the vlm's forward needs
vision embeddings the proxy has not got, and audio has no token
embedding to pool (the reference's functions fail there too, on the
missing vision and on ``KeyError: 'embed'``), so every entry point here
raises a ``ValueError`` for them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.common.types import ArchConfig
from repro_torch.core.aggregation import (masked_mean_logits,
                                          masked_mean_logits_psum)
from repro_torch.core.distill import kd_kl_loss
from repro_torch.core.filtering import two_stage_filter
from repro_torch.core.kmeans import min_dist_to_centroids
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Transformer
from repro_torch.optim.optimizers import apply_updates


def refuse_family(cfg: ArchConfig) -> None:
    """The FD trainer takes token backbones only (module docstring)."""
    if cfg.family in ("vlm", "audio"):
        raise ValueError(
            f"the FD trainer has no path for family {cfg.family!r} "
            f"({cfg.name}): "
            + ("its forward needs vision embeddings" if cfg.family == "vlm"
               else "it has no token embedding"))


def proxy_features(model: Transformer, proxy_tokens: torch.Tensor
                   ) -> torch.Tensor:
    """The reference's filter space for token data: pooled input
    embeddings (model-independent across heterogeneous clients)."""
    refuse_family(model.cfg)
    return model.features(proxy_tokens)


class _CentroidDRE:
    """The reference's duck-typed DRE over given centroids: the distance
    to the nearest one (the plain version, not kernel B2, as the
    reference's ``min_dist_to_centroids``) and the test ``d <= thr``."""

    def __init__(self, centroids: torch.Tensor, threshold):
        self.centroids, self.threshold = centroids, threshold

    def distances(self, x: torch.Tensor) -> torch.Tensor:
        return min_dist_to_centroids(x, self.centroids)

    def distances_and_id(self, x: torch.Tensor):
        d = self.distances(x)
        return d, d <= self.threshold


def _filter_mask(model, proxy_tokens, proxy_owner, centroids, thr, cid):
    # the first call of every round: proxy_features refuses vlm and audio
    with torch.no_grad():
        feats = proxy_features(model, proxy_tokens)
    return two_stage_filter(_CentroidDRE(centroids, thr), feats,
                            proxy_owner, cid).mask


def fd_loss(model: Transformer, private_batch: Dict[str, torch.Tensor],
            proxy_tokens: torch.Tensor, teacher: torch.Tensor,
            teacher_weight: torch.Tensor, *, temperature: float = 2.0,
            distill_weight: float = 1.0, remat: bool = False):
    """Combined objective: local CE (+ the experts' aux loss) plus the
    weighted distillation KL on each proxy sequence's last position
    (``teacher`` (t, V), or (t, S, V) whose last position is taken)."""
    refuse_family(model.cfg)
    ce, metrics = T.train_loss(model, private_batch, remat=remat)
    student_logits, _ = model.forward_aux(proxy_tokens, remat=remat)
    kl = kd_kl_loss(student_logits[:, -1],
                    teacher[:, -1] if teacher.ndim == 3 else teacher,
                    temperature, teacher_weight,
                    backend=model.kernel_backend)
    loss = ce + distill_weight * kl
    return loss, {**metrics, "kl": kl, "ce_local": ce}


def _step(model, optimizer, opt_state, private_batch, proxy_tokens,
          teacher, w, **kw):
    """One ``fd_loss`` gradient step on ``model``'s parameters in place."""
    params = list(model.parameters())
    loss, metrics = fd_loss(model, private_batch, proxy_tokens, teacher, w,
                            **kw)
    grads = torch.autograd.grad(loss, params)
    upd, opt_state = optimizer.update(grads, opt_state, params)
    apply_updates(params, upd)
    return opt_state, {**{k: v.detach() for k, v in metrics.items()},
                       "loss": loss.detach()}


def make_fd_train_step(optimizer, *, axis_name: str = "data",
                       temperature: float = 2.0, distill_weight: float = 1.0,
                       remat: bool = False, mesh=None):
    """The mesh-collective FD round, one client a rank: ``step(model,
    opt_state, private_batch, proxy_tokens, proxy_owner, centroids, thr,
    client_id) -> (opt_state, metrics)`` updates ``model`` in place; the
    teacher is one all-reduce over ``mesh``'s axis ``axis_name`` (without
    a mesh, over the whole process group)."""
    if mesh is not None and axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not an axis of {mesh!r}")

    def step(model, opt_state, private_batch, proxy_tokens, proxy_owner,
             centroids, thr, client_id):
        mask = _filter_mask(model, proxy_tokens, proxy_owner, centroids,
                            thr, client_id)
        with torch.no_grad():
            sample_logits = model.forward_aux(proxy_tokens,
                                              remat=remat)[0][:, -1]
        teacher, valid = masked_mean_logits_psum(sample_logits, mask,
                                                 axis_name, mesh=mesh)
        opt_state, metrics = _step(
            model, optimizer, opt_state, private_batch, proxy_tokens,
            teacher, valid.to(torch.float32), temperature=temperature,
            distill_weight=distill_weight, remat=remat)
        metrics["id_fraction"] = torch.mean(mask.to(torch.float32))
        return opt_state, metrics

    return step


def fd_round_local(optimizer, client_states, private_batches, proxy_tokens,
                   proxy_owner, centroids_list, thresholds, **kw):
    """Single-process form: every client's filtered proxy logits, the
    hub's masked mean, then each client's step. ``client_states``: a
    list of (model, opt_state), the models updated in place. Returns the
    new states, each client's metrics and the ID fraction."""
    logits_all, masks = [], []
    for cid, (model, _) in enumerate(client_states):
        masks.append(_filter_mask(model, proxy_tokens, proxy_owner,
                                  centroids_list[cid], thresholds[cid], cid))
        with torch.no_grad():
            logits_all.append(model.forward_aux(proxy_tokens)[0][:, -1])
    teacher, valid = masked_mean_logits(torch.stack(logits_all),
                                        torch.stack(masks))
    w = valid.to(torch.float32)
    new_states, all_metrics = [], []
    for cid, (model, opt_state) in enumerate(client_states):
        opt_state, metrics = _step(model, optimizer, opt_state,
                                   private_batches[cid], proxy_tokens,
                                   teacher, w, **kw)
        new_states.append((model, opt_state))
        all_metrics.append(metrics)
    return new_states, all_metrics, float(torch.stack(masks).to(
        torch.float32).mean())


class TransformerClientModel(nn.Module):
    """A backbone (``models.transformer``: dense, moe, ssm or hybrid; the
    vlm and audio families raise) whose output is the last position's
    logits.

    ``kernel_backend`` routes the backbone's attention
    (``kernels.dispatch``): the client's own setting, so ``"torch"`` means
    plain attention too (the reference's attention follows only the
    ambient policy). ``model_parallel``: under a model axis the backbone
    computes on its local slices itself (the cohort engine gathers no
    leaf for it)."""

    model_parallel = True

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 kernel_backend: Optional[str] = None, home=None):
        super().__init__()
        refuse_family(cfg)
        self.cfg = cfg
        self.backbone = Transformer(cfg, generator=generator, device=device,
                                    kernel_backend=kernel_backend, home=home)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.backbone(tokens)[:, -1]

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        return proxy_features(self.backbone, tokens)

    def load_jax_params(self, params: Dict[str, Any], into=None
                        ) -> "TransformerClientModel":
        self.backbone.load_jax_params(params, into)
        return self

    def jax_params(self, values=None) -> Dict[str, Any]:
        return self.backbone.jax_params(values)
