"""Federated client: private data + private model + DRE + training steps.

``Learner`` holds what every trained model of the federation shares — the
model, its optimizer state, its own shuffling stream and the CE, KD and
eval steps — and is the base of ``Client`` and of the server's FedDF
student (``repro_torch.fed.server``). The CE and KD steps run the model in
train mode and ``predict`` (proxy logits, class-wise means, evaluation) in
eval mode, as the reference's ``train=True`` / ``False`` does: it sets the
CNN zoo's BatchNorm, and the MLP and the transformer ignore it. A client
keeps its private data (NHWC images in image mode) on
its device once, draws its batch order from its own
``np.random.default_rng(seed + 1000 * cid)`` stream (the reference's, so
the order carries over unchanged) and reads every step's loss back to the
host (``float(loss)``), as the reference does.

``Learner.state_dict`` is the reference's per-learner checkpoint entry:
the parameters and the SGD state (``{"mu": tree, "step": int32}``) as
flat ``flatten_tree`` dicts in the reference's layout (the model's
``jax_params``), and the numpy shuffling stream; ``load_state_dict``
overlays one, from either package, onto the learner's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.ckpt import flatten_tree, unflatten_like
from repro_torch.core import distill as D
from repro_torch.core.aggregation import classwise_mean_logits
from repro_torch.core.filtering import FilterStats, two_stage_filter
from repro_torch.data.synthetic import sample_tensor
from repro_torch.fed.batching import epoch_batches
from repro_torch.fed.state import load_rng_state, rng_state_dict
from repro_torch.optim.optimizers import Optimizer, apply_updates


class Learner:
    """A model with its optimizer state, shuffling stream and steps."""

    def __init__(self, model: nn.Module, opt: Optimizer,
                 rng: np.random.Generator, *, temperature: float = 3.0,
                 distill_loss: str = "kl",
                 kernel_backend: Optional[str] = None, device=None):
        self.model = model
        self.params = list(model.parameters())
        # ``device``: where the learner's tensors live when its parameters
        # are shapes only (a mesh member's, ``fed.cohort.shard_member``)
        self.device = (self.params[0].device if device is None
                       else torch.device(device))
        self.opt = opt
        self.opt_state = opt.init(self.params)
        self.rng = rng
        self.temperature = temperature
        self.distill_loss = distill_loss
        # kernel dispatch for the KL loss (repro_torch.kernels.dispatch)
        self.kernel_backend = kernel_backend

    def _epoch(self, n: int, batch_size: int):
        """One epoch's batch indices, as one (steps, batch) device tensor."""
        batches = epoch_batches(self.rng.permutation(n), batch_size)
        if not batches:
            return []
        return torch.as_tensor(np.stack(batches), device=self.device)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.model.training != train:
            self.model.train(train)
        return self.model(x)

    def _step(self, loss: torch.Tensor) -> float:
        grads = torch.autograd.grad(loss, self.params)
        upd, self.opt_state = self.opt.update(grads, self.opt_state,
                                              self.params)
        apply_updates(self.params, upd)
        return float(loss.detach())

    def distill(self, x: torch.Tensor, teacher: torch.Tensor,
                weight: torch.Tensor, epochs: int, batch_size: int) -> float:
        """Distillation on device tensors: x (n, ...), teacher (n, K),
        weight (n,) — temperature KL, or MSE on raw logits."""
        n = len(x)
        losses = []
        for _ in range(epochs):
            for idx in self._epoch(n, batch_size):
                logits = self._forward(x[idx], True)
                if self.distill_loss == "mse":
                    loss = D.kd_mse_loss(logits, teacher[idx], weight[idx])
                else:
                    loss = D.kd_kl_loss(logits, teacher[idx],
                                        self.temperature, weight[idx],
                                        backend=self.kernel_backend)
                losses.append(self._step(loss))
        return float(np.mean(losses)) if losses else 0.0

    # ------------------------------------------------- resumable service
    def state_dict(self, params=None, mu=None, step=None) -> dict:
        """Parameters, SGD state and shuffling stream, in the reference's
        layout (host numpy); ``params``, ``mu`` and ``step`` (tensors
        aligned with the parameters) stand in for the learner's own."""
        mu = self.opt_state["mu"] if mu is None else mu
        step = self.opt_state["step"] if step is None else step
        return {"params": flatten_tree(self.model.jax_params(params)),
                "opt_state": flatten_tree({
                    "mu": self.model.jax_params(mu),
                    "step": np.asarray(step, np.int32)}),
                "rng": rng_state_dict(self.rng)}

    def read_state(self, sd: dict, params, mu, *,
                   source: str = "learner") -> int:
        """A ``state_dict``'s parameters and momentum written into
        ``params`` (None: the learner's own, buffers included) and ``mu``
        (tensors aligned with the parameters, whole shapes); returns its
        step. A missing leaf or a shape mismatch raises."""
        like = self.model.jax_params(params)
        self.model.load_jax_params(unflatten_like(
            sd["params"], like, source=f"{source} params"), into=params)
        opt = unflatten_like(sd["opt_state"],
                             {"mu": like, "step": np.int32(0)},
                             source=f"{source} opt_state")
        self.model.load_jax_params(opt["mu"], into=mu)
        return int(opt["step"])

    def load_state_dict(self, sd: dict, *, source: str = "learner") -> None:
        """Overlay a ``state_dict`` (the port's or the reference's) onto
        this learner's device; a missing leaf or a shape mismatch
        raises."""
        mu = [torch.empty_like(p) for p in self.params]
        step = self.read_state(sd, None, mu, source=source)
        self.opt_state = {"mu": mu, "step": step}
        load_rng_state(self.rng, sd["rng"])

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._forward(x, False)

    def evaluate(self, x_test: torch.Tensor, y_test: torch.Tensor,
                 batch_size: int = 512) -> float:
        """Accuracy on device tensors; one host read at the end."""
        n = len(y_test)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for s in range(0, n, batch_size):
            pred = torch.argmax(self.predict(x_test[s:s + batch_size]), -1)
            correct += (pred == y_test[s:s + batch_size]).sum()
        return int(correct) / max(n, 1)


class Client(Learner):
    def __init__(self, cid: int, model: nn.Module, opt: Optimizer,
                 x: np.ndarray, y: np.ndarray, dre=None, *,
                 num_classes: int = 10, temperature: float = 3.0,
                 distill_loss: str = "kl", seed: int = 0,
                 kernel_backend: Optional[str] = None,
                 dre_init: Optional[np.ndarray] = None,
                 dre_aux: Optional[np.ndarray] = None, arch_key=None,
                 device=None):
        super().__init__(model, opt, np.random.default_rng(seed + 1000 * cid),
                         temperature=temperature, distill_loss=distill_loss,
                         kernel_backend=kernel_backend, device=device)
        self.cid = cid
        # clients sharing an arch_key have the same model structure and
        # share one optimizer instance: the cohort engine stacks them
        # (None = a cohort of its own)
        self.arch_key = arch_key
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        # samples in their own kind (token ids stay integers for the
        # embedding lookup, images stay NHWC); the DRE's features are the
        # flattened samples as f32, raw token ids included and images in
        # (h, w, c) order, as in the reference
        self._x = sample_tensor(self.x, self.device)
        self._y = torch.as_tensor(self.y, dtype=torch.int64,
                                  device=self.device)
        self.dre = dre
        # injected DRE seeds (a parity harness hands in the reference's):
        # k-means seeds for KMeans-DRE, auxiliary samples for KuLSIF-DRE;
        # None = drawn from learn_dre's generator
        self.dre_init = dre_init
        self.dre_aux = dre_aux
        self.num_classes = num_classes

    # ----------------------------------------------------------------- init
    def _dev(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return (None if a is None
                else torch.tensor(a, dtype=torch.float32, device=self.device))

    def learn_dre(self, generator: Optional[torch.Generator] = None) -> None:
        if self.dre is None:
            return
        feats = self._x.reshape(len(self.x), -1).to(torch.float32)
        if hasattr(self.dre, "distances"):      # KMeans-DRE
            self.dre = self.dre.learn(feats, generator=generator,
                                      init=self._dev(self.dre_init))
        else:                                   # KuLSIF-DRE
            self.dre = self.dre.learn(feats, generator=generator,
                                      aux=self._dev(self.dre_aux))

    # ------------------------------------------------------------- training
    def local_train(self, epochs: int, batch_size: int) -> float:
        n = len(self.y)
        losses = []
        for _ in range(epochs):
            for idx in self._epoch(n, batch_size):
                logits = self._forward(self._x[idx], True)
                losses.append(self._step(D.ce_loss(logits, self._y[idx])))
        return float(np.mean(losses)) if losses else 0.0

    # ------------------------------------------------------------ FD round
    def proxy_logits(self, proxy_x: torch.Tensor) -> torch.Tensor:
        return self.predict(proxy_x)

    def filter_mask(self, proxy_x: torch.Tensor,
                    proxy_owner: torch.Tensor) -> FilterStats:
        if self.dre is None:   # unfiltered methods: everything is "ID"
            t = len(proxy_x)
            ones = torch.ones((t,), dtype=torch.bool, device=self.device)
            return FilterStats(ones, ones, ones,
                               torch.zeros((t,), device=self.device))
        return two_stage_filter(
            self.dre, proxy_x.reshape(len(proxy_x), -1).to(torch.float32),
            proxy_owner, self.cid)

    def classwise_means(self):
        """FKD/PLS: per-class mean logits over the private data and the
        per-class counts, device tensors."""
        return classwise_mean_logits(self.predict(self._x), self._y,
                                     self.num_classes)
