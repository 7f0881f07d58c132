"""Federated client: private data + private model + DRE + training steps.

The client keeps its private data on its device once, draws its batch
order from its own ``np.random.default_rng(seed + 1000 * cid)`` stream
(the reference's, so the order carries over unchanged) and reads every
step's loss back to the host (``float(loss)``), as the reference does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import distill as D
from repro_torch.core.filtering import FilterStats, two_stage_filter
from repro_torch.fed.batching import epoch_batches
from repro_torch.optim.optimizers import Optimizer, apply_updates


class Client:
    def __init__(self, cid: int, model: nn.Module, opt: Optimizer,
                 x: np.ndarray, y: np.ndarray, dre=None, *,
                 num_classes: int = 10, temperature: float = 3.0,
                 seed: int = 0, kernel_backend: Optional[str] = None,
                 dre_init: Optional[np.ndarray] = None):
        self.cid = cid
        self.model = model
        self.params = list(model.parameters())
        self.device = self.params[0].device
        self.opt = opt
        self.opt_state = opt.init(self.params)
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self._x = torch.as_tensor(self.x, dtype=torch.float32,
                                  device=self.device)
        self._y = torch.as_tensor(self.y, dtype=torch.int64,
                                  device=self.device)
        self.dre = dre
        # injected k-means seeds for the DRE fit (a parity harness hands in
        # the reference's); None = k-means++ from learn_dre's generator
        self.dre_init = dre_init
        self.num_classes = num_classes
        self.temperature = temperature
        # kernel dispatch for the distill loss (repro_torch.kernels.dispatch)
        self.kernel_backend = kernel_backend
        self.rng = np.random.default_rng(seed + 1000 * cid)

    # ----------------------------------------------------------------- init
    def learn_dre(self, generator: Optional[torch.Generator] = None) -> None:
        init = (None if self.dre_init is None
                else torch.tensor(self.dre_init, dtype=torch.float32,
                                  device=self.device))
        self.dre = self.dre.learn(self._x.reshape(len(self.x), -1),
                                  generator=generator, init=init)

    # ------------------------------------------------------------- training
    def _epoch(self, n: int, batch_size: int):
        """One epoch's batch indices, as one (steps, batch) device tensor."""
        batches = epoch_batches(self.rng.permutation(n), batch_size)
        if not batches:
            return []
        return torch.as_tensor(np.stack(batches), device=self.device)

    def _step(self, loss: torch.Tensor) -> float:
        grads = torch.autograd.grad(loss, self.params)
        upd, self.opt_state = self.opt.update(grads, self.opt_state,
                                              self.params)
        apply_updates(self.params, upd)
        return float(loss.detach())

    def local_train(self, epochs: int, batch_size: int) -> float:
        n = len(self.y)
        losses = []
        for _ in range(epochs):
            for idx in self._epoch(n, batch_size):
                logits = self.model(self._x[idx])
                losses.append(self._step(D.ce_loss(logits, self._y[idx])))
        return float(np.mean(losses)) if losses else 0.0

    def distill(self, proxy_x: torch.Tensor, teacher: torch.Tensor,
                weight: torch.Tensor, epochs: int, batch_size: int) -> float:
        """Temperature-KL distillation on device tensors: proxy_x (t, d),
        teacher (t, K), weight (t,)."""
        n = len(proxy_x)
        losses = []
        for _ in range(epochs):
            for idx in self._epoch(n, batch_size):
                loss = D.kd_kl_loss(self.model(proxy_x[idx]), teacher[idx],
                                    self.temperature, weight[idx],
                                    backend=self.kernel_backend)
                losses.append(self._step(loss))
        return float(np.mean(losses)) if losses else 0.0

    # ------------------------------------------------------------ FD round
    def proxy_logits(self, proxy_x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(proxy_x)

    def filter_mask(self, proxy_x: torch.Tensor,
                    proxy_owner: torch.Tensor) -> FilterStats:
        return two_stage_filter(self.dre, proxy_x.reshape(len(proxy_x), -1),
                                proxy_owner, self.cid)

    # ---------------------------------------------------------------- eval
    def evaluate(self, x_test: torch.Tensor, y_test: torch.Tensor,
                 batch_size: int = 512) -> float:
        """Accuracy on device tensors; one host read at the end."""
        n = len(y_test)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for s in range(0, n, batch_size):
                pred = torch.argmax(self.model(x_test[s:s + batch_size]), -1)
                correct += (pred == y_test[s:s + batch_size]).sum()
        return int(correct) / n
