"""Synthetic class-clustered feature datasets (the reference's feature mode).

Each dataset is a mixture of per-class Gaussian clusters in a latent
space, rendered as flat feature vectors through a fixed random linear
decoder — the CIFAR10*-style pre-extracted-feature mode of the paper, with
the class separation of ``repro.data.synthetic.SPECS``. The reference
draws with ``jax.random``, which PyTorch cannot reproduce, so
``make_dataset`` draws the same distribution from a seeded CPU
``torch.Generator``; ``dataset_from_arrays`` wraps arrays made elsewhere
(for example by the reference, for a parity run).

Image (``*_like``) and token (``lm_tokens``) datasets are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch


class Dataset(NamedTuple):
    x: np.ndarray        # (n, d) float32 features
    y: np.ndarray        # (n,) int32 labels
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    name: str


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    num_classes: int = 10
    latent_dim: int = 16
    separation: float = 6.0      # distance between class means
    within_std: float = 1.0      # intra-class spread
    feature_dim: int = 50        # flat-feature output dim


SPECS = {
    "mnist_feat": SyntheticSpec("mnist_feat", separation=8.0, within_std=1.0),
    "fashion_feat": SyntheticSpec("fashion_feat", separation=5.0,
                                  within_std=1.2),
    "cifar_feat": SyntheticSpec("cifar_feat", separation=2.5, within_std=1.6,
                                latent_dim=32),
    "cifar_feat_resnet": SyntheticSpec("cifar_feat_resnet", separation=6.0,
                                       within_std=1.1, latent_dim=32),
}
# reference datasets whose port is still to come (ROADMAP queue A)
NOT_PORTED = {"mnist_like": "4 (the image CNN zoo)",
              "fashion_like": "4 (the image CNN zoo)",
              "cifar_like": "4 (the image CNN zoo)",
              "lm_tokens": "9 (the transformer scenario)"}


def check_dataset(name: str) -> None:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet: ROADMAP queue A item "
            f"{NOT_PORTED[name]}")
    if name not in SPECS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(SPECS)}")


def make_dataset(name: str, *, n_train: int = 5000, n_test: int = 1000,
                 seed: int = 0) -> Dataset:
    check_dataset(name)
    spec = SPECS[name]
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((spec.num_classes, spec.latent_dim), generator=g)
    means = (means / torch.linalg.vector_norm(means, dim=-1, keepdim=True)
             * spec.separation)

    def sample(n):
        y = torch.randint(0, spec.num_classes, (n,), generator=g)
        z = means[y] + spec.within_std * torch.randn(
            (n, spec.latent_dim), generator=g)
        return z, y.to(torch.int32)

    z_tr, y_tr = sample(n_train)
    z_te, y_te = sample(n_test)
    dec = (torch.randn((spec.latent_dim, spec.feature_dim), generator=g)
           / math.sqrt(spec.latent_dim))
    return Dataset(x=(z_tr @ dec).numpy(), y=y_tr.numpy(),
                   x_test=(z_te @ dec).numpy(), y_test=y_te.numpy(),
                   num_classes=spec.num_classes, name=name)


def dataset_from_arrays(x, y, x_test, y_test, num_classes: int,
                        name: str = "arrays") -> Dataset:
    """Wrap externally made feature arrays as a ``Dataset``."""
    return Dataset(x=np.asarray(x, np.float32), y=np.asarray(y, np.int32),
                   x_test=np.asarray(x_test, np.float32),
                   y_test=np.asarray(y_test, np.int32),
                   num_classes=int(num_classes), name=name)
