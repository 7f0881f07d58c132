"""Synthetic class-clustered datasets: the reference's image, feature and
token modes.

A feature or image dataset is a mixture of per-class Gaussian clusters in
a latent space, with the class separation of
``repro.data.synthetic.SPECS``, rendered through a fixed random linear
decoder: as flat feature vectors (the CIFAR10*-style pre-extracted-feature
mode of the paper, ``*_feat``) or as NHWC images ``tanh(z @ dec)`` with
pixels in [-1, 1] (the pixel mode, ``mnist_like`` and ``fashion_like``
28×28×1, ``cifar_like`` 32×32×3, which the Tables I/II CNN zoo trains
on). The token dataset
``lm_tokens`` (transformer clients) draws each sample as a (seq_len,)
int32 sequence from a narrow vocab band around a latent token y, labelled
y: an LM next-token task whose classes are vocab entries, separable in raw
token-id space for the KMeans-DRE filter. The reference draws with
``jax.random``, which PyTorch cannot reproduce, so ``make_dataset`` draws
the same distributions from a seeded CPU ``torch.Generator``;
``dataset_from_arrays`` wraps arrays made elsewhere (for example by the
reference, for a parity run).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch


class Dataset(NamedTuple):
    x: np.ndarray        # (n, d) float32 features, (n, H, W, C) float32
                         # images or (n, S) int32 tokens
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
    image_hw: int = 0            # 0 = flat features, else (hw, hw, channels)
    channels: int = 1
    feature_dim: int = 50        # flat-feature output dim
    seq_len: int = 0             # >0 = token mode: x is (n, seq_len) int32


SPECS = {
    "mnist_like": SyntheticSpec("mnist_like", separation=8.0, within_std=1.0,
                                image_hw=28, channels=1),
    "fashion_like": SyntheticSpec("fashion_like", separation=5.0,
                                  within_std=1.2, image_hw=28, channels=1),
    "cifar_like": SyntheticSpec("cifar_like", separation=2.5, within_std=1.6,
                                latent_dim=32, image_hw=32, channels=3),
    "mnist_feat": SyntheticSpec("mnist_feat", separation=8.0, within_std=1.0),
    "fashion_feat": SyntheticSpec("fashion_feat", separation=5.0,
                                  within_std=1.2),
    "cifar_feat": SyntheticSpec("cifar_feat", separation=2.5, within_std=1.6,
                                latent_dim=32),
    "cifar_feat_resnet": SyntheticSpec("cifar_feat_resnet", separation=6.0,
                                       within_std=1.1, latent_dim=32),
    "lm_tokens": SyntheticSpec("lm_tokens", num_classes=32, seq_len=16),
}


def check_dataset(name: str) -> None:
    if name not in SPECS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(SPECS)}")


def make_dataset(name: str, *, n_train: int = 5000, n_test: int = 1000,
                 seed: int = 0) -> Dataset:
    check_dataset(name)
    spec = SPECS[name]
    g = torch.Generator().manual_seed(seed)
    if spec.seq_len:
        return _token_dataset(spec, g, n_train, n_test)
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
    hw, ch = spec.image_hw, spec.channels
    out_dim = hw * hw * ch if hw else spec.feature_dim
    dec = (torch.randn((spec.latent_dim, out_dim), generator=g)
           / math.sqrt(spec.latent_dim))

    def render(z):
        if not hw:
            return (z @ dec).numpy()
        # bounded pixels in [-1, 1], NHWC as in the reference
        return torch.tanh(z @ dec).reshape(-1, hw, hw, ch).numpy()
    return Dataset(x=render(z_tr), y=y_tr.numpy(), x_test=render(z_te),
                   y_test=y_te.numpy(), num_classes=spec.num_classes,
                   name=name)


def _token_dataset(spec: SyntheticSpec, g: torch.Generator, n_train: int,
                   n_test: int) -> Dataset:
    """Tokens (y + noise) mod K, noise uniform in [-half_w, half_w] with
    half_w = max(1, K // 16), labelled y (the reference's sampler)."""
    k = spec.num_classes
    half_w = max(1, k // 16)

    def sample(n):
        y = torch.randint(0, k, (n,), generator=g)
        noise = torch.randint(-half_w, half_w + 1, (n, spec.seq_len),
                              generator=g)
        x = torch.remainder(y[:, None] + noise, k)
        return x.to(torch.int32).numpy(), y.to(torch.int32).numpy()

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return Dataset(x=x_tr, y=y_tr, x_test=x_te, y_test=y_te, num_classes=k,
                   name=spec.name)


def _as_samples(a) -> np.ndarray:
    """Integer arrays (token ids) stay integers, as int32; anything else
    (flat features or NHWC images) becomes float32 of the same shape."""
    a = np.asarray(a)
    return a.astype(np.int32 if np.issubdtype(a.dtype, np.integer)
                    else np.float32)


def sample_tensor(a, device) -> torch.Tensor:
    """Samples on ``device`` in the data's own kind: token ids as int64
    (embedding indices), features as float32. A tensor already there in
    that dtype is not copied."""
    t = torch.as_tensor(a)
    return t.to(device=device, dtype=torch.float32 if t.is_floating_point()
                else torch.int64)


def dataset_from_arrays(x, y, x_test, y_test, num_classes: int,
                        name: str = "arrays") -> Dataset:
    """Wrap externally made arrays as a ``Dataset``: float features or
    NHWC images, or integer token ids, which stay integers."""
    return Dataset(x=_as_samples(x), y=np.asarray(y, np.int32),
                   x_test=_as_samples(x_test),
                   y_test=np.asarray(y_test, np.int32),
                   num_classes=int(num_classes), name=name)
