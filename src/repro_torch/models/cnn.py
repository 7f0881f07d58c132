"""Client models: the paper's heterogeneous CNN zoo (Tables I and II) and
the feature-mode ``MLPClassifier``.

Ten MNIST/FashionMNIST architectures (28×28×1) and ten VGG-style CIFAR-10
architectures (32×32×3, with BatchNorm), one per client slot, as declared
in ``repro.models.cnn``. A ``Spec`` keeps the declarative layer list
(``C`` conv, ``BN``, ``Lin``) and builds one client's ``CNNClassifier``
from it. The model takes NHWC images, as the reference does, and runs each
block as conv → ReLU → [maxpool 2, floor], with BN a layer of its own
after it; the first ``Lin`` flattens in (h, w, c) order, so the
reference's dense weights load as they are, and a ``Lin`` whose width is
not the class count is followed by a ReLU. BatchNorm uses the batch's
statistics (biased variance over N, H, W) in train mode and its stored
mean 0 and variance 1 in eval mode; like the reference it never updates
them. Convolutions, pooling and dense layers are library calls
(``F.conv2d``, ``F.max_pool2d``, ``@``), as they are outside any kernel in
the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.pytree import (host_values, init_conv, init_dense,
                                       targets)

BN_EPS = 1e-5


def _load(dst: torch.Tensor, src, name: str) -> None:
    src = torch.from_numpy(np.array(src, np.float32))
    if src.shape != dst.shape:
        raise ValueError(f"{name}: shape {tuple(src.shape)} given, the "
                         f"model's is {tuple(dst.shape)}")
    dst.copy_(src)


class _Conv(nn.Module):
    """conv (stride 1, VALID or SAME at an odd kernel) → ReLU → [maxpool]."""

    def __init__(self, c_in: int, c_out: int, k: int, pool: bool, pad: str,
                 generator, device):
        super().__init__()
        p = init_conv(c_in, c_out, k, generator=generator, device=device)
        self.w = nn.Parameter(p["w"])              # (c_out, c_in, k, k)
        self.b = nn.Parameter(p["b"])
        self.pool = pool
        self.padding = k // 2 if pad == "SAME" else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(F.conv2d(x, self.w, self.b, padding=self.padding))
        return F.max_pool2d(x, 2) if self.pool else x

    def load(self, p: Dict, dst, buffers: bool) -> None:
        # the reference's HWIO weight -> OIHW
        _load(dst(self.w), np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)),
              "conv w")
        _load(dst(self.b), p["b"], "conv b")

    def export(self, host: Dict[int, np.ndarray], buffers: bool) -> Dict:
        # OIHW -> the reference's HWIO
        return {"w": np.transpose(host[id(self.w)], (2, 3, 1, 0)),
                "b": host[id(self.b)]}


class _BatchNorm(nn.Module):
    """Batch statistics in train mode, the fixed buffers in eval mode."""

    def __init__(self, c: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((c,), device=device))
        self.bias = nn.Parameter(torch.zeros((c,), device=device))
        self.register_buffer("mean", torch.zeros((c,), device=device))
        self.register_buffer("var", torch.ones((c,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return F.batch_norm(x, None, None, self.scale, self.bias,
                                training=True, eps=BN_EPS)
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            training=False, eps=BN_EPS)

    def load(self, p: Dict, dst, buffers: bool) -> None:
        for name in ("scale", "bias"):
            _load(dst(getattr(self, name)), p[name], f"bn {name}")
        if buffers:
            for name in ("mean", "var"):
                _load(getattr(self, name), p[name], f"bn {name}")

    def export(self, host: Dict[int, np.ndarray], buffers: bool) -> Dict:
        # the reference keeps the statistics among the parameters; their
        # gradient is 0 (train mode reads the batch's), so their momentum
        # is 0 too
        stats = {name: (getattr(self, name).to("cpu", copy=True).numpy()
                        if buffers else np.zeros(tuple(self.mean.shape),
                                                 np.float32))
                 for name in ("mean", "var")}
        return {"scale": host[id(self.scale)], "bias": host[id(self.bias)],
                **stats}


class _Linear(nn.Module):
    """``x @ w + b`` with w (d_in, d_out), flattening NCHW activations in
    the reference's NHWC order first; ReLU unless ``last``."""

    def __init__(self, d_in: int, d_out: int, relu: bool, generator,
                 device):
        super().__init__()
        p = init_dense(d_in, d_out, generator=generator, bias=True,
                       device=device)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = x @ self.w + self.b
        return torch.relu(x) if self.relu else x

    def load(self, p: Dict, dst, buffers: bool) -> None:
        _load(dst(self.w), p["w"], "linear w")
        _load(dst(self.b), p["b"], "linear b")

    def export(self, host: Dict[int, np.ndarray], buffers: bool) -> Dict:
        return {"w": host[id(self.w)], "b": host[id(self.b)]}


class CNNClassifier(nn.Module):
    """One client's CNN, built by ``Spec.build``: NHWC images (B, H, W, C)
    -> logits (B, num_classes). ``model.train()`` / ``model.eval()`` set
    BatchNorm's mode, as the reference's ``train`` argument does."""

    def __init__(self, layers: nn.ModuleList):
        super().__init__()
        self.layers = layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)          # NCHW view of NHWC memory
        for layer in self.layers:
            x = layer(x)
        return x

    def load_jax_params(self, params: List[Dict[str, np.ndarray]],
                        into=None) -> "CNNClassifier":
        """Copy the reference's parameter list (one dict a layer: conv
        ``w`` HWIO and ``b``; BN ``scale``, ``bias``, ``mean``, ``var``;
        dense ``w`` (d_in, d_out) and ``b``) into this module, or, with
        ``into`` (tensors aligned with ``parameters()``, e.g. the SGD
        momentum), into those tensors; BN's statistics, buffers here,
        then go nowhere."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} layers given, model has "
                             f"{len(self.layers)}")
        dst = targets(self, into)
        with torch.no_grad():
            for layer, p in zip(self.layers, params):
                layer.load(p, dst, into is None)
        return self

    def jax_params(self, values=None) -> List[Dict[str, np.ndarray]]:
        """The inverse of ``load_jax_params``: the reference's parameter
        list as numpy, of this module's weights or of ``values`` (tensors
        aligned with ``parameters()``), BN's statistics then zero."""
        host = host_values(self, values)
        return [layer.export(host, values is None) for layer in self.layers]


class Spec:
    """Declarative layer list -> one client's ``CNNClassifier``."""

    def __init__(self, layers: Sequence[tuple], num_classes: int = 10):
        self.layers = layers
        self.num_classes = num_classes

    def build(self, input_hw: int, channels: int, *,
              generator: Optional[torch.Generator] = None,
              device=None) -> CNNClassifier:
        """The model for (input_hw, input_hw, channels) images; weights
        drawn on the CPU from ``generator``, layer by layer, then moved to
        ``device``."""
        mods = []
        h = input_hw
        c = channels
        flat = None
        for spec in self.layers:
            kind = spec[0]
            if kind == "conv":
                _, cout, ksz, pool, pad = spec
                mods.append(_Conv(c, cout, ksz, pool, pad, generator, device))
                if pad != "SAME":
                    h = h - ksz + 1
                if pool:
                    h = h // 2
                c = cout
                flat = h * h * c
            elif kind == "bn":
                mods.append(_BatchNorm(c, device))
            elif kind == "linear":
                _, dout = spec
                din = flat if flat is not None else c
                mods.append(_Linear(din, dout, dout != self.num_classes,
                                    generator, device))
                flat = dout
            else:
                raise ValueError(f"unknown layer {spec!r}")
        return CNNClassifier(nn.ModuleList(mods))


def C(cout, k, pool=True, pad="VALID"):
    return ("conv", cout, k, pool, pad)


def BN():
    return ("bn",)


def Lin(d):
    return ("linear", d)


# --------------------------------------------------------------------------
# Table I — MNIST / FashionMNIST clients (28x28x1)
# --------------------------------------------------------------------------
MNIST_CLIENTS: List[Spec] = [
    Spec([C(10, 5), C(20, 5), Lin(50), Lin(10)]),                       # 1
    Spec([C(16, 3), C(32, 3), C(64, 3, pool=False), Lin(50), Lin(10)]), # 2
    Spec([C(10, 5), C(20, 5), Lin(50), Lin(10)]),                       # 3
    Spec([C(12, 3), C(24, 3), C(48, 3, pool=False), Lin(100), Lin(50),
          Lin(10)]),                                                    # 4
    Spec([C(8, 5), C(16, 5), Lin(100), Lin(50), Lin(10)]),              # 5
    Spec([C(6, 7), C(12, 5), Lin(50), Lin(10)]),                        # 6
    Spec([C(32, 3, pool=False), C(64, 3, pool=False), Lin(50),
          Lin(10)]),                                                    # 7
    Spec([C(20, 5), C(30, 5), Lin(50), Lin(10)]),                       # 8
    Spec([C(8, 5), C(16, 5), Lin(64), Lin(32), Lin(10)]),               # 9
    Spec([C(16, 3), C(32, 3), C(64, 3), Lin(100), Lin(10)]),            # 10
]

# --------------------------------------------------------------------------
# Table II — CIFAR-10 clients (32x32x3); VGG-style with BatchNorm
# --------------------------------------------------------------------------
CIFAR_CLIENTS: List[Spec] = [
    Spec([C(64, 3, pad="SAME"), BN(), C(128, 3, pad="SAME"), BN(),
          C(256, 3, pool=False, pad="SAME"), BN(), Lin(512), Lin(10)]),
    Spec([C(64, 3, pad="SAME"), BN(), C(128, 3, pad="SAME"), BN(),
          C(128, 3, pool=False, pad="SAME"), BN(),
          C(256, 3, pad="SAME"), BN(), Lin(512), Lin(10)]),
    Spec([C(64, 5, pad="SAME"), BN(), C(128, 5, pad="SAME"), BN(),
          Lin(256), Lin(10)]),
    Spec([C(64, 3, pad="SAME"), BN(), C(128, 3, pad="SAME"), BN(),
          C(256, 3, pad="SAME"), BN(), C(512, 3, pool=False, pad="SAME"), BN(),
          Lin(512), Lin(10)]),
    Spec([C(32, 3, pad="SAME"), BN(), C(64, 3, pad="SAME"), BN(),
          C(128, 3, pad="SAME"), BN(), Lin(256), Lin(10)]),
    Spec([C(32, 3, pad="SAME"), BN(), C(64, 3, pad="SAME"), BN(),
          C(128, 3, pad="SAME"), BN(), C(256, 3, pool=False, pad="SAME"), BN(),
          Lin(512), Lin(10)]),
    Spec([C(64, 3, pad="SAME"), BN(), C(128, 3, pad="SAME"), BN(),
          C(256, 3, pool=False, pad="SAME"), BN(), Lin(1024), Lin(10)]),
    Spec([C(64, 3, pad="SAME"), BN(), C(128, 3, pad="SAME"), BN(),
          Lin(512), Lin(10)]),
    Spec([C(64, 3, pad="SAME"), BN(), C(128, 3, pad="SAME"), BN(),
          C(128, 3, pool=False, pad="SAME"), BN(),
          Lin(512), Lin(256), Lin(10)]),
    Spec([C(64, 3, pad="SAME"), BN(), C(128, 3, pad="SAME"), BN(),
          C(256, 3, pad="SAME"), BN(), Lin(1024), Lin(10)]),
]


def get_client_model(idx: int, dataset: str = "mnist"
                     ) -> Tuple[Spec, int, int]:
    """Returns (spec, input_hw, channels) for client idx (0-based)."""
    if dataset in ("mnist", "fashionmnist"):
        return MNIST_CLIENTS[idx % 10], 28, 1
    if dataset in ("cifar10",):
        return CIFAR_CLIENTS[idx % 10], 32, 3
    raise ValueError(dataset)


class MLPClassifier(nn.Module):
    """Small MLP for pre-extracted-feature experiments (CIFAR10* mode).

    Layer i holds ``weights[i]`` (d_in, d_out) and ``biases[i]`` (d_out,)
    and computes ``x @ w + b`` (ReLU between layers), the reference's
    layout, so JAX parameters load as they are (``load_jax_params``)."""

    def __init__(self, d_in: int, hidden: Sequence[int] = (256, 128),
                 num_classes: int = 10, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims = [d_in, *hidden, num_classes]
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for i in range(len(self.dims) - 1):
            p = init_dense(self.dims[i], self.dims[i + 1], generator=generator,
                           bias=True, device=device)
            self.weights.append(nn.Parameter(p["w"]))
            self.biases.append(nn.Parameter(p["b"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w + b
            if i < last:
                x = torch.relu(x)
        return x

    def load_jax_params(self, params: List[Dict[str, np.ndarray]],
                        into=None) -> "MLPClassifier":
        """Copy the reference's ``[{'w': (d_in, d_out), 'b': (d_out,)}, …]``
        parameter list into this module (no transposes), or, with ``into``
        (tensors aligned with ``parameters()``), into those tensors."""
        if len(params) != len(self.weights):
            raise ValueError(f"{len(params)} layers given, model has "
                             f"{len(self.weights)}")
        dst = targets(self, into)
        with torch.no_grad():
            for w, b, p in zip(self.weights, self.biases, params):
                _load(dst(w), p["w"], "linear w")
                _load(dst(b), p["b"], "linear b")
        return self

    def jax_params(self, values=None) -> List[Dict[str, np.ndarray]]:
        """The inverse of ``load_jax_params``: the reference's parameter
        list as numpy, of this module's weights or of ``values``."""
        host = host_values(self, values)
        return [{"w": host[id(w)], "b": host[id(b)]}
                for w, b in zip(self.weights, self.biases)]
