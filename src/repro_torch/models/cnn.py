"""CNN models used by the paper: the VGG family.

Port of ``repro.models.cnn`` (VGG only).  Conventions as in the reference:

* conv weights (O, I, Kh, Kw), dense weights (O, I): dim 0 is the filter /
  output-neuron axis the scaling factors and sparsifiers act on;
* ``apply(params, state, x, train)`` takes NHWC images and returns
  ``(logits, new_state)``; the model permutes to NCHW inside; given the
  scales tree (``scales=``) its dense layers apply their Eq. 4 scales at
  matmul time (``kernels.scaled_matmul``);
* BatchNorm is functional: training normalises with the biased batch
  variance and updates the running stats as ``0.9*old + 0.1*batch``;
  ``train=False`` uses (and keeps) the running stats, which is how
  Algorithm 1 freezes BN during scale training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.scaling import at_matmul
from repro_torch.kernels.scaled_matmul import scaled_matmul

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


# ------------------------------------------------------------------ layers

def _normal(gen: torch.Generator, shape, std: float,
            device: torch.device) -> torch.Tensor:
    # drawn on the CPU so a seed gives the same weights on every device
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return w.to(device)


def conv_init(gen, out_c: int, in_c: int, k: int, device) -> dict:
    return {"w": _normal(gen, (out_c, in_c, k, k),
                         math.sqrt(2.0 / (in_c * k * k)), device)}


def conv_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME convolution on NCHW activations."""
    k = p["w"].shape[-1]
    return F.conv2d(x, p["w"], padding=k // 2)


def dense_init(gen, out_d: int, in_d: int, device) -> dict:
    return {"w": _normal(gen, (out_d, in_d), math.sqrt(2.0 / in_d), device),
            "b": torch.zeros((out_d,), dtype=torch.float32, device=device)}


def dense_apply(p: dict, x: torch.Tensor,
                s: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ W^T + b``; with a per-row scale ``s`` (N,) the product is Eq.
    4 at matmul time, ``x @ (s * W)^T``, on the ``scaled_matmul`` kernel
    (its plain version on the CPU), and ``W`` is not scaled first."""
    if s is None or not at_matmul(p["w"], s):
        return x @ p["w"].T + p["b"]
    return scaled_matmul(x, p["w"], s) + p["b"]


def bn_init(c: int, device):
    return ({"gamma": torch.ones((c,), device=device),
             "beta": torch.zeros((c,), device=device)},
            {"mean": torch.zeros((c,), device=device),
             "var": torch.ones((c,), device=device)})


def bn_apply(p: dict, s: dict, x: torch.Tensor, train: bool):
    """BatchNorm over the N, H, W axes of NCHW activations."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.var(x, dim=(0, 2, 3), correction=0)
        new_s = {"mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                 "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s

    def c(v):
        return v.reshape(1, -1, 1, 1)

    y = (x - c(mean)) * torch.rsqrt(c(var) + BN_EPS) * c(p["gamma"]) + c(p["beta"])
    return y, new_s


# ------------------------------------------------------------------ model API

@dataclasses.dataclass(frozen=True)
class CNNModel:
    name: str
    init: Callable  # (generator, device) -> (params, state)
    apply: Callable  # (params, state, x_nhwc, train) -> (logits, new_state)


# ------------------------------------------------------------------ VGG

def make_vgg(name: str, widths, num_classes: int, in_channels: int = 3,
             dense_width: int = 128, pool_after=(0, 1, 3, 5, 7)) -> CNNModel:
    """Thinned VGG (paper §5.1: [32,64,128,...,128], 128-wide dense)."""
    pool_after = set(pool_after)

    def init(gen: torch.Generator, device="cpu"):
        device = torch.device(device)
        params, state = {}, {}
        in_c = in_channels
        for i, w in enumerate(widths):
            params[f"conv{i}"] = conv_init(gen, w, in_c, 3, device)
            params[f"bn{i}"], state[f"bn{i}"] = bn_init(w, device)
            in_c = w
        params["fc0"] = dense_init(gen, dense_width, widths[-1], device)
        params["fc1"] = dense_init(gen, num_classes, dense_width, device)
        return params, state

    def apply(params, state, x, train=False, scales=None):
        """With ``scales`` (the scales tree), each dense layer applies its
        weight's per-row scale inside its product; the caller has scaled
        the other leaves (``core.scaling.apply_scales_tree``)."""
        new_state = dict(state)

        def dense(name, x):
            s = None if scales is None else scales[name]["w"]
            return dense_apply(params[name], x, s)

        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i in range(len(widths)):
            x = conv_apply(params[f"conv{i}"], x)
            x, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"],
                                              state[f"bn{i}"], x, train)
            x = F.relu(x)
            if i in pool_after:
                x = F.max_pool2d(x, 2, 2)  # VALID: odd edges are dropped
        x = torch.mean(x, dim=(2, 3))  # global average pool
        x = F.relu(dense("fc0", x))
        return dense("fc1", x), new_state

    return CNNModel(name, init, apply)


def vgg11_thinned(num_classes: int = 10, in_channels: int = 3) -> CNNModel:
    return make_vgg("vgg11_thinned", [32, 64, 128, 128, 128, 128, 128, 128],
                    num_classes, in_channels)
