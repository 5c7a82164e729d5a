"""CNN models used by the paper: the VGG, ResNet and MobileNetV2 families.

Port of ``repro.models.cnn``.
Conventions as in the reference:

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

The same applies take a cohort of K clients (the batched client round of
``fl.executors.VmapExecutor``): every leaf of the params and BN state
leads with K, and the images are (K, B, H, W, C).  Inside, the clients'
channels sit side by side in one grouped layout, (B, K*C, H, W): a
convolution of K clients is one grouped convolution (``groups`` times K)
and a BatchNorm one call whose per-channel statistics are per client as
they stand; the dense layers are batched products, (K, B, C) by (K, N,
C).
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


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: ``ceil(size / stride)``
    outputs, the padding they need split with the smaller half before.  A
    3x3 stride-2 convolution on an even size pads 0 before and 1 after,
    where ``F.conv2d(padding=1)`` would pad 1 on each side."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_apply(p: dict, x: torch.Tensor, stride: int = 1,
               groups: int = 1) -> torch.Tensor:
    """SAME convolution on NCHW activations; the input is padded apart
    only where SAME pads one side more than the other.  ``groups`` is
    JAX's ``feature_group_count``: a depthwise convolution of C channels
    has weights (C, 1, k, k) and ``groups=C``, in the same OIHW layout.
    A cohort's weights (K, O, I, k, k) take its grouped layout (B, K*C, H,
    W): one convolution with ``groups`` times K."""
    w = p["w"]
    if w.ndim == 5:
        groups *= w.shape[0]
        w = w.reshape((-1,) + tuple(w.shape[2:]))
    k = w.shape[-1]
    (top, bottom), (left, right) = (same_padding(n, k, stride)
                                    for n in x.shape[2:])
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left),
                        groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                    stride=stride, groups=groups)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``min(max(x, 0), 6)`` with ``jax.nn.relu6``'s gradient: 1 strictly
    inside (0, 6) and 0 at both bounds, as ``F.relu6`` has it
    (``torch.clamp`` passes the gradient at the bounds)."""
    return F.relu6(x)


def dense_init(gen, out_d: int, in_d: int, device) -> dict:
    return {"w": _normal(gen, (out_d, in_d), math.sqrt(2.0 / in_d), device),
            "b": torch.zeros((out_d,), dtype=torch.float32, device=device)}


def dense_apply(p: dict, x: torch.Tensor,
                s: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ W^T + b``; with a per-row scale ``s`` (N,) the product is Eq.
    4 at matmul time, ``x @ (s * W)^T``, on the ``scaled_matmul`` kernel
    (its plain version on the CPU), and ``W`` is not scaled first.  A
    cohort's x (K, B, C), W (K, N, C), b (K, N) and s (K, N): one batched
    product (a ``torch.bmm`` without the scale)."""
    if x.ndim == 3:
        cohort, b = True, p["b"][:, None, :]
    else:
        cohort, b = False, p["b"]
    if s is None or not at_matmul(p["w"], s, cohort):
        return x @ p["w"].transpose(-1, -2) + b
    return scaled_matmul(x, p["w"], s) + b


def bn_init(c: int, device):
    return ({"gamma": torch.ones((c,), device=device),
             "beta": torch.zeros((c,), device=device)},
            {"mean": torch.zeros((c,), device=device),
             "var": torch.ones((c,), device=device)})


def bn_apply(p: dict, s: dict, x: torch.Tensor, train: bool):
    """BatchNorm over the N, H, W axes of NCHW activations; a cohort's
    parameters and stats (K, C) on its grouped layout (B, K*C, H, W), where
    each channel's statistics are its own client's."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3)).reshape(s["mean"].shape)
        var = torch.var(x, dim=(0, 2, 3), correction=0).reshape(
            s["var"].shape)
        new_s = {"mean": BN_MOMENTUM * s["mean"] + (1 - BN_MOMENTUM) * mean,
                 "var": BN_MOMENTUM * s["var"] + (1 - BN_MOMENTUM) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s

    def c(v):
        return v.reshape(1, -1, 1, 1)

    y = (x - c(mean)) * torch.rsqrt(c(var) + BN_EPS) * c(p["gamma"]) + c(p["beta"])
    return y, new_s


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC images (B, H, W, C) as an NCHW view; a cohort's (K, B, H, W,
    C) as its grouped layout (B, K*C, H, W), channels-last in memory,
    which cuDNN's grouped convolutions take without transposing
    (``chip_smoke.grouped_layout_times`` times both layouts)."""
    if x.ndim == 5:
        k, b, h, w, c = x.shape
        x = x.permute(1, 2, 3, 0, 4).reshape(b, h, w, k * c)
    return x.permute(0, 3, 1, 2)


def global_pool(x: torch.Tensor, cohort: int | None) -> torch.Tensor:
    """Global average pool of NCHW activations -> (B, C); of a cohort of
    ``cohort`` clients' grouped layout -> (K, B, C), the dense layers'
    batched input."""
    if cohort is None:
        return torch.mean(x, dim=(2, 3))
    x = torch.mean(x, dim=(2, 3))
    return x.reshape(x.shape[0], cohort, -1).transpose(0, 1)


def cohort_of(x: torch.Tensor) -> int | None:
    """The cohort size of a model's input images, None for one client's."""
    return x.shape[0] if x.ndim == 5 else None


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
        the other leaves (``core.scaling.apply_scales_tree``).  Images
        (K, B, H, W, C) with trees whose leaves lead with K run a cohort,
        logits (K, B, classes)."""
        new_state = dict(state)

        def dense(name, x):
            s = None if scales is None else scales[name]["w"]
            return dense_apply(params[name], x, s)

        k = cohort_of(x)
        x = to_nchw(x)
        for i in range(len(widths)):
            x = conv_apply(params[f"conv{i}"], x)
            x, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"],
                                              state[f"bn{i}"], x, train)
            x = F.relu(x)
            if i in pool_after:
                x = F.max_pool2d(x, 2, 2)  # VALID: odd edges are dropped
        x = F.relu(dense("fc0", global_pool(x, k)))
        return dense("fc1", x), new_state

    return CNNModel(name, init, apply)


def vgg11_thinned(num_classes: int = 10, in_channels: int = 3) -> CNNModel:
    return make_vgg("vgg11_thinned", [32, 64, 128, 128, 128, 128, 128, 128],
                    num_classes, in_channels)


def vgg16_tiny(num_classes: int = 2, in_channels: int = 1) -> CNNModel:
    """The Chest X-ray setting's VGG16 (one input channel, 2 classes)."""
    return make_vgg("vgg16_tiny",
                    [32, 32, 64, 64, 128, 128, 128, 128, 128, 128],
                    num_classes, in_channels, pool_after=(1, 3, 5, 7, 9))


# ------------------------------------------------------------------ ResNet

def make_resnet(name: str, widths, blocks_per_stage: int, num_classes: int,
                in_channels: int = 3) -> CNNModel:
    """ResNet18-style basic blocks, thinned for 32x32 inputs.  The first
    block of every stage but the first has stride 2; a block whose width
    changes has a 1x1 projection shortcut (``_proj``), one that keeps it
    takes every ``stride``-th pixel."""

    def init(gen: torch.Generator, device="cpu"):
        device = torch.device(device)
        params, state = {}, {}
        params["stem"] = conv_init(gen, widths[0], in_channels, 3, device)
        params["stem_bn"], state["stem_bn"] = bn_init(widths[0], device)
        in_c = widths[0]
        for si, w in enumerate(widths):
            for bi in range(blocks_per_stage):
                pre = f"s{si}b{bi}"
                params[f"{pre}_c1"] = conv_init(gen, w, in_c, 3, device)
                params[f"{pre}_bn1"], state[f"{pre}_bn1"] = bn_init(w, device)
                params[f"{pre}_c2"] = conv_init(gen, w, w, 3, device)
                params[f"{pre}_bn2"], state[f"{pre}_bn2"] = bn_init(w, device)
                if in_c != w:
                    params[f"{pre}_proj"] = conv_init(gen, w, in_c, 1, device)
                in_c = w
        params["fc"] = dense_init(gen, num_classes, widths[-1], device)
        return params, state

    def apply(params, state, x, train=False, scales=None):
        """As ``make_vgg``'s apply: with ``scales``, ``fc`` applies its
        per-row scale inside its product."""
        new_state = dict(state)

        def bn(name, x):
            y, new_state[name] = bn_apply(params[name], state[name], x, train)
            return y

        k = cohort_of(x)
        x = to_nchw(x)
        x = F.relu(bn("stem_bn", conv_apply(params["stem"], x)))
        for si in range(len(widths)):
            for bi in range(blocks_per_stage):
                pre = f"s{si}b{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                h = F.relu(bn(f"{pre}_bn1", conv_apply(params[f"{pre}_c1"], x,
                                                       stride)))
                h = bn(f"{pre}_bn2", conv_apply(params[f"{pre}_c2"], h))
                if f"{pre}_proj" in params:
                    x = conv_apply(params[f"{pre}_proj"], x, stride)
                elif stride != 1:
                    x = x[:, :, ::stride, ::stride]
                x = F.relu(h + x)
        s = None if scales is None else scales["fc"]["w"]
        return dense_apply(params["fc"], global_pool(x, k), s), new_state

    return CNNModel(name, init, apply)


def resnet18_small(num_classes: int = 20, in_channels: int = 3) -> CNNModel:
    """The paper's ResNet18 thinned to widths [32, 64, 128, 128]."""
    return make_resnet("resnet18_small", [32, 64, 128, 128], 2, num_classes,
                       in_channels)


# ------------------------------------------------------------------ MobileNetV2

def make_mobilenet(name: str, num_classes: int, in_channels: int = 3,
                   blocks=((16, 1), (24, 2), (32, 2), (64, 1)),
                   expand: int = 4) -> CNNModel:
    """Inverted-residual blocks: expand 1x1 -> depthwise 3x3 -> project
    1x1, each with BN and (but the projection) ``relu6``.  The first block
    of every stage but the first has stride 2 (in its depthwise
    convolution); a block adds its input where it keeps stride 1 and
    width.  The paper's "S only on the output convolutions of each
    inverted residual block" variant is the scale predicate
    ``mobilenet_proj_only_predicate``."""

    def init(gen: torch.Generator, device="cpu"):
        device = torch.device(device)
        params, state = {}, {}
        stem_w = 16
        params["stem"] = conv_init(gen, stem_w, in_channels, 3, device)
        params["stem_bn"], state["stem_bn"] = bn_init(stem_w, device)
        in_c = stem_w
        for si, (w, n) in enumerate(blocks):
            for bi in range(n):
                pre = f"ir{si}_{bi}"
                mid = in_c * expand
                params[f"{pre}_expand"] = conv_init(gen, mid, in_c, 1, device)
                params[f"{pre}_bn1"], state[f"{pre}_bn1"] = bn_init(mid,
                                                                    device)
                params[f"{pre}_dw"] = conv_init(gen, mid, 1, 3, device)
                params[f"{pre}_bn2"], state[f"{pre}_bn2"] = bn_init(mid,
                                                                    device)
                params[f"{pre}_proj"] = conv_init(gen, w, mid, 1, device)
                params[f"{pre}_bn3"], state[f"{pre}_bn3"] = bn_init(w, device)
                in_c = w
        params["head"] = conv_init(gen, 128, in_c, 1, device)
        params["head_bn"], state["head_bn"] = bn_init(128, device)
        params["fc"] = dense_init(gen, num_classes, 128, device)
        return params, state

    def apply(params, state, x, train=False, scales=None):
        """As ``make_vgg``'s apply: with ``scales``, ``fc`` applies its
        per-row scale inside its product."""
        new_state = dict(state)

        def bn(name, x):
            y, new_state[name] = bn_apply(params[name], state[name], x, train)
            return y

        k = cohort_of(x)
        x = to_nchw(x)
        x = relu6(bn("stem_bn", conv_apply(params["stem"], x)))
        in_c = 16
        for si, (w, n) in enumerate(blocks):
            for bi in range(n):
                pre = f"ir{si}_{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                mid = in_c * expand
                h = relu6(bn(f"{pre}_bn1",
                             conv_apply(params[f"{pre}_expand"], x)))
                h = relu6(bn(f"{pre}_bn2",
                             conv_apply(params[f"{pre}_dw"], h, stride,
                                        groups=mid)))
                h = bn(f"{pre}_bn3", conv_apply(params[f"{pre}_proj"], h))
                x = (x + h) if (stride == 1 and in_c == w) else h
                in_c = w
        x = relu6(bn("head_bn", conv_apply(params["head"], x)))
        s = None if scales is None else scales["fc"]["w"]
        return dense_apply(params["fc"], global_pool(x, k), s), new_state

    return CNNModel(name, init, apply)


def mobilenetv2_small(num_classes: int = 20,
                      in_channels: int = 3) -> CNNModel:
    """The paper's MobileNetV2, thinned (widths 16-64, head 128)."""
    return make_mobilenet("mobilenetv2_small", num_classes, in_channels)


def mobilenet_proj_only_predicate(path: str, leaf) -> bool:
    """The paper's reduced-S MobileNetV2 variant: scales only on the output
    (projection) convolutions of each inverted-residual block, the head
    and the classifier."""
    return leaf.ndim >= 2 and ("_proj" in path
                               or path.startswith(("head", "fc")))
