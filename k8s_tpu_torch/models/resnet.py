"""ResNet-v1.5: port of ``k8s_tpu/models/resnet.py`` (ResNet-50, the
reference's flagship benchmark workload).

Numerics follow the reference's flax module:

- the forward takes NHWC images, as the reference, and runs the network
  on an NCHW view of them in ``torch.channels_last`` (``permute(0, 3, 1,
  2)`` of a contiguous NHWC tensor already has those strides, the layout
  cuDNN's fast convolutions want); parameters are f32, and every
  convolution casts its weight and input to ``dtype`` (bf16 by default),
  as flax's ``Conv(dtype=..., param_dtype=float32)``;
- :class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``,
  not ``nn.BatchNorm2d``: batch statistics in f32 with the **biased**
  variance, both to normalise and in the running update ``ra = 0.9 * ra
  + 0.1 * batch``; ``train=False`` normalises with the running stats.  The
  normalisation is f32 throughout, ``(x - mean) * scale * rsqrt(var +
  eps) + bias``, rounded to ``dtype`` once;
- ``bn3``'s scale starts at zero (each block starts as the identity);
- the space-to-depth stem (``stem="s2d"``) is a 4x4/s1 convolution over
  a 2x2 space-to-depth of the input, padded ``[(2, 1), (2, 1)]``, channels
  packed (row offset, col offset, channel); :func:`stem_weights_to_s2d`
  maps the 7x7/s2 stem's weights onto it;
- max-pool 3/2 pads with -inf; the 1x1/s2 projection pads nothing (flax's
  ``SAME`` at a 1x1 kernel); the head takes the global mean in ``dtype``
  into an f32 dense layer.

The reference's convolutions are XLA, not Pallas kernels: here they are
cuDNN's, and no hand-written kernel runs on this path.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from k8s_tpu_torch.ops._common import resolve_device

STEMS = ("conv", "s2d")
# flax BatchNorm(momentum=0.9, epsilon=1e-5), the reference's settings
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """flax's ``BatchNorm`` over the channels of an NCHW tensor.

    ``scale`` and ``bias`` are parameters; ``mean`` and ``var`` (flax's
    ``batch_stats``) are buffers.  In training the normalisation is
    ``F.batch_norm``'s (f32 statistics, biased variance, f32 arithmetic,
    one rounding to the input's dtype); the running update is done here to
    flax's rule, because torch's would decay the other way round and put
    the unbiased variance into ``var``.  The batch statistics come from
    ``F.batch_norm`` itself, written into scratch buffers at momentum 1
    (the batch mean and the unbiased variance, rescaled here to the
    biased one), so no f32 copy of the activation is made."""

    def __init__(self, features: int, *, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def reset(self) -> None:
        """flax's initial values: scale 1 (0 for ``zero_scale``), bias 0,
        running mean 0 and variance 1."""
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x, train: bool):
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, BN_EPS)
        mean = torch.zeros_like(self.mean)
        var = torch.ones_like(self.var)
        y = F.batch_norm(x, mean, var, self.scale, self.bias, True, 1.0,
                         BN_EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = BN_MOMENTUM
            self.mean.mul_(m).add_(mean, alpha=1 - m)
            self.var.mul_(m).add_(var * ((n - 1) / n), alpha=1 - m)
        return y


def _conv(x, conv: nn.Conv2d, dtype):
    """``conv`` with its f32 weight cast to ``dtype``, as flax's
    ``Conv(dtype=...)``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), bias, conv.stride,
                    conv.padding)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut where the
    shape changes (the first block of a stage)."""

    def __init__(self, in_features: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride=strides,
                               padding=1, bias=False)
        self.bn2 = BatchNorm(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = BatchNorm(filters * 4, zero_scale=True)
        if in_features != filters * 4 or strides != 1:
            self.conv_proj = nn.Conv2d(in_features, filters * 4, 1,
                                       stride=strides, bias=False)
            self.bn_proj = BatchNorm(filters * 4)

    def forward(self, x, train: bool, dtype):
        y = F.relu(self.bn1(_conv(x, self.conv1, dtype), train))
        y = F.relu(self.bn2(_conv(y, self.conv2, dtype), train))
        y = self.bn3(_conv(y, self.conv3, dtype), train)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.bn_proj(_conv(x, self.conv_proj, dtype), train)
        return F.relu(residual + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: ``[B, H, W, C] -> [B, H/b, W/b, b*b*C]``,
    channels packed (row offset, col offset, channel), the order
    :func:`stem_weights_to_s2d` assumes."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def stem_weights_to_s2d(w7: np.ndarray) -> np.ndarray:
    """Map 7x7-stride-2 stem weights ``[7, 7, C, O]`` (flax's layout) to
    the equivalent 4x4-stride-1 weights ``[4, 4, 4C, O]`` over a 2x2
    space-to-depth input.

    The 7x7 kernel is zero-padded to 8x8 at the top-left (tap k of the
    original covers input row 2i-3+k; block di holds rows 2i-4+2di and
    2i-3+2di, so tap (di, r) of the block kernel is original tap 2di+r-1,
    with (di=0, r=0) falling off the kernel: the zero row and column)."""
    w7 = np.asarray(w7)
    k, k2, c, o = w7.shape
    if (k, k2) != (7, 7):
        raise ValueError("the stem transform is specific to the 7x7 stem")
    p = np.zeros((8, 8, c, o), dtype=w7.dtype)
    p[1:, 1:] = w7
    # [8,8,C,O] -> [4, 2(row off), 4, 2(col off), C, O] -> [4,4,2,2,C,O]
    p = p.reshape(4, 2, 4, 2, c, o).transpose(0, 2, 1, 3, 4, 5)
    return p.reshape(4, 4, 4 * c, o)


class ResNet(nn.Module):
    """ResNet-v1.5 family; ``stage_sizes`` (3, 4, 6, 3) is ResNet-50.
    Parameters are drawn from ``seed`` on ``device`` (convolution and
    dense kernels ~ N(0, 1/fan_in), the scale of flax's lecun-normal
    default; biases 0; BatchNorm as :meth:`BatchNorm.reset`) and kept in
    ``torch.channels_last``.  ``forward(x, train=True)``: NHWC images in,
    f32 logits out; ``train`` uses and updates the batch statistics."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: Any = torch.bfloat16,
                 stem: str = "conv", *, device="cuda", seed: int = 0):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r} (expected one of "
                             f"{STEMS})")
        self.dtype, self.stem = dtype, stem
        dev = resolve_device(device)
        with torch.device("meta"):
            if stem == "s2d":  # padded by hand: flax's [(2, 1), (2, 1)]
                self.conv_init = nn.Conv2d(12, num_filters, 4, bias=False)
            else:
                self.conv_init = nn.Conv2d(3, num_filters, 7, stride=2,
                                           padding=3, bias=False)
            self.bn_init = BatchNorm(num_filters)
            blocks, features = {}, num_filters
            for i, count in enumerate(stage_sizes):
                for j in range(count):
                    filters = num_filters * 2 ** i
                    blocks[f"stage{i}_block{j}"] = BottleneckBlock(
                        features, filters, 2 if i > 0 and j == 0 else 1)
                    features = filters * 4
            self.blocks = nn.ModuleDict(blocks)
            self.head = nn.Linear(features, num_classes)
        self.to_empty(device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, BatchNorm):
                    module.reset()
                elif isinstance(module, (nn.Conv2d, nn.Linear)):
                    w = module.weight
                    w.copy_(torch.randn(w.shape, generator=g, device=dev)
                            * w[0].numel() ** -0.5)
                    if module.bias is not None:
                        module.bias.zero_()
        self.to(memory_format=torch.channels_last)

    def forward(self, x, train: bool = True):
        dt = self.dtype
        x = x.to(dt)
        if self.stem == "s2d":
            x = space_to_depth(x, 2).permute(0, 3, 1, 2)
            x = _conv(F.pad(x, (2, 1, 2, 1)), self.conv_init, dt)
        else:
            x = _conv(x.permute(0, 3, 1, 2), self.conv_init, dt)
        x = F.relu(self.bn_init(x, train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks.values():
            x = block(x, train, dt)
        x = x.mean(dim=(2, 3))  # global average pool, in dtype
        return self.head(x.float())


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16,
             stem: str = "conv", **kw) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, dtype=dtype,
                  stem=stem, **kw)


def resnet18_thin(num_classes: int = 10, dtype=torch.float32,
                  **kw) -> ResNet:
    """Small variant for CPU tests."""
    return ResNet((1, 1), num_classes=num_classes, num_filters=8,
                  dtype=dtype, **kw)
