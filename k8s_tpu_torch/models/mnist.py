"""MNIST conv net: port of ``k8s_tpu/models/mnist.py`` (the dist-mnist
model).

    conv 5x5/32 SAME -> relu -> maxpool 2 -> conv 5x5/64 SAME -> relu
    -> maxpool 2 -> dense 512 -> relu -> dense 10

Input is NHWC ``[B, 28, 28, 1]``, as in the reference.  The convolutions
run on an NCHW view of it (``permute(0, 3, 1, 2)`` of a contiguous NHWC
tensor has the channels_last strides cuDNN prefers).  The reference
flattens its NHWC activation in (h, w, c) order into ``Dense_0``; the
port permutes back to NHWC before its flatten, so ``Dense_0``'s rows keep
the reference's order and its parameters carry across with a transpose
only (``models/bridge.py``: ``mnist_from_jax`` / ``mnist_to_jax``).
Everything is f32, as the reference's default dtypes.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from k8s_tpu_torch.ops._common import resolve_device


class MnistCNN(nn.Module):
    """The reference's ``MnistCNN``; parameters drawn from ``seed`` on
    ``device`` (conv and dense kernels ~ N(0, 1/fan_in), biases zero, the
    scale of flax's lecun-normal default)."""

    def __init__(self, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        with torch.device("meta"):
            self.conv_0 = nn.Conv2d(1, 32, 5, padding=2)
            self.conv_1 = nn.Conv2d(32, 64, 5, padding=2)
            self.dense_0 = nn.Linear(7 * 7 * 64, 512)
            self.dense_1 = nn.Linear(512, 10)
        self.to_empty(device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                else:
                    fan_in = p[0].numel()
                    p.copy_(torch.randn(p.shape, generator=g, device=dev)
                            * fan_in ** -0.5)

    def forward(self, x):
        """``[B, 28, 28, 1]`` f32 images -> ``[B, 10]`` logits."""
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.conv_1(x)), 2)
        # (h, w, c) order, as the reference's NHWC flatten
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense_1(F.relu(self.dense_0(x)))


def synthetic_batch(generator: torch.Generator, batch_size: int = 64):
    """A synthetic batch for smoke runs without a dataset: images ~
    N(0, 1) ``[B, 28, 28, 1]`` f32 and labels uniform in [0, 10), drawn
    from ``generator`` on its device.  The reference draws from a threefry
    key, so the same seed gives other values there: a batch is
    reproducible within the port only."""
    dev = generator.device
    x = torch.randn((batch_size, 28, 28, 1), generator=generator, device=dev)
    y = torch.randint(0, 10, (batch_size,), generator=generator, device=dev)
    return x, y
