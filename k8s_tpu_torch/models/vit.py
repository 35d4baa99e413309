"""Vision Transformer: port of ``k8s_tpu/models/vit.py``, a patch
embedding in front of the port's own LM encoder stack.

As in the reference, the LM's :class:`~k8s_tpu_torch.models.transformer.
Block` is reused as is: bidirectional (``causal=False``), with positions
all zero, so RoPE rotates by nothing (cos 0 = 1, sin 0 = 0) and a learned
``pos_embedding`` does the positional work.  Blocks keep f32 master
weights, cast to ``config.dtype`` in each forward, as the trainable
Transformer; ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``).  Attention is the plain path
(``transformer._plain_attention``), by design as in the reference: 197
tokens do not fit the flash kernels' tiling and do not need them.  With
``use_fused_norm`` every block's two norms and the final norm launch the
CUDA RMSNorm kernel (K1): 2 * layers + 1 launches a forward.

The patch embedding is a strided convolution with bias in ``dtype`` over
an NCHW view of the NHWC images; its output, flattened over the patch
grid row by row, is the reference's ``reshape(B, num_patches, hidden)``.
Images have 3 channels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from k8s_tpu_torch.models.transformer import Block, RMSNorm, TransformerConfig
from k8s_tpu_torch.ops._common import resolve_device

IMAGE_CHANNELS = 3
POOLS = ("cls", "mean")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The reference's config, field for field, with ``dtype`` a torch
    dtype."""

    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden: int = 768
    # SwiGLU blocks (three FFN matrices): 2/3 of the classic 4 * hidden
    # keeps ViT-B/16's ~86M parameters
    ffn_hidden: int = 2048
    layers: int = 12
    heads: int = 12
    dtype: Any = torch.bfloat16
    pool: str = "cls"  # "cls" token | "mean" over patch tokens
    use_fused_norm: bool = False
    remat: bool = True

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}")
        n = self.image_size // self.patch_size
        return n * n

    def block_config(self) -> TransformerConfig:
        """The encoder blocks' config: bidirectional, no window, plain
        attention, sequence = patches + the cls token."""
        return TransformerConfig(
            vocab_size=1,  # unused: ViT embeds patches, not tokens
            hidden=self.hidden, ffn_hidden=self.ffn_hidden,
            layers=self.layers, heads=self.heads, kv_heads=self.heads,
            max_seq_len=self.num_patches + 1, causal=False,
            dtype=self.dtype, remat=self.remat,
            use_flash_attention=False,
            use_fused_norm=self.use_fused_norm,
        )


def vit_b16(**overrides) -> ViTConfig:
    """ViT-B/16 (the standard base config)."""
    return ViTConfig(**overrides)


def vit_tiny_test() -> ViTConfig:
    """CPU-testable config."""
    return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                     hidden=64, ffn_hidden=128, layers=2, heads=4,
                     dtype=torch.float32, remat=False)


class ViT(nn.Module):
    """``[B, H, W, 3]`` images -> ``[B, num_classes]`` f32 logits.

    Parameters are f32, drawn from ``seed`` on ``device``: the patch and
    head kernels and every block projection ~ N(0, 1/fan_in), biases and
    the cls token 0, ``pos_embedding`` ~ N(0, 0.02), norm scales 1."""

    def __init__(self, config: ViTConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        cfg = self.config = config
        if cfg.pool not in POOLS:
            raise ValueError(f"unknown pool {cfg.pool!r} "
                             "(expected 'cls' or 'mean')")
        n_tokens = cfg.num_patches + 1
        bc = cfg.block_config()
        dev = resolve_device(device)
        with torch.device("meta"):
            self.patch_embed = nn.Conv2d(IMAGE_CHANNELS, cfg.hidden,
                                         cfg.patch_size,
                                         stride=cfg.patch_size)
            self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden))
            self.pos_embedding = nn.Parameter(
                torch.empty(1, n_tokens, cfg.hidden))
            self.layers = nn.ModuleList(Block(bc) for _ in range(cfg.layers))
            self.final_norm = RMSNorm(cfg.hidden, fused=cfg.use_fused_norm)
            self.head = nn.Linear(cfg.hidden, cfg.num_classes)
        self.to_empty(device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)

        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * std)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".scale"):
                    p.fill_(1.0)
                elif name.endswith(".bias") or name == "cls_token":
                    p.zero_()
                elif name == "pos_embedding":
                    normal(p, 0.02)
                else:
                    normal(p, p[0].numel() ** -0.5)

    def forward(self, images, train: bool = False):
        """``train`` is accepted for symmetry with ResNet (no batch
        statistics, no dropout)."""
        del train
        cfg = self.config
        dt = cfg.dtype
        B = images.shape[0]
        pe = self.patch_embed
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), pe.weight.to(dt),
                     pe.bias.to(dt), stride=pe.stride)
        x = x.flatten(2).transpose(1, 2)  # [B, num_patches, hidden]
        cls = self.cls_token.to(dt).expand(B, 1, cfg.hidden)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        # position 0 everywhere: RoPE is the identity
        zeros = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x, _ = torch.utils.checkpoint.checkpoint(
                    block, x, zeros, use_reentrant=False)
            else:
                x, _ = block(x, zeros)
        x = self.final_norm(x)
        feat = x[:, 0] if cfg.pool == "cls" else x[:, 1:].mean(dim=1)
        return self.head(feat.float())
