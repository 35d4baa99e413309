"""KV-cache quantization shared by the dense int8 cache.

Port of ``quantize_kv`` from ``k8s_tpu/models/paged.py``; the block-pool
attention seam around it comes with the batched engine.
"""

from __future__ import annotations

import torch


def quantize_kv(x):
    """Symmetric per-vector absmax int8 quantization for KV storage:
    ``x`` is ``[..., D]`` vectors; returns ``(q int8 [..., D], scale f32
    [...])``.  ``torch.round`` rounds half to even, as the reference does,
    so the int8 values are bit-identical."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale
