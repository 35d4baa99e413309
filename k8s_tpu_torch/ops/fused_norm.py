"""Fused RMSNorm forward: a Triton kernel for Hopper beside its plain
PyTorch version.

Port of ``k8s_tpu/ops/fused_norm.py`` (the Pallas kernel ``_rms_kernel``,
launched by ``_rms``).  Semantics kept exactly:

1. mean of squares in f32;
2. ``rsqrt(var + eps)``;
3. the normalized row is rounded to ``x.dtype``;
4. then multiplied by the scale in f32;
5. the output dtype is ``torch.promote_types(x.dtype, scale.dtype)``.

What bounds it on this card: a row reduction plus an elementwise scale,
about three operations per element against 2 bytes in and 4 bytes out
(bf16 x, f32 scale), so HBM bandwidth is the bound.  The kernel moves each
byte once: one program per row loads the whole row (masked when D is not a
power of two) into registers, reduces it in f32 and stores once; the
variance never touches memory.

:func:`rms_norm` is differentiable on either device through one
``torch.autograd.Function``: its backward is the reference's closed form
(``_rms_bwd``: ``dx = r * (g*s - xhat * mean(g*s * xhat))``,
``dscale = sum(g * xhat)``) in plain PyTorch, as the JAX package leaves
that short elementwise chain to XLA rather than a kernel.  Dispatch follows
the tensors: CPU tensors take :func:`rms_norm_plain` for the forward, CUDA
tensors launch the kernel or raise.
"""

# No ``from __future__ import annotations`` here: Triton reads the kernel's
# ``"tl.constexpr"`` annotation as written.
import torch

from k8s_tpu_torch.ops._common import count_launch, use_plain

_FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)

# ``triton.language``, bound at the first launch: triton exists only on
# the machine with the card, so it is imported there, never on import.
tl = None
_jit = None


def _rms_row_kernel(x_ptr, s_ptr, o_ptr, D, stride_x, stride_o, eps,
                    BLOCK_D: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    r = tl.div_rn(1.0, tl.sqrt_rn(var + eps))
    y = (x * r).to(x_ptr.dtype.element_ty).to(tl.float32)
    s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + row * stride_o + cols,
             (y * s).to(o_ptr.dtype.element_ty), mask=mask)


def _kernel():
    global tl, _jit
    if _jit is None:
        import triton
        import triton.language

        tl = triton.language
        _jit = triton.jit(_rms_row_kernel)
    return _jit


def rms_norm_plain(x, scale, eps: float = 1e-6):
    """The plain version of :func:`rms_norm` (and the unfused module's
    formula): ``x`` ``[..., D]``, ``scale`` ``[D]``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    out_dtype = torch.promote_types(x.dtype, scale.dtype)
    return (y.float() * scale.float()).to(out_dtype)


def _rms_norm_kernel(x, scale, eps: float):
    """Launch the Triton kernel over the rows of ``x``."""
    if x.dtype not in _FLOAT_TYPES or scale.dtype not in _FLOAT_TYPES:
        raise TypeError(f"rms_norm kernel takes {_FLOAT_TYPES}, got "
                        f"x {x.dtype}, scale {scale.dtype}")
    D = x.shape[-1]
    x2d = x.reshape(-1, D)
    if x2d.stride(1) != 1:
        x2d = x2d.contiguous()
    scale = scale.contiguous()
    out = torch.empty(x2d.shape, device=x.device,
                      dtype=torch.promote_types(x.dtype, scale.dtype))
    if x2d.shape[0] == 0:
        return out.reshape(x.shape)
    block = 1 << (D - 1).bit_length()
    with torch.cuda.device(x.device):
        _kernel()[(x2d.shape[0],)](
            x2d, scale, out, D, x2d.stride(0), out.stride(0), float(eps),
            BLOCK_D=block, num_warps=max(1, min(8, block // 512)))
    count_launch("rms_norm")
    return out.reshape(x.shape)


def rms_norm_bwd(x, scale, g, eps: float = 1e-6):
    """The reference's closed-form VJP of :func:`rms_norm` (``_rms_bwd``):
    returns ``(dx in x.dtype, dscale in scale.dtype)``."""
    D = x.shape[-1]
    x32 = x.reshape(-1, D).float()
    g32 = g.reshape(-1, D).float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    dscale = (g32 * xhat).sum(dim=0).to(scale.dtype)
    gs = g32 * scale.float()
    dx = r * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype).reshape(x.shape), dscale


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if use_plain(x, scale):
            return rms_norm_plain(x, scale, eps)
        return _rms_norm_kernel(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis.  x: ``[..., D]``; scale: ``[D]``.
    Returns ``promote_types(x.dtype, scale.dtype)``; differentiable in x
    and scale."""
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    return _RmsNorm.apply(x, scale, float(eps))
