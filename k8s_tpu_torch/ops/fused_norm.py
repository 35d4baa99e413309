"""Fused RMSNorm forward: a CUDA C++ kernel for Hopper
(``csrc/rms_norm.cu``) beside its plain PyTorch version.

Port of ``k8s_tpu/ops/fused_norm.py`` (the Pallas kernel ``_rms_kernel``,
launched by ``_rms``).  Semantics kept exactly:

1. mean of squares in f32 (the kernel: the sum divided by ``D``);
2. ``rsqrt(var + eps)`` (the kernel: ``1 / sqrt``, each step correctly
   rounded);
3. the normalized row is rounded to ``x.dtype``;
4. then multiplied by the scale in f32;
5. the output dtype is ``torch.promote_types(x.dtype, scale.dtype)``.

What bounds it on this card: a row reduction plus an elementwise scale,
about three operations per element against 2 bytes in and 4 bytes out
(bf16 x, f32 scale), so HBM bandwidth where there are many rows; at the
1-16 rows of a decode step, the launch.  The kernel moves each byte once
and never writes the variance.  :func:`_rms_plan` picks one of its three
bodies from the shape, the types and the layout:

- ``row`` (fewer than ``STREAM_MIN_ROWS`` rows): one block a row, each
  thread one access of 16 bytes of the wider of x and the scale (or a
  few, for the widest rows);
- ``stream`` (many rows): a persistent grid whose blocks keep their
  columns of the scale in registers and stream their rows through a
  shared-memory ring filled by bulk async copies;
- ``scalar``: D, a row stride or a pointer that does not split into such
  aligned accesses; each thread holds 1, 2, 4 or 8 elements, the fewest
  that fit the row in 1024 threads.

The decode paths call it 65 times a model call, so the launch path is
lean: the ctypes entry is bound once, plans are cached, the device
context is entered only when x lies on another device than the current
one, and :func:`rms_norm` builds no autograd node when no gradient is
wanted.

:func:`rms_norm` is differentiable on either device through one
``torch.autograd.Function``: its backward is the reference's closed form
(``_rms_bwd``: ``dx = r * (g*s - xhat * mean(g*s * xhat))``,
``dscale = sum(g * xhat)``) in plain PyTorch, as the JAX package leaves
that short elementwise chain to XLA rather than a kernel.  Dispatch follows
the tensors: CPU tensors take :func:`rms_norm_plain` for the forward, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from k8s_tpu_torch.ops import _build
from k8s_tpu_torch.ops._common import N_SMS, count_launch, use_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FLOAT_TYPES = tuple(_DTYPE_CODES)
_OUT_TYPES = {(a, b): torch.promote_types(a, b)
              for a in _FLOAT_TYPES for b in _FLOAT_TYPES}
_BODY_CODES = {"row": 0, "stream": 1, "scalar": 2}  # csrc/rms_norm.cu Body

MAX_THREADS = 1024
# csrc/rms_norm.cu: the elements of x a scalar-body thread may hold
SCALAR_HOLDS = (1, 2, 4, 8)
# Launch shapes of the vector bodies, from timings on the H100:
STREAM_MIN_ROWS = 256  # from this many rows on, the persistent body
ROW_VECTORS = 1  # accesses of ``vec`` elements a row-body thread makes
STREAM_VECTORS = 4  # the same in the stream body: 256 threads at D 4096
MAX_CTAS_PER_SM = 4  # stream body blocks an SM, at most 1024 threads
# shared memory of the stream body's ring (under the 48 KB a block gets
# without opting in): 4 row buffers at D 4096 in bf16, 2 in f32
RING_BYTES = 40 * 1024
MAX_STAGES = 4

_fns: dict = {}
# torch._C._cuda_getDevice and _cuda_getCurrentRawStream, bound at the
# first launch (a CPU build of torch has neither)
_get_device = _raw_stream = None


@dataclasses.dataclass(frozen=True)
class RmsPlan:
    """How the kernel covers an ``[N, D]`` problem."""
    body: str     # "row", "stream" or "scalar"
    grid: int     # blocks
    threads: int  # threads a block, a multiple of 32
    vec: int      # elements a thread moves per access (1: the scalar body)
    nv: int       # accesses of ``vec`` elements a thread makes in a row
    #               (the scalar body: elements it holds in one pass)
    stages: int   # row buffers in the stream body's ring (0 otherwise)
    smem: int     # dynamic shared memory, bytes


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def _max_threads(nv: int, vec: int) -> int:
    """csrc/rms_norm.cu ``max_threads``: the launch bounds of a vector body
    whose threads hold ``nv * vec`` elements."""
    return MAX_THREADS if nv * vec <= 16 else 256


@functools.lru_cache(maxsize=512)
def _rms_plan(N: int, D: int, x_dtype, scale_dtype, x_ptr_mod16: int = 0,
              stride_x: int | None = None, s_ptr_mod16: int = 0) -> RmsPlan:
    """The body, grid, threads and vector width for ``N`` rows of ``D``
    elements of ``x_dtype`` (row ``i`` at ``i * stride_x`` elements, the
    data ``x_ptr_mod16`` bytes past a 16-byte boundary; the scale's data
    ``s_ptr_mod16``).  A thread of the vector bodies moves 16 bytes of the
    wider of x and the scale per access (``vec`` elements), so every output
    store is 16 bytes a thread; each access must be aligned to its own
    size.  The stream body's bulk copies also need whole rows on 16-byte
    boundaries.  Pure: the wrapper hands its choice to the C entry."""
    if x_dtype not in _DTYPE_CODES or scale_dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm kernel takes {_FLOAT_TYPES}, got "
                        f"x {x_dtype}, scale {scale_dtype}")
    if N < 1 or D < 1:
        raise ValueError(f"rms_norm kernel needs N, D >= 1 (N={N}, D={D})")
    stride_x = D if stride_x is None else stride_x
    size, s_size = x_dtype.itemsize, scale_dtype.itemsize
    vec = 16 // max(size, s_size)
    groups = D // vec
    fits = [nv for nv in (1, 2, 4)
            if -(-groups // nv) <= _max_threads(nv, vec)]
    if (D % vec or x_ptr_mod16 % (vec * size) or s_ptr_mod16 % (vec * s_size)
            or (N > 1 and stride_x % vec) or not fits):
        # as many threads as the row can use: a thread's chain of loads,
        # sums and stores is the time at a few short rows
        hold = next((h for h in SCALAR_HOLDS if D <= h * MAX_THREADS),
                    SCALAR_HOLDS[-1])
        threads = min(MAX_THREADS, _round32(-(-D // hold)))
        return RmsPlan("scalar", N, threads, 1, hold, 0, 0)
    stages = min(MAX_STAGES, RING_BYTES // (D * size))
    rows16 = not (x_ptr_mod16 or D * size % 16
                  or (N > 1 and stride_x * size % 16))
    stream = N >= STREAM_MIN_ROWS and stages >= 2 and rows16
    want = STREAM_VECTORS if stream else ROW_VECTORS
    nv = next((m for m in fits if m >= want), fits[-1])
    threads = _round32(-(-groups // nv))
    if stream:
        per_sm = max(1, min(MAX_CTAS_PER_SM, MAX_THREADS // threads))
        return RmsPlan("stream", min(N, per_sm * N_SMS), threads, vec, nv,
                       stages, stages * D * size)
    return RmsPlan("row", N, threads, vec, nv, 0, 0)


class _RmsArgs(ctypes.Structure):
    """csrc/rms_norm.cu ``RmsArgs``: one launch's plan, types and sizes."""
    _fields_ = [("x_dtype", ctypes.c_int), ("s_dtype", ctypes.c_int),
                ("body", ctypes.c_int), ("N", ctypes.c_int),
                ("D", ctypes.c_int), ("grid", ctypes.c_int),
                ("threads", ctypes.c_int), ("nv", ctypes.c_int),
                ("stages", ctypes.c_int), ("eps", ctypes.c_float),
                ("stride_x", ctypes.c_longlong)]


@functools.lru_cache(maxsize=512)
def _launch_args(N: int, D: int, x_dtype, scale_dtype, x_ptr_mod16: int,
                 stride_x: int, s_ptr_mod16: int, eps: float):
    """``(address, args, plan)``: the packed ``RmsArgs`` of a launch (kept
    alive by the cache) and its address, for the C entry."""
    plan = _rms_plan(N, D, x_dtype, scale_dtype, x_ptr_mod16, stride_x,
                     s_ptr_mod16)
    args = _RmsArgs(_DTYPE_CODES[x_dtype], _DTYPE_CODES[scale_dtype],
                    _BODY_CODES[plan.body], N, D, plan.grid, plan.threads,
                    plan.nv, plan.stages, eps, stride_x)
    return ctypes.addressof(args), args, plan


def _kernel():
    """The ctypes entry ``k8s_rms_norm`` of ``csrc/rms_norm.cu`` (built at
    first use): x, scale, out, the packed ``RmsArgs``, the stream."""
    global _get_device, _raw_stream
    fn = _fns.get("rms_norm")
    if fn is None:
        fn = _build.load("rms_norm").k8s_rms_norm
        fn.argtypes = [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _get_device = torch._C._cuda_getDevice
        _raw_stream = torch._C._cuda_getCurrentRawStream
        _fns["rms_norm"] = fn
    return fn


def rms_norm_plain(x, scale, eps: float = 1e-6):
    """The plain version of :func:`rms_norm` (and the unfused module's
    formula): ``x`` ``[..., D]``, ``scale`` ``[D]``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    out_dtype = torch.promote_types(x.dtype, scale.dtype)
    return (y.float() * scale.float()).to(out_dtype)


def _rms_norm_kernel(x, scale, eps: float):
    """Launch the CUDA kernel over the rows of ``x`` (any row stride; the
    last dim contiguous, else x is copied) into a new contiguous output."""
    out_dtype = _OUT_TYPES.get((x.dtype, scale.dtype))
    if out_dtype is None:
        raise TypeError(f"rms_norm kernel takes {_FLOAT_TYPES}, got "
                        f"x {x.dtype}, scale {scale.dtype}")
    dev = x.get_device()
    if scale.get_device() != dev:
        raise ValueError("rms_norm kernel inputs lie on different devices")
    D = x.shape[-1]
    if x.is_contiguous():
        x2d, N, stride = x, (x.numel() // D if D else 0), D
        out = torch.empty_like(x, dtype=out_dtype)
    else:
        x2d = x.reshape(-1, D)
        if x2d.stride(1) != 1:
            x2d = x2d.contiguous()
        N, stride = x2d.shape[0], x2d.stride(0)
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if not scale.is_contiguous():
        scale = scale.contiguous()
    if N == 0:
        return out
    xp, sp = x2d.data_ptr(), scale.data_ptr()
    fn = _kernel()
    addr, _, plan = _launch_args(N, D, x.dtype, scale.dtype, xp % 16, stride,
                                 sp % 16, eps)
    if dev == _get_device():
        err = fn(xp, sp, out.data_ptr(), addr, _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(xp, sp, out.data_ptr(), addr, _raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: cudaError_t "
                           f"{err} ({plan})")
    count_launch("rms_norm")
    return out


def _forward(x, scale, eps: float):
    if x.is_cuda and scale.is_cuda:
        return _rms_norm_kernel(x, scale, eps)
    use_plain(x, scale)  # raises unless both lie on the CPU
    return rms_norm_plain(x, scale, eps)


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
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis.  x: ``[..., D]``; scale: ``[D]``.
    Returns ``promote_types(x.dtype, scale.dtype)``; differentiable in x
    and scale (no autograd node when neither wants a gradient)."""
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RmsNorm.apply(x, scale, float(eps))
    return _forward(x, scale, float(eps))
