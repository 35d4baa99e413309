"""Flash attention forward: a hand-written CUDA kernel for Hopper
(``csrc/flash_fwd.cu``) beside its plain PyTorch version.

Port of ``k8s_tpu/ops/flash_attention.py``'s forward: the Pallas kernel
``_fwd_kernel`` (driven by ``_flash_fwd``) becomes one CUDA kernel that
loops over k/v tiles inside a thread block instead of walking a
sequential grid dimension (see the note at the top of the source).

- :func:`flash_attention` keeps the public ``[B, L, H, D]`` layout and the
  reference's guards; the kernel reads and writes that layout through
  strides, so there is no transpose copy.
- :func:`flash_fwd` is the counterpart of ``_flash_fwd``: ``[B, H, L, D]``
  in, ``(o, lse [B, H, L, 1] f32)`` out — the pair the ring variants
  consume.
- GQA (``Hkv`` dividing ``H``) is native in both: the kernel reads kv head
  ``h // (H // Hkv)``; the plain version repeats K/V as the reference's
  wrapper does.

Dispatch follows the tensors: CPU tensors take :func:`flash_fwd_plain`,
CUDA tensors launch the kernel or raise.  The backward kernels (dq, dk/dv)
come with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from k8s_tpu_torch.ops import _build
from k8s_tpu_torch.ops._common import count_launch, use_plain

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fn = None


def _kernel():
    """The ctypes entry point of ``csrc/flash_fwd.cu`` (built at first
    use)."""
    global _fn
    if _fn is None:
        fn = _build.load("flash_fwd").k8s_flash_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_window(causal: bool, window) -> None:
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding-window "
                             "attention is a causal construction)")
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")


def _check_heads(H: int, Hkv: int) -> None:
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv_heads {Hkv}")


def flash_fwd_plain(q, k, v, scale: float, causal: bool, window=None):
    """The plain version of :func:`flash_fwd`: ``q`` ``[B, H, L, D]``,
    ``k``/``v`` ``[B, Hkv, Lk, D]``.  f32 scores and softmax over the whole
    row, with the kernel's masking conventions (NEG_INF, a fully masked
    row gives o = 0 and lse = NEG_INF).  Returns ``(o in q.dtype,
    lse [B, H, L, 1] f32)``."""
    _check_window(causal, window)
    H, L, Hkv, Lk = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    _check_heads(H, Hkv)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = None
    if causal:
        qpos = torch.arange(L, device=q.device)[:, None]
        kpos = torch.arange(Lk, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m <= NEG_INF / 2, 0.0, m))
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / den
    lse = torch.where(m <= NEG_INF / 2, NEG_INF, m + torch.log(den))
    return o.to(q.dtype), lse


def _launch(q, k, v, o, lse, scale: float, causal: bool, window) -> None:
    """Launch the kernel over ``[B, H, L, D]``-indexed views (any batch,
    head and row strides; the last dim contiguous) into ``o`` and the
    contiguous ``[B, H, L]`` f32 ``lse``."""
    B, H, L, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one of {list(_DTYPE_CODES)} for "
                        f"q, k and v alike, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS or k.shape[3] != D or v.shape[3] != D:
        raise ValueError(f"flash kernel head_dim must be one of {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match, with batch {B}")
    if min(L, Lk) < 1 or B * H > 65535:
        raise ValueError(f"flash kernel needs L, Lk >= 1 and B*H <= 65535 "
                         f"(B={B}, H={H}, L={L}, Lk={Lk})")
    if any(t.stride(3) != 1 for t in (q, k, v, o)):
        raise ValueError("flash kernel needs a contiguous head_dim")
    if code and any(t.data_ptr() % 16
                    or any(t.stride(i) % 8 for i in range(3) if t.shape[i] > 1)
                    for t in (q, k, v, o)):
        # the tensor-core body copies rows in 16-byte chunks
        raise ValueError("flash kernel needs 16-byte aligned bf16/fp16 rows "
                         "(data and batch/head/row strides multiples of 8)")
    strides = (ctypes.c_int64 * 12)(*(
        t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), code, B, H, Hkv, L,
                        Lk, D, ctypes.cast(strides, ctypes.c_void_p),
                        float(scale), int(causal),
                        0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    count_launch("flash_fwd")


def flash_fwd(q, k, v, scale: float | None = None, causal: bool = True,
              window=None):
    """Counterpart of the reference's ``_flash_fwd``: ``q`` ``[B, H, L,
    D]``, ``k``/``v`` ``[B, Hkv, Lk, D]``; returns ``(o [B, H, L, D] in
    q.dtype, lse [B, H, L, 1] f32)``."""
    _check_window(causal, window)
    _check_heads(q.shape[1], k.shape[1])
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"causal=True requires L == Lk (got L={q.shape[2]}, "
                         f"Lk={k.shape[2]})")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_plain(q, k, v):
        return flash_fwd_plain(q, k, v, scale, causal, window)
    B, H, L, D = q.shape
    o = torch.empty((B, H, L, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _launch(q, k, v, o, lse, scale, causal, window)
    return o, lse[..., None]


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None):
    """Fused attention.  q: ``[B, L, H, D]``; k, v: ``[B, Lk, Hkv, D]``
    with Hkv dividing H (grouped-query).  Returns ``[B, L, H, D]`` in
    q.dtype.

    ``window`` (sliding-window attention): each query attends only the
    ``window`` most recent positions including itself (0 <= q_pos - k_pos
    < window); causal only.  The kernel visits only the k tiles a q tile
    can see, so compute drops from O(L^2) to O(L * window).
    """
    B, L, H, D = q.shape
    _check_window(causal, window)
    if causal and L != k.shape[1]:
        # the causal mask assumes q and k positions are both 0-aligned; a
        # kv-cache decode shape (Lk != L) would mask the wrong entries
        raise ValueError(
            f"causal=True requires L == Lk (got L={L}, Lk={k.shape[1]}); "
            "use causal=False or 0-pad q to the kv length")
    _check_heads(H, k.shape[2])
    if scale is None:
        scale = D ** -0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if use_plain(q, k, v):
        return flash_fwd_plain(qt, kt, vt, scale, causal,
                               window)[0].transpose(1, 2)
    o = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    _launch(qt, kt, vt, o.transpose(1, 2), lse, scale, causal, window)
    return o
