"""Flash attention: hand-written CUDA kernels for Hopper
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) beside their plain PyTorch
versions, joined by an autograd Function.

Port of ``k8s_tpu/ops/flash_attention.py``.  Each Pallas kernel becomes one
CUDA kernel that loops over tiles inside a thread block instead of walking
a sequential grid dimension (see the notes at the top of the sources):

- forward ``_fwd_kernel`` (driven by ``_flash_fwd``): o and lse by online
  softmax;
- backward ``_dq_kernel`` and ``_dkv_kernel`` (driven by ``_flash_bwd``):
  dq, and dk/dv summed over each GQA group, from p recomputed with the
  saved lse.  ``delta = rowsum(do * o)``, which the reference computes in
  XLA before its kernels, is computed in f32 by the dq kernel for its own
  rows and written to a buffer that the dk/dv kernel reads.

- :func:`flash_attention` keeps the public ``[B, L, H, D]`` layout and the
  reference's guards; the kernels read and write that layout through
  strides, so there is no transpose copy either way.
- :func:`flash_fwd` is the counterpart of ``_flash_fwd``: ``[B, H, L, D]``
  in, ``(o, lse [B, H, L, 1] f32)`` out — the pair the ring variants
  consume.  :func:`flash_bwd` is the counterpart of ``_flash_bwd``.
- Both public functions are differentiable on either device through one
  ``torch.autograd.Function``: its forward saves ``(q, k, v, o, lse)`` and
  its backward is :func:`flash_bwd`.  lse is not differentiable.
- GQA (``Hkv`` dividing ``H``) is native in the kernels: they read kv head
  ``h // (H // Hkv)``, and the dk/dv kernel sums the group itself; the
  plain versions repeat K/V as the reference's wrapper does.

Dispatch follows the tensors: CPU tensors take the plain versions, CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from k8s_tpu_torch.ops import _build
from k8s_tpu_torch.ops._common import count_launch, use_plain

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
N_SMS = 132  # streaming multiprocessors of one H100 SXM
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fns: dict = {}
# what a launch's nonzero return means (csrc/flash_sm90.cuh)
_ERRORS = ("error (a cudaError_t; 990: no tensor-map encoder in the driver; "
           "1000 + a CUresult: a tensor map refused)")


def _kernel(name: str = "fwd"):
    """The ctypes entry point ``fwd``, ``bwd_dq`` or ``bwd_dkv`` of
    ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu`` (built at first use)."""
    fn = _fns.get(name)
    if fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # dtype, B, H, Hkv, L, Lk, D, strides, scale, causal, window
        shape = [i, i, i, i, i, i, i, p, ctypes.c_float, i, i]
        if name == "fwd":
            fn = _build.load("flash_fwd").k8s_flash_fwd
            fn.argtypes = [p] * 5 + shape + [p]
        elif name == "bwd_dq":
            fn = _build.load("flash_bwd").k8s_flash_bwd_dq
            fn.argtypes = [p] * 8 + shape + [p]
        else:  # bwd_dkv also takes nsplit
            fn = _build.load("flash_bwd").k8s_flash_bwd_dkv
            fn.argtypes = [p] * 8 + shape + [i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


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


def _keep_mask(L: int, Lk: int, causal: bool, window, device):
    """The element mask ``[L, Lk]`` (None when nothing is masked)."""
    if not causal:
        return None
    qpos = torch.arange(L, device=device)[:, None]
    kpos = torch.arange(Lk, device=device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (qpos - kpos < window)
    return keep


def _repeat_kv(k, v, H: int):
    Hkv = k.shape[1]
    if Hkv == H:
        return k, v
    return (k.repeat_interleave(H // Hkv, dim=1),
            v.repeat_interleave(H // Hkv, dim=1))


def flash_fwd_plain(q, k, v, scale: float, causal: bool, window=None):
    """The plain version of :func:`flash_fwd`: ``q`` ``[B, H, L, D]``,
    ``k``/``v`` ``[B, Hkv, Lk, D]``.  f32 scores and softmax over the whole
    row, with the kernel's masking conventions (NEG_INF, a fully masked
    row gives o = 0 and lse = NEG_INF).  Returns ``(o in q.dtype,
    lse [B, H, L, 1] f32)``."""
    _check_window(causal, window)
    H, L, Hkv, Lk = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    _check_heads(H, Hkv)
    k, v = _repeat_kv(k, v, H)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = _keep_mask(L, Lk, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m <= NEG_INF / 2, 0.0, m))
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / den
    lse = torch.where(m <= NEG_INF / 2, NEG_INF, m + torch.log(den))
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, scale: float, causal: bool,
                    window=None):
    """The plain version of :func:`flash_bwd`, in the reference's formulas:
    p recomputed from the saved lse (a fully masked row's NEG_INF taken as
    0, masked entries 0), ``delta = rowsum(do * o)`` in f32,
    ``ds = p * (dp - delta) * scale``; dk/dv summed over each GQA group.
    Returns ``(dq, dk, dv)`` in the input types, dk/dv ``[B, Hkv, Lk,
    D]``."""
    _check_window(causal, window)
    B, H, L, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    _check_heads(H, Hkv)
    kr, vr = _repeat_kv(k, v, H)
    do32 = do.float()
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    lse = lse.reshape(B, H, L, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    keep = _keep_mask(L, Lk, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - torch.where(lse <= NEG_INF / 2, 0.0, lse))
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vr.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    if Hkv != H:
        dk = dk.reshape(B, Hkv, H // Hkv, Lk, D).sum(2)
        dv = dv.reshape(B, Hkv, H // Hkv, Lk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _dtype_code(*ts) -> int:
    code = _DTYPE_CODES.get(ts[0].dtype)
    if code is None or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"flash kernels take one of {list(_DTYPE_CODES)} for "
                        f"all inputs alike, got {[t.dtype for t in ts]}")
    return code


def _aligned(t, code: int) -> bool:
    """The kernels' layout: a contiguous head_dim and, for the 16-bit
    bodies (which copy rows in 16-byte chunks, by TMA at D 64 and 128),
    16-byte aligned data and batch/head/row strides that are nonzero
    multiples of 8."""
    if t.stride(3) != 1:
        return False
    return not code or not (
        t.data_ptr() % 16
        or any(t.stride(i) % 8 or not t.stride(i)
               for i in range(3) if t.shape[i] > 1))


def _check_launch(q, k, v, *outs) -> int:
    """The kernels' checks on ``[B, H, L, D]``-indexed q and ``[B, Hkv, Lk,
    D]``-indexed k/v (and the other operands); returns the dtype code."""
    B, H, L, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    code = _dtype_code(q, k, v, *outs)
    if D not in HEAD_DIMS or k.shape[3] != D or v.shape[3] != D:
        raise ValueError(f"flash kernel head_dim must be one of {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match, with batch {B}")
    if min(L, Lk) < 1 or B * H > 65535:
        raise ValueError(f"flash kernel needs L, Lk >= 1 and B*H <= 65535 "
                         f"(B={B}, H={H}, L={L}, Lk={Lk})")
    for t in (q, k, v, *outs):
        if not _aligned(t, code):
            if t.stride(3) != 1:
                raise ValueError("flash kernel needs a contiguous head_dim")
            raise ValueError(
                "flash kernel needs 16-byte aligned bf16/fp16 rows (data "
                "and batch/head/row strides nonzero multiples of 8)")
    return code


def _strides(*ts):
    vals = [t.stride(i) for t in ts for i in (0, 1, 2)]
    return ctypes.cast((ctypes.c_int64 * len(vals))(*vals), ctypes.c_void_p)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, o, lse, scale: float, causal: bool, window) -> None:
    """Launch the forward kernel over ``[B, H, L, D]``-indexed views (any
    batch, head and row strides; the last dim contiguous) into ``o`` and
    the contiguous ``[B, H, L]`` f32 ``lse``."""
    B, H, L, D = q.shape
    code = _check_launch(q, k, v, o)
    strides = _strides(q, k, v, o)
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), code, B, H, k.shape[1],
                        L, k.shape[2], D, strides, float(scale), int(causal),
                        0 if window is None else int(window), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: {_ERRORS} {err}")
    count_launch("flash_fwd")


def _bwd_operands(q, o, lse, do):
    """``do`` and ``o`` in the kernels' layout, ``lse`` as a contiguous
    ``[B, H, L]`` f32, and an empty ``[B, H, L]`` f32 buffer for ``delta =
    rowsum(do * o)``, which the dq kernel computes and the dk/dv kernel
    reads."""
    B, H, L, _ = q.shape
    code = _dtype_code(q, do, o)
    # autograd may hand in an expanded (stride 0) or strided gradient
    do, o = (t if _aligned(t, code) else t.contiguous() for t in (do, o))
    delta = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    return do, o, lse.reshape(B, H, L).contiguous(), delta


@dataclasses.dataclass(frozen=True)
class DqPlan:
    """How the dq kernel covers a problem: its ``body`` (``wgmma``,
    ``mma`` or ``fma``), the q rows a block owns (``block_rows``), the keys
    of each tile it streams (``block_keys``), and the launch ``grid`` ``(B
    * H, q tiles)``: one block per (batch and head, q tile), each visiting
    its tile's keys once, so dq needs no second pass."""

    body: str
    block_rows: int
    block_keys: int
    grid: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _k_span(q_lo: int, block_rows: int, Lk: int, causal: bool, window):
    """The keys ``[begin, end)`` the forward visits for the q tile starting
    at ``q_lo`` (the kernels' rule, ``_window_span_k``)."""
    begin = max(0, q_lo - window + 1) if window else 0
    end = min(Lk, q_lo + block_rows) if causal else Lk
    return begin, end


def _dq_plan(B: int, H: int, L: int, D: int,
             dtype=torch.bfloat16) -> DqPlan:
    """The dq kernel's body, tiles and grid for a shape; shape only, never
    a failure.  The wgmma body (16-bit, D 64 and 128) owns 128 q rows a
    block and streams 128-key tiles; the mma (16-bit, D 16 and 32) and fma
    (f32) bodies own 64 rows and stream 64 keys.  The grid's second axis
    runs from the last q tile down, so the heaviest tiles of every (batch,
    head) launch first and the short ones fill the tail.  The plan never
    splits a q tile's keys over blocks: at B1 H32 L509, 128 blocks for
    132 SMs, a split's f32 partials and their sum would cost more than the
    SMs left idle, and without it dq is written once, with no atomics."""
    if dtype == torch.float32:
        body, bq, bk = "fma", 64, 64
    elif D < 64:
        body, bq, bk = "mma", 64, 64
    else:
        body, bq, bk = "wgmma", 128, 128
    return DqPlan(body, bq, bk, (B * H, -(-L // bq)))


def _dq_block_tiles(plan: DqPlan, q_tile: int, Lk: int, causal: bool,
                    window):
    """The first keys of the key tiles the block for q tile ``q_tile``
    (rows from ``q_tile * block_rows``) visits, in the kernel's order."""
    begin, end = _k_span(q_tile * plan.block_rows, plan.block_rows, Lk,
                         causal, window)
    return list(range(begin, end, plan.block_keys))


@dataclasses.dataclass(frozen=True)
class DkvPlan:
    """How the dk/dv kernel covers a problem: its ``body`` (``wgmma``,
    ``mma`` or ``fma``), the keys a block owns (``block_keys``), the q rows
    it streams at a time (``q_tile``), into how many chunks each block's
    (query head, q tile) list is split (``nsplit``; above 1 each chunk
    writes an f32 partial that the wrapper sums), and the launch ``grid``
    ``(key tiles, B * Hkv, nsplit)``."""

    body: str
    block_keys: int
    q_tile: int
    nsplit: int
    grid: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _q_span(k_lo: int, block_keys: int, L: int, causal: bool, window):
    """The query rows ``[begin, end)`` that can see a key of the tile
    starting at ``k_lo`` (the kernel's rule, ``_window_span_q``)."""
    begin = k_lo if causal else 0
    end = min(L, k_lo + block_keys - 1 + window) if window else L
    return begin, end


def _dkv_plan(B: int, H: int, Hkv: int, L: int, Lk: int, D: int,
              causal: bool, window=None, dtype=torch.bfloat16,
              sms: int = N_SMS) -> DkvPlan:
    """The dk/dv kernel's body, tiles and grid for a shape; shape only,
    never a failure.  The wgmma body (16-bit, D 64 and 128) owns 128 keys
    a block.  When ``B * Hkv * ceil(Lk / 128)`` blocks would not fill the
    ``sms`` SMs, each block's group list is split: into one chunk per
    query head of the group, and into ``r`` chunks per head when that is
    still too few, never more chunks than the busiest key tile has items."""
    if dtype == torch.float32:
        body, bk, bq = "fma", 64, 64
    elif D < 64:
        body, bk, bq = "mma", 64, 64
    else:
        body, bk, bq = "wgmma", 128, 64
    tiles = -(-Lk // bk)
    base = B * Hkv * tiles
    G = H // Hkv
    nsplit = 1
    if body == "wgmma" and base < sms:
        nsplit = G if base * G >= sms else G * -(-sms // (base * G))
        begin, end = _q_span(0, bk, L, causal, window)
        most = G * max(0, -(-(end - begin) // bq))
        nsplit = max(1, min(nsplit, most))
    return DkvPlan(body, bk, bq, nsplit, (tiles, B * Hkv, nsplit))


def _dkv_block_items(plan: DkvPlan, key_tile: int, chunk: int, H: int,
                     Hkv: int, L: int, causal: bool, window):
    """The (query head within the group, first q row) items the block
    ``(key_tile, *, chunk)`` walks, in the kernel's order."""
    begin, end = _q_span(key_tile * plan.block_keys, plan.block_keys, L,
                         causal, window)
    nqt = -(-(end - begin) // plan.q_tile) if end > begin else 0
    total = (H // Hkv) * nqt
    lo = chunk * total // plan.nsplit
    hi = (chunk + 1) * total // plan.nsplit
    return [(it // nqt, begin + (it % nqt) * plan.q_tile)
            for it in range(lo, hi)]


def _launch_bwd(name: str, q, k, v, do, lse, delta, outs, scale: float,
                causal: bool, window, nsplit: int = 1, o=None) -> None:
    """Launch the backward kernel ``name``: ``bwd_dq`` (which also takes
    ``o`` and writes ``delta``) into ``outs = (dq,)``, ``bwd_dkv`` (which
    reads ``delta``) into ``(dk, dv)``, or with ``nsplit`` > 1 into the two
    f32 ``[B, Hkv * nsplit, Lk, D]`` partials."""
    B, H, L, D = q.shape
    ins = (q, k, v, do, o) if name == "bwd_dq" else (q, k, v, do)
    code = _check_launch(*ins, *(outs if nsplit == 1 else ()))
    extra = (nsplit,) if name == "bwd_dkv" else ()
    with torch.cuda.device(q.device):
        err = _kernel(name)(
            *(t.data_ptr() for t in (*ins, lse, delta, *outs)), code,
            B, H, k.shape[1], L, k.shape[2], D,
            _strides(q, k, v, do, *outs, *ins[4:]), float(scale),
            int(causal), 0 if window is None else int(window), *extra,
            _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_{name} kernel launch failed: {_ERRORS} "
                           f"{err}")
    count_launch("flash_" + name)


def _launch_dkv(q, k, v, do, lse, delta, dk, dv, scale: float, causal: bool,
                window) -> None:
    """The dk/dv kernel by its plan: straight into ``dk``/``dv``, or into
    f32 partials summed over each block's chunks in a fixed order (no
    atomics, so the result does not change from run to run)."""
    B, H, L, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    plan = _dkv_plan(B, H, Hkv, L, Lk, D, causal, window, q.dtype)
    if plan.nsplit == 1:
        _launch_bwd("bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale,
                    causal, window)
        return
    part = torch.empty((2, B, Hkv * plan.nsplit, Lk, D), dtype=torch.float32,
                       device=q.device)
    _launch_bwd("bwd_dkv", q, k, v, do, lse, delta, (part[0], part[1]),
                scale, causal, window, plan.nsplit)
    total = _dkv_group_sum(part, Hkv, plan.nsplit)
    dk.copy_(total[0])
    dv.copy_(total[1])


def _dkv_group_sum(part, Hkv: int, nsplit: int):
    """The second pass of the split path: ``part`` ``[..., B, Hkv * nsplit,
    Lk, D]`` f32 partials (chunk z of kv head hk at head hk * nsplit + z)
    summed over z, one torch reduction in a fixed order."""
    *lead, B, _, Lk, D = part.shape
    return part.view(*lead, B, Hkv, nsplit, Lk, D).sum(-3)


def flash_bwd(q, k, v, o, lse, do, scale: float, causal: bool = True,
              window=None):
    """Counterpart of the reference's ``_flash_bwd``: ``q``, ``o``, ``do``
    ``[B, H, L, D]``, ``k``/``v`` ``[B, Hkv, Lk, D]``, ``lse`` the
    forward's ``[B, H, L(, 1)]`` f32.  Returns ``(dq [B, H, L, D], dk, dv
    [B, Hkv, Lk, D])`` in the input types, each laid out like its input.
    CUDA tensors launch the dq kernel (which also computes ``delta``),
    then the dk/dv kernel."""
    _check_window(causal, window)
    _check_heads(q.shape[1], k.shape[1])
    if use_plain(q, k, v, o, lse, do):
        return flash_bwd_plain(q, k, v, o, lse, do, scale, causal, window)
    do, o, lse, delta = _bwd_operands(q, o, lse, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch_bwd("bwd_dq", q, k, v, do, lse, delta, (dq,), scale, causal,
                window, o=o)
    _launch_dkv(q, k, v, do, lse, delta, dk, dv, scale, causal, window)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Flash attention over ``[B, H, L, D]``-indexed views with the
    backward kernels as its gradient.  ``blhd``: allocate o in the
    ``[B, L, H, D]`` memory layout (the public wrapper's)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, blhd):
        if use_plain(q, k, v):
            o, lse = flash_fwd_plain(q, k, v, scale, causal, window)
            lse = lse[..., 0]
        else:
            B, H, L, D = q.shape
            o = torch.empty((B, L, H, D) if blhd else (B, H, L, D),
                            dtype=q.dtype, device=q.device)
            if blhd:
                o = o.transpose(1, 2)
            lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
            _launch(q, k, v, o, lse, scale, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_fwd(q, k, v, scale: float | None = None, causal: bool = True,
              window=None):
    """Counterpart of the reference's ``_flash_fwd``: ``q`` ``[B, H, L,
    D]``, ``k``/``v`` ``[B, Hkv, Lk, D]``; returns ``(o [B, H, L, D] in
    q.dtype, lse [B, H, L, 1] f32)``.  Differentiable in q, k and v."""
    _check_window(causal, window)
    _check_heads(q.shape[1], k.shape[1])
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"causal=True requires L == Lk (got L={q.shape[2]}, "
                         f"Lk={k.shape[2]})")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, lse = _Flash.apply(q, k, v, scale, causal, window, False)
    return o, lse[..., None]


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None):
    """Fused attention.  q: ``[B, L, H, D]``; k, v: ``[B, Lk, Hkv, D]``
    with Hkv dividing H (grouped-query).  Returns ``[B, L, H, D]`` in
    q.dtype; differentiable in q, k and v.

    ``window`` (sliding-window attention): each query attends only the
    ``window`` most recent positions including itself (0 <= q_pos - k_pos
    < window); causal only.  The kernels visit only the tiles a q tile (or
    a k tile) can see, so compute drops from O(L^2) to O(L * window).
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
    o, _ = _Flash.apply(qt, kt, vt, scale, causal, window, True)
    return o.transpose(1, 2)
