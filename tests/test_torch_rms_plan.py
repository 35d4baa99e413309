"""The RMSNorm kernel's plan and launch path
(k8s_tpu_torch/ops/fused_norm.py), on the CPU.

``_rms_plan`` decides from the shape, the types and the layout which of
``csrc/rms_norm.cu``'s three bodies covers a problem, with what grid,
threads and vector width.  The tests hold its choice at every shape the
card is checked at (chip_smoke.py ``rms_cases``), plus a row stride and a
pointer that break the 16-byte vectors; that the launch hands the C entry
its operands in the order it reads them, with a Python model of each
body's walk over the rows standing in for the kernel; that the wrapper
builds no autograd node when no gradient is wanted and gives the JAX
reference's values (Pallas in interpret mode) either way; and its
gradients against ``jax.vjp`` of the reference.  The kernel itself is held
against the plain version on the card by chip_smoke.py.  Inputs are made
with numpy from a seed.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops import rms_norm as jax_rms_norm
from k8s_tpu_torch.ops import _common
from k8s_tpu_torch.ops import fused_norm
from k8s_tpu_torch.ops.fused_norm import (
    MAX_CTAS_PER_SM,
    MAX_THREADS,
    N_SMS,
    SCALAR_HOLDS,
    STREAM_MIN_ROWS,
    _max_threads,
    _rms_plan,
    rms_norm,
    rms_norm_plain,
)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# (name, N, D, x dtype, scale dtype, row stride, pointer offset in bytes,
# body): chip_smoke.py's rms_cases, its two strided views, and pointers
# off 16-byte boundaries
PLAN_CASES = [
    ("main_prefill", 509, 4096, BF16, F32, 4096, 0, "stream"),
    ("main_decode", 1, 4096, BF16, F32, 4096, 0, "row"),
    ("engine_decode_4", 4, 4096, BF16, F32, 4096, 0, "row"),
    ("engine_spec_16", 16, 4096, BF16, F32, 4096, 0, "row"),
    ("main_17", 17, 4096, BF16, F32, 4096, 0, "row"),
    ("main_64", 64, 4096, BF16, F32, 4096, 0, "row"),
    ("main_128", 128, 4096, BF16, F32, 4096, 0, "row"),
    ("bf16x_f32s", 2048, 4096, BF16, F32, 4096, 0, "stream"),
    ("bf16x_bf16s", 2048, 4096, BF16, BF16, 4096, 0, "stream"),
    ("ragged_rows", 1000, 4096, BF16, F32, 4096, 0, "stream"),
    ("small_f32", 7, 64, F32, F32, 64, 0, "row"),
    ("ragged_d_f16", 5, 100, F16, F32, 100, 0, "row"),
    ("strided_4104", 64, 4096, BF16, F32, 4104, 0, "row"),
    ("strided_4100", 64, 4096, BF16, F32, 4100, 0, "row"),
    ("ragged_d_99_f16", 5, 99, F16, F32, 99, 0, "scalar"),
    ("wide_d_4099_f32", 2, 4099, F32, F32, 4099, 0, "scalar"),
    ("wide_d_8195_f32", 2, 8195, F32, F32, 8195, 0, "scalar"),
    ("offset_2_bytes", 509, 4096, BF16, F32, 4096, 2, "scalar"),
    # 8-byte accesses of x fit; the ring's bulk copies need 16 bytes
    ("offset_8_bytes_many_rows", 509, 4096, BF16, F32, 4096, 8, "row"),
    ("strided_4100_many_rows", 509, 4096, BF16, F32, 4100, 0, "row"),
    ("offset_8_bytes_bf16_scale", 64, 4096, BF16, BF16, 4096, 8, "scalar"),
    ("f32x_stream", 2048, 4096, F32, F32, 4096, 0, "stream"),
    ("gpt2_width_stream", 8192, 768, BF16, F32, 768, 0, "stream"),
    ("llama_70b_width_stream", 2048, 8192, BF16, F32, 8192, 0, "stream"),
    ("wide_16384_row", 3, 16384, BF16, F32, 16384, 0, "row"),
    ("too_wide_for_vectors", 3, 65536, F32, F32, 65536, 0, "scalar"),
]


@pytest.mark.parametrize("name,N,D,xd,sd,stride,offset,body", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_body_grid_and_cover(name, N, D, xd, sd, stride, offset, body):
    plan = _rms_plan(N, D, xd, sd, offset, stride)
    assert plan.body == body
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    # every element of a row has a thread (the scalar body: in one pass,
    # or in two passes of 1024 threads past 8192 elements)
    per_thread = plan.nv * plan.vec
    assert plan.threads * per_thread >= D or (
        body == "scalar" and plan.threads == MAX_THREADS)
    if body == "scalar":
        assert plan.vec == 1 and plan.grid == N and plan.stages == 0
        # the fewest elements a thread that fit the row in 1024 threads
        # (the most a thread holds past 8192), so as many threads as fit
        hold = plan.nv
        assert hold in SCALAR_HOLDS
        assert D <= hold * MAX_THREADS or hold == SCALAR_HOLDS[-1]
        assert hold == SCALAR_HOLDS[0] or D > hold // 2 * MAX_THREADS
        need = -(-D // hold)
        assert plan.threads == min(MAX_THREADS, -(-need // 32) * 32)
        return
    # and no warp is idle
    assert plan.threads < -(-D // per_thread) + 32
    # 16 bytes of the wider type an access, each aligned to its size
    assert plan.vec == 16 // max(xd.itemsize, sd.itemsize)
    assert D % plan.vec == 0 and stride % plan.vec == 0
    assert offset % (plan.vec * xd.itemsize) == 0
    assert plan.threads <= _max_threads(plan.nv, plan.vec)
    if body == "row":
        assert plan.grid == N and plan.stages == 0 and plan.smem == 0
    else:
        assert N >= STREAM_MIN_ROWS and offset == 0
        assert D * xd.itemsize % 16 == 0 and stride * xd.itemsize % 16 == 0
        per_sm = min(MAX_CTAS_PER_SM, MAX_THREADS // plan.threads)
        assert plan.grid == min(N, per_sm * N_SMS)
        # every block of the persistent grid is resident at once
        assert plan.grid * plan.threads <= MAX_THREADS * N_SMS
        assert 2 <= plan.stages <= 4
        assert plan.smem == plan.stages * D * xd.itemsize <= 40 * 1024


def test_plan_threads_at_llama_width():
    # a decode row in bf16 with an f32 scale: 1024 threads, each 4 elements
    # (8 bytes of x, 16 of the scale and of the f32 output)
    plan = _rms_plan(1, 4096, BF16, F32)
    assert (plan.body, plan.threads, plan.vec, plan.nv) == ("row", 1024, 4, 1)
    # the served prefill: 256 threads of 16 elements, 4 blocks an SM, all
    # 509 rows resident at once, a 4-row ring
    plan = _rms_plan(509, 4096, BF16, F32)
    assert (plan.body, plan.grid, plan.threads, plan.nv, plan.stages) == (
        "stream", 509, 256, 4, 4)
    plan = _rms_plan(2048, 4096, BF16, BF16)
    assert (plan.grid, plan.threads, plan.vec, plan.nv) == (
        4 * N_SMS, 128, 8, 4)


# (D, threads, elements a thread holds) of the scalar body (f16 x, f32
# scale, a row stride that breaks the vectors)
SCALAR_SHAPES = [(99, 128, 1), (1000, 1024, 1), (1030, 544, 2),
                 (4099, 544, 8), (8195, 1024, 8), (65537, 1024, 8)]


@pytest.mark.parametrize("D,threads,hold", SCALAR_SHAPES,
                         ids=[f"D{c[0]}" for c in SCALAR_SHAPES])
def test_scalar_plan_gives_a_row_the_most_threads(D, threads, hold):
    plan = _rms_plan(5, D, F16, F32, 0, D + 1 if D % 2 == 0 else D)
    assert plan.body == "scalar"
    assert (plan.threads, plan.nv) == (threads, hold)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="rms_norm kernel takes"):
        _rms_plan(4, 64, torch.float64, F32)
    with pytest.raises(ValueError, match="N, D >= 1"):
        _rms_plan(0, 64, BF16, F32)
    # a misaligned scale breaks the vectors too
    assert _rms_plan(4, 64, BF16, F32, 0, 64, 4).body == "scalar"


# -- the launch, with a model of each body's walk in place of the kernel ----

_CTYPES = {F32: ctypes.c_float, BF16: ctypes.c_uint16, F16: ctypes.c_uint16}


def _view(ptr: int, count: int, dtype):
    """``count`` elements of ``dtype`` at host address ``ptr``, writable."""
    raw = torch.from_numpy(np.frombuffer(
        (_CTYPES[dtype] * count).from_address(ptr), dtype=np.dtype(
            np.float32 if dtype == F32 else np.uint16)))
    return raw if dtype == F32 else raw.view(dtype)


class _FakeEntry:
    """Stands in for ``k8s_rms_norm``: reads the operands through the
    pointers, strides and plan it is handed, walks the rows the way the
    chosen body's blocks do, and writes each row with the kernel's
    arithmetic (f32 sum divided by D, ``1 / sqrt`` correctly rounded)."""

    def __init__(self):
        self.calls, self.rows = [], []

    def __call__(self, xp, sp, op, args, stream):
        a = fused_norm._RmsArgs.from_address(args)
        body, N, D, stride, grid, eps = (a.body, a.N, a.D, a.stride_x,
                                         a.grid, a.eps)
        xc, sc = a.x_dtype, a.s_dtype
        self.calls.append((body, N, D, stride, grid, a.threads, a.nv,
                           a.stages))
        codes = {v: k for k, v in fused_norm._DTYPE_CODES.items()}
        xd, sd = codes[xc], codes[sc]
        od = torch.promote_types(xd, sd)
        xs = _view(xp, (N - 1) * stride + D, xd)
        s = _view(sp, D, sd).float()
        out = _view(op, N * D, od)
        walk = ([range(b, N, grid) for b in range(grid)] if body == 1
                else [[b] for b in range(grid)])
        for rows in walk:
            for i in rows:
                self.rows.append(i)
                x = xs[i * stride:i * stride + D].float()
                r = 1.0 / torch.sqrt(x.square().sum() / D
                                     + torch.tensor(eps, dtype=F32))
                y = (x * r).to(xd).float() * s
                out[i * D:(i + 1) * D] = y.to(od)
        return 0


@pytest.fixture
def fake_entry(monkeypatch):
    fake = _FakeEntry()
    monkeypatch.setitem(fused_norm._fns, "rms_norm", fake)
    monkeypatch.setattr(fused_norm, "_get_device", lambda: -1)
    monkeypatch.setattr(fused_norm, "_raw_stream", lambda dev: 0)
    monkeypatch.setattr(_common, "LAUNCHES", {})
    return fake


def _x(seed, shape, dtype):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def _scale(seed, D, dtype):
    return torch.from_numpy((1.0 + 0.1 * np.random.RandomState(seed)
                             .standard_normal(D)).astype(np.float32)).to(dtype)


def _close(got, want, xd):
    # one rounding step of x.dtype (an r one ulp apart can round the
    # normalized value the other way), plus one of a 16-bit output
    rtol = 1e-5 if xd == F32 else torch.finfo(xd).eps + (
        torch.finfo(got.dtype).eps if got.dtype != F32 else 0.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 1e-6 + rtol * want.float().abs()).all()), \
        diff.max().item()


# (name, x maker, scale dtype, body): contiguous 3-D, a strided view whose
# stride keeps the vectors (stream body), one that breaks them, a pointer
# two bytes off, and a last dim that is not contiguous (copied)
LAUNCH_CASES = [
    ("contiguous_3d", lambda: _x(0, (2, 3, 64), BF16), F32, "row"),
    ("f32_same_scale", lambda: _x(1, (5, 32), F32), F32, "row"),
    ("bf16_same_scale", lambda: _x(2, (4, 64), BF16), BF16, "row"),
    ("strided_stream", lambda: _x(3, (300, 72), BF16)[:, :64], F32,
     "stream"),
    ("strided_8_byte_rows", lambda: _x(4, (20, 68), BF16)[:, :64], F32,
     "row"),
    ("strided_scalar", lambda: _x(4, (20, 66), BF16)[:, :64], F32,
     "scalar"),
    ("offset_2_bytes", lambda: _x(5, (6 * 64 + 1,), BF16)[1:].view(6, 64),
     F32, "scalar"),
    ("ragged_d_f16", lambda: _x(6, (5, 100), F16), F32, "row"),
    ("ragged_d_99_f16", lambda: _x(6, (5, 99), F16), F32, "scalar"),
    ("wide_scalar", lambda: _x(8, (2, 4099), F32), F32, "scalar"),
    ("transposed", lambda: _x(7, (64, 8), BF16).t(), F32, "row"),
]


@pytest.mark.parametrize("name,make,sd,body", LAUNCH_CASES,
                         ids=[c[0] for c in LAUNCH_CASES])
def test_launch_hands_the_entry_its_operands(fake_entry, name, make, sd,
                                             body):
    x = make()
    D = x.shape[-1]
    s = _scale(9, D, sd)
    out = fused_norm._rms_norm_kernel(x, s, 1e-6)
    (code, N, D_seen, stride, grid, threads, nv, stages), = fake_entry.calls
    assert code == fused_norm._BODY_CODES[body] and D_seen == D
    plan = fused_norm._rms_plan(N, D, x.dtype, sd, x.data_ptr() % 16,
                                stride, s.data_ptr() % 16)
    assert (grid, threads, nv, stages) == (plan.grid, plan.threads, plan.nv,
                                           plan.stages)
    assert N == x.numel() // D
    if x.stride(-1) == 1 and x.dim() == 2:
        assert stride == x.stride(0)  # strided rows are read in place
    # the walk covers every row exactly once
    assert sorted(fake_entry.rows) == list(range(N))
    assert out.is_contiguous() and out.shape == x.shape
    _close(out, rms_norm_plain(x, s), x.dtype)
    assert _common.LAUNCHES == {"rms_norm": 1}


def test_launch_refuses_other_types(fake_entry):
    with pytest.raises(TypeError, match="rms_norm kernel takes"):
        fused_norm._rms_norm_kernel(torch.zeros(2, 8, dtype=torch.float64),
                                    torch.zeros(8), 1e-6)
    with pytest.raises(TypeError, match="rms_norm kernel takes"):
        fused_norm._rms_norm_kernel(torch.zeros(2, 8),
                                    torch.zeros(8, dtype=torch.int32), 1e-6)
    assert not fake_entry.calls and _common.LAUNCHES == {}


def test_launch_failure_raises(fake_entry, monkeypatch):
    monkeypatch.setitem(fused_norm._fns, "rms_norm", lambda *a: 9)
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        fused_norm._rms_norm_kernel(torch.zeros(2, 64), torch.ones(64), 1e-6)
    assert _common.LAUNCHES == {}


def test_empty_rows_launch_nothing(fake_entry):
    out = fused_norm._rms_norm_kernel(torch.zeros(0, 64, dtype=BF16),
                                      torch.ones(64), 1e-6)
    assert out.shape == (0, 64) and out.dtype == F32
    assert not fake_entry.calls


# -- the public function against the reference --------------------------------

# (x dtype, scale dtype, tolerance kwargs of tests/test_torch_ops.py)
PARITY = [
    (F32, F32, dict(atol=1e-5, rtol=1e-5)),
    (BF16, F32, dict(atol=1e-6)),
    (BF16, BF16, dict(rtol=2 ** -7 + 2 ** -8, atol=1e-6)),
]
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad",
                                  "no_requires_grad"])
@pytest.mark.parametrize("xd,sd,tol", PARITY,
                         ids=["f32", "bf16x_f32s", "bf16x_bf16s"])
def test_no_grad_wanted_builds_no_node(xd, sd, tol, mode):
    x = np.random.RandomState(0).standard_normal((4, 24, 64)).astype(
        np.float32)
    s = (1.0 + 0.1 * np.random.RandomState(1).standard_normal(64)).astype(
        np.float32)
    ref = jax_rms_norm(jnp.asarray(x, _JNP[xd]), jnp.asarray(s, _JNP[sd]))
    xt, st = torch.from_numpy(x).to(xd), torch.from_numpy(s).to(sd)
    ctx = {"inference_mode": torch.inference_mode(),
           "no_grad": torch.no_grad()}.get(mode, contextlib.nullcontext())
    if mode != "no_requires_grad":
        st.requires_grad_(True)
    _common.reset_launches()
    with ctx:
        out = rms_norm(xt, st)
    assert out.grad_fn is None and not out.requires_grad
    assert out.dtype == torch.promote_types(xd, sd)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    assert _common.launches()["rms_norm"] == 0  # CPU tensors: plain version


@pytest.mark.parametrize("xd,sd", [(F32, F32), (BF16, F32)],
                         ids=["f32", "bf16x_f32s"])
@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_grads_match_jax_vjp(xd, sd, eps):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((3, 16, 128)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    g = rng.standard_normal((3, 16, 128)).astype(np.float32)
    xj, sj = jnp.asarray(x, _JNP[xd]), jnp.asarray(s, _JNP[sd])
    out_j, vjp = jax.vjp(lambda a, b: jax_rms_norm(a, b, eps=eps), xj, sj)
    dxj, dsj = vjp(jnp.asarray(g, out_j.dtype))
    xt = torch.from_numpy(x).to(xd).requires_grad_(True)
    st = torch.from_numpy(s).to(sd).requires_grad_(True)
    out = rms_norm(xt, st, eps=eps)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(out.dtype))
    assert xt.grad.dtype == xd and st.grad.dtype == sd
    if xd == F32:
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        # dx is rounded to bf16 once on each side: one bf16 step
        tol = dict(atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(dxj.astype(jnp.float32)), **tol)
    # dscale sums 48 rows in f32 on both sides
    np.testing.assert_allclose(st.grad.float().numpy(),
                               np.asarray(dsj.astype(jnp.float32)),
                               atol=1e-4, rtol=1e-5)
