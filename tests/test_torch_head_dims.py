"""Every head_dim the Pallas flash kernels take, in the port, on the CPU.

The JAX flash kernels (k8s_tpu/ops/flash_attention.py) block over any
head_dim D, and ``TransformerConfig.head_dim`` is a free field, so a model
with flash attention trains and serves there at D 80, 96 or 256.  The port
runs every D too: its plans (``_fwd_plan``, ``_dq_plan``, ``_dkv_plan``)
name a CUDA body and the padded width Dp >= D it runs at, and the generic
body takes what no tiled body does.  These tests hold:

- the port's plain flash forward and backward (what a CPU tensor runs)
  against the Pallas kernels in interpret mode at D 8 to 320, causal,
  windowed, GQA and bidirectional, at the reference's tolerance (2e-5);
- the plans over every D in 1..512 for the three types: a body for each,
  Dp >= D, the padded tensor-core bodies at D 40/80/96 (the forward's own
  Dp 96 at D 72..96, the backward's 128), the Dp-256 bodies at D 136-256
  in 16 bits (64-key tiles), the generic body for a 16-bit
  D not a multiple of 8 and for D > 256, the forward's shared memory
  against what the library reports, and launch grids inside CUDA's limits
  at B*H = 65,544;
- that the wrappers hand the C entry points the padded width, or the
  generic entries a scratch, and copy to contiguous only an operand whose
  layout the chosen body cannot read;
- the port's Transformer at an explicit head_dim (24 and 40) against the
  JAX one through the parameter bridge: logits, one train step's loss and
  gradients, and 8 greedy tokens.

The CUDA bodies themselves are held against the plain versions on the card
by chip_smoke.py.  Inputs are made with numpy from a seed.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import decode as jd
from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.ops.flash_attention import _flash_bwd as jax_flash_bwd
from k8s_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import decode as td
from k8s_tpu_torch.models import train as ttrain
from k8s_tpu_torch.models import transformer as tt
from k8s_tpu_torch.ops import _common
from k8s_tpu_torch.ops import flash_attention as flash
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
TOL = 2e-5        # the reference's flash tolerance (tests/test_ops.py)
MODEL_TOL = 5e-4  # tests/test_torch_train.py's model gradients


def _rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# (B, H, Hkv, L, Lk, D, causal, window): head_dims of public models (80,
# 96, 256) and the paddings and generic cases around them, each with its
# own mask and group: causal GQA 2, a window of 8, bidirectional
# Lk != L, a window of 16 at GQA 4, causal GQA 1, causal GQA 2,
# bidirectional GQA 1.
KERNEL_CASES = [
    (1, 4, 2, 32, 32, 8, True, None),
    (1, 2, 2, 40, 40, 24, True, 8),
    (1, 4, 2, 24, 40, 40, False, None),
    (1, 4, 1, 64, 64, 80, True, 16),
    (1, 2, 2, 48, 48, 96, True, None),
    (1, 4, 2, 32, 32, 256, True, None),
    (1, 2, 2, 16, 24, 320, False, None),
]


@pytest.mark.parametrize("B,H,Hkv,L,Lk,D,causal,window", KERNEL_CASES,
                         ids=[f"d{c[5]}" for c in KERNEL_CASES])
def test_plain_flash_matches_pallas_at_head_dim(B, H, Hkv, L, Lk, D, causal,
                                                window):
    q, do = _rand(0, (B, H, L, D)), _rand(3, (B, H, L, D))
    k, v = _rand(1, (B, Hkv, Lk, D)), _rand(2, (B, Hkv, Lk, D))
    scale = D ** -0.5
    G = H // Hkv
    kr = jnp.repeat(jnp.asarray(k), G, axis=1)
    vr = jnp.repeat(jnp.asarray(v), G, axis=1)
    o_j, lse_j = jax_flash_fwd(jnp.asarray(q), kr, vr, scale, causal, L, Lk,
                               True, window)
    dq_j, dk_j, dv_j = jax_flash_bwd(jnp.asarray(q), kr, vr, o_j, lse_j,
                                     jnp.asarray(do), scale, causal, L, Lk,
                                     True, window)
    # the reference repeats K/V: its dk/dv are per query head
    dk_j = np.asarray(dk_j).reshape(B, Hkv, G, Lk, D).sum(2)
    dv_j = np.asarray(dv_j).reshape(B, Hkv, G, Lk, D).sum(2)

    args = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = flash.flash_fwd_plain(*args, scale, causal, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=TOL)
    got = flash.flash_bwd_plain(*args, o, lse, torch.from_numpy(do), scale,
                                causal, window)
    for g, r in zip(got, (dq_j, dk_j, dv_j)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)


def _plans(D, dtype, B=1, H=4, Hkv=2, L=300):
    return (flash._fwd_plan(B, H, L, D, dtype),
            flash._dq_plan(B, H, L, D, dtype),
            flash._dkv_plan(B, H, Hkv, L, L, D, True, None, dtype))


def _fwd_dp96(D, dtype):
    """Whether the forward runs D at its own Dp-96 body."""
    return dtype != F32 and D % 8 == 0 and 64 < D <= 96


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_every_head_dim_has_a_body(dtype):
    """D 1..512: every plan names a body with Dp >= D, the three kernels
    agree on it (but for the forward's Dp 96 at 16-bit D 72..96, where
    the backward runs Dp 128), and it is the rule's body."""
    bodies = {"fma", "mma", "wgmma", "generic"}
    for D in range(1, 513):
        plans = _plans(D, dtype)
        if _fwd_dp96(D, dtype):
            assert (plans[0].body, plans[0].dp) == ("wgmma", 96)
            plans = plans[1:]
        assert len({(p.body, p.dp) for p in plans}) == 1
        body, dp = plans[0].body, plans[0].dp
        assert body in bodies and dp >= D
        if body == "generic":
            assert dp == D
            assert D > (128 if dtype == F32 else 256) \
                or (dtype != F32 and D % 8)
        elif dtype == F32:
            assert body == "fma" and dp in flash.FMA_WIDTHS
        else:
            assert D % 8 == 0
            widths = flash.MMA_WIDTHS if body == "mma" else \
                flash.WGMMA_WIDTHS
            assert body == ("mma" if D <= 32 else "wgmma")
            assert dp == min(w for w in widths if w >= D)


@pytest.mark.parametrize("dtype", [BF16, F16])
def test_sixteen_bit_bodies_by_head_dim(dtype):
    assert [(p.body, p.dp) for p in _plans(40, dtype)] == [("wgmma", 64)] * 3
    for D in (80, 96):
        fwd, dq, dkv = _plans(D, dtype)
        assert (fwd.body, fwd.dp) == ("wgmma", 96)
        assert {(p.body, p.dp) for p in (dq, dkv)} == {("wgmma", 128)}
    for D in range(136, 257, 8):
        fwd, dq, dkv = _plans(D, dtype)
        assert {(p.body, p.dp) for p in (fwd, dq, dkv)} == {("wgmma", 256)}
        # Dp 256's own tiles: 64-key tiles for K2 (two stages) and K3, 64
        # keys a K4 block
        assert (fwd.block_rows, fwd.block_keys) == (128, 64)
        assert flash.FWD_WGMMA_TILES[fwd.dp] == (64, 2)
        assert (dq.block_rows, dq.block_keys) == (128, 64)
        assert (dkv.block_keys, dkv.q_tile) == (64, 64)
    for D in [d for d in range(1, 513) if d % 8] + [264, 320, 512]:
        assert {p.body for p in _plans(D, dtype)} == {"generic"}


@pytest.mark.parametrize("dtype", [BF16, F16])
def test_fwd_plan_takes_its_own_wgmma_tiles(dtype):
    """The forward's plan, 16-bit D 8..512: Dp 96 (128-key tiles, three
    stages) at D 72..96, Dp 256 with 64-key tiles in two stages at D
    136..256, 128-key tiles in two stages at Dp 64/128, and elsewhere the
    dq plan itself."""
    for D in range(8, 513):
        fwd = flash._fwd_plan(1, 4, 300, D, dtype)
        dq = flash._dq_plan(1, 4, 300, D, dtype)
        assert (fwd.block_rows, fwd.grid) == (dq.block_rows, dq.grid)
        if fwd.body != "wgmma":
            assert fwd == dq
            continue
        want = {96: (128, 3), 256: (64, 2)}.get(fwd.dp, (128, 2))
        assert (fwd.block_keys, flash.FWD_WGMMA_TILES[fwd.dp][1]) == want
        assert fwd.dp == (96 if 64 < D <= 96 else dq.dp)


def _old_rule(D, dtype):
    """The body and Dp every kernel took before the forward had its own
    Dp-96 body."""
    if dtype == F32:
        widths, body = (16, 32, 64, 128), "fma"
    elif D % 8:
        return "generic", D
    else:
        body, widths = ("mma", (16, 32)) if D <= 32 else \
            ("wgmma", (64, 128, 256))
    for w in widths:
        if D <= w:
            return body, w
    return "generic", D


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_backward_plans_unchanged_for_every_head_dim(dtype):
    """D 8..512: the dq and dk/dv plans keep their bodies, widths and
    tiles (Dp 128 at D 72..96; 64-key tiles at Dp 256)."""
    for D in range(8, 513):
        body, dp = _old_rule(D, dtype)
        dq = flash._dq_plan(2, 8, 300, D, dtype)
        dkv = flash._dkv_plan(2, 8, 2, 300, 300, D, True, None, dtype)
        tile = {"wgmma": 64 if dp == 256 else 128,
                "generic": flash.GENERIC_TILE}.get(body, 64)
        assert (dq.body, dq.dp, dq.block_rows, dq.block_keys) == (
            body, dp, flash.GENERIC_TILE if body == "generic" else
            (128 if body == "wgmma" else 64), tile)
        kq = {"wgmma": (64 if dp == 256 else 128, 64),
              "generic": (flash.GENERIC_TILE,) * 2}.get(body, (64, 64))
        assert (dkv.body, dkv.dp, dkv.block_keys, dkv.q_tile) == (
            body, dp, *kq)


def _fake_build(smem):
    """A stand-in for ``ops._build`` whose flash_fwd library reports
    ``smem(dtype, Dp)`` bytes and whose nvcc never ran."""
    import types

    lib = types.SimpleNamespace(k8s_flash_fwd_smem=smem)
    return types.SimpleNamespace(load=lambda name: lib, BUILD_LOGS={})


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_plans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [BF16, F16])
def test_fwd_smem_report_is_held_to_the_plan(dtype):
    """``k8s_flash_fwd_smem`` (csrc/flash_fwd.cu) reports the shared
    memory each wgmma forward body launches with; chip_smoke.py's
    ``build_report`` holds it to ``_fwd_smem(plan)``: Q, the K/V ring of
    the forward's tiles and stages, the mbarriers, inside the 227 KiB a block
    may take.  A library built with other tiles (a Dp-96 body with two
    stages) is refused."""
    cs = _chip_smoke()
    sizes = {64: 83008, 96: 173136, 128: 164928, 256: 197696}
    for D in (64, 96, 128, 256):
        plan = flash._fwd_plan(1, 16, 2048, D, dtype)
        want = flash._fwd_smem(plan)
        assert want == sizes[plan.dp] and want <= 232448
        rep = cs.build_report(_fake_build(lambda code, dp: sizes[dp]),
                              "flash_fwd", dtype, plan, smem_want=want)
        assert (rep["dp"], rep["smem_dynamic_bytes"]) == (plan.dp, want)
    plan = flash._fwd_plan(1, 16, 2048, 96, dtype)
    old = 1024 + 128 * 96 * 2 + 2 * 2 * 128 * 96 * 2 + 64
    with pytest.raises(SystemExit):
        cs.build_report(_fake_build(lambda code, dp: old), "flash_fwd",
                        dtype, plan, smem_want=flash._fwd_smem(plan))


def test_f32_bodies_by_head_dim():
    for D, dp in ((8, 16), (24, 32), (40, 64), (96, 128), (128, 128)):
        assert {(p.body, p.dp) for p in _plans(D, F32)} == {("fma", dp)}
    for D in (129, 160, 256):
        assert {p.body for p in _plans(D, F32)} == {"generic"}


def test_grids_stay_inside_cuda_limits_at_65544_heads():
    """B*H = 65,544 at L 16 (the old grid.y of B*H refused it): the
    forward and dk/dv launches fold (tile, batch and head) into grid.x
    past 65535 heads, and dq has the heads on grid.x; below it, the 2-D
    grids the kernels had."""
    for dtype, D in ((BF16, 64), (BF16, 256), (F32, 64), (BF16, 100)):
        fwd = flash._fwd_plan(2, 32772, 16, D, dtype)
        dq = flash._dq_plan(2, 32772, 16, D, dtype)
        dkv = flash._dkv_plan(2, 32772, 32772, 16, 16, D, True, None, dtype)
        assert dkv.nsplit == 1
        for grid, blocks in ((fwd.fwd_launch, fwd.blocks), (dq.grid, dq.blocks),
                             (dkv.launch, dkv.blocks)):
            x, y, z = (*grid, 1)[:3]
            assert x * y * z == blocks and x >= 65544
            assert x < 2 ** 31 and y <= 65535 and z <= 65535
        # below the limit: (q tiles, B*H) and (key tiles, B*Hkv, nsplit)
        small = flash._fwd_plan(2, 16, 300, D, dtype)
        assert small.fwd_launch == (small.grid[1], 32, 1)
        small = flash._dkv_plan(2, 16, 4, 300, 300, D, True, None, dtype)
        assert small.launch == small.grid


def _bf16(shape, offset=0):
    n = int(np.prod(shape)) + offset
    return torch.zeros(n, dtype=BF16)[offset:].view(shape)


def test_check_launch_refuses_only_types_and_shapes():
    q, k = _bf16((1, 4, 33, 100)), _bf16((1, 2, 33, 100))
    assert flash._check_launch(q, k, k.clone()) == 1  # D 100: generic
    assert flash._check_launch(_bf16((1, 4, 33, 320)), _bf16((1, 2, 33, 320)),
                               _bf16((1, 2, 33, 320))) == 1
    with pytest.raises(TypeError, match="all inputs alike"):
        flash._check_launch(q, k, k.to(F16))
    with pytest.raises(TypeError, match="all inputs alike"):
        flash._check_launch(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="must match"):
        flash._check_launch(q, k, _bf16((1, 2, 34, 100)))
    with pytest.raises(ValueError, match="must match"):
        flash._check_launch(q, _bf16((1, 2, 33, 96)), _bf16((1, 2, 33, 96)))


def _fake_entries(monkeypatch):
    seen = {}

    def fake(name):
        def call(*args):
            seen[name] = args
            return 0
        return call

    for name in ("fwd", "fwd_generic", "bwd_dq", "bwd_dq_generic",
                 "bwd_dkv", "bwd_dkv_generic"):
        monkeypatch.setitem(flash._fns, name, fake(name))
    monkeypatch.setattr(flash.torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(flash, "_stream", lambda t: 0)
    monkeypatch.setattr(_common, "LAUNCHES", {})
    return seen


def _strides_at(ptr, n):
    import ctypes
    return ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int64))[:n]


def test_launch_hands_the_padded_width(monkeypatch):
    """``k8s_flash_fwd(q, k, v, o, lse, dtype, B, H, Hkv, L, Lk, D, strides,
    scale, causal, window, Dp, stream)``: D 96 runs the forward's wgmma
    body at Dp 96 and the backward's at 128; dq and dk/dv take Dp after
    window (dk/dv after nsplit)."""
    seen = _fake_entries(monkeypatch)
    q, k, v = _bf16((1, 4, 33, 96)), _bf16((1, 2, 33, 96)), \
        _bf16((1, 2, 33, 96))
    o, lse = torch.empty_like(q), torch.zeros(1, 4, 33)
    flash._launch(q, k, v, o, lse, 0.125, True, None)
    args = seen["fwd"]
    assert args[5:12] == (1, 1, 4, 2, 33, 33, 96)
    assert args[13:] == (0.125, 1, 0, 96, 0)
    delta = torch.zeros(1, 4, 33)
    flash._launch_bwd("bwd_dq", flash._dq_plan(1, 4, 33, 96, BF16), q, k, v,
                      q.clone(), lse, delta, (torch.empty_like(q),), 0.125,
                      True, 5, o=o)
    assert seen["bwd_dq"][16:] == (0.125, 1, 5, 128, 0)
    flash._launch_dkv(q, k, v, q.clone(), lse, delta, torch.empty_like(k),
                      torch.empty_like(v), 0.125, True, None)
    nsplit = flash._dkv_plan(1, 4, 2, 33, 33, 96, True).nsplit
    assert seen["bwd_dkv"][16:] == (0.125, 1, 0, nsplit, 128, 0)
    assert _common.launches()["flash_fwd"] == 1
    assert _common.launches()["flash_bwd_dkv"] == 1


# (layout, D, body, the operand copied): the 16-bit tiled body reads
# contiguous, aligned rows only; the generic body reads any row strides and
# needs only a contiguous head_dim.
LAYOUT_CASES = [
    ("expanded_k", 64, "wgmma", "k"),
    ("misaligned_q", 64, "wgmma", "q"),
    ("strided_head_dim", 64, "wgmma", "q"),
    ("aligned", 100, "generic", None),
    ("expanded_k", 100, "generic", None),
    ("misaligned_q", 100, "generic", None),
    ("strided_head_dim", 100, "generic", "q"),
]


@pytest.mark.parametrize("layout,D,body,copied", LAYOUT_CASES,
                         ids=[f"{c[0]}_d{c[1]}" for c in LAYOUT_CASES])
def test_launch_copies_only_what_its_body_cannot_read(monkeypatch, layout, D,
                                                      body, copied):
    """The layout never picks the body: D and the type do.  An operand the
    body cannot read in place reaches every kernel as a contiguous copy;
    the tiled entries take the padded width last, the generic entries a
    scratch, and both the same (batch, head, row) strides."""
    seen = _fake_entries(monkeypatch)
    monkeypatch.setattr(flash, "use_plain", lambda *ts: False)
    ops = {"q": _bf16((1, 4, 33, D)), "k": _bf16((1, 2, 33, D)),
           "v": _bf16((1, 2, 33, D))}
    if layout == "expanded_k":
        ops["k"] = _bf16((1, 2, 1, D)).expand(1, 2, 33, D)
    elif layout == "misaligned_q":
        ops["q"] = _bf16((1, 4, 33, D), offset=1)
    elif layout == "strided_head_dim":
        ops["q"] = _bf16((1, 4, 33, 2 * D))[..., ::2]
    q, k, v = ops["q"], ops["k"], ops["v"]
    assert flash._fwd_plan(1, 4, 33, D, BF16).body == body
    o, lse = flash.flash_fwd(q, k, v, 0.125)
    flash.flash_bwd(q, k, v, o, lse, torch.zeros_like(o), 0.125)
    suffix = "" if body == "wgmma" else "_generic"
    names = [n + suffix for n in ("fwd", "bwd_dq", "bwd_dkv")]
    assert set(seen) == set(names)
    for name in names:
        args = seen[name]
        for i, t in enumerate((q, k, v)):
            assert (args[i] == t.data_ptr()) == ("qkv"[i] != copied), name
        n_ptrs = 5 if name.startswith("fwd") else 8
        assert args[n_ptrs:n_ptrs + 7] == (1, 1, 4, 2, 33, 33, D)
        n_strides = 12 if name.startswith("fwd") else 18
        strides = _strides_at(args[n_ptrs + 7], n_strides)
        if copied:
            j = "qkv".index(copied)
            assert strides[3 * j:3 * j + 3] == [
                (4 if copied == "q" else 2) * 33 * D, 33 * D, D]
        assert args[n_ptrs + 8:n_ptrs + 11] == (0.125, 1, 0)
        last = args[-2]  # the padded width, or the scratch's address
        assert last == 64 if body == "wgmma" else last not in (0, D)


# -- the model at an explicit head_dim ----------------------------------------


def _model_pair(head_dim):
    kw = dict(hidden=64, heads=4, kv_heads=2, head_dim=head_dim,
              use_flash_attention=True, use_fused_norm=True)
    cj = dataclasses.replace(jt.tiny_test(), **kw)
    ct = dataclasses.replace(tt.tiny_test(), **kw)
    params = jt.Transformer(cj).init(jax.random.PRNGKey(7),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    return cj, ct, params, bridge.params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module", params=[24, 40], ids=["hd24", "hd40"])
def model_pair(request):
    return _model_pair(request.param)


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def test_model_logits_match_reference_at_head_dim(model_pair):
    cj, ct, params, sd = model_pair
    model = tt.Transformer(ct, sd, device="cpu")
    assert model.layers[0].attn.q_proj.weight.shape == \
        (ct.heads * ct.head_dim, ct.hidden)
    tokens = _tokens((2, 13), 1)
    ref = jt.Transformer(cj).apply({"params": params}, jnp.asarray(tokens))
    np.testing.assert_allclose(model(_t(tokens)).numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def test_model_train_step_matches_reference_at_head_dim(model_pair):
    cj, ct, params, sd = model_pair
    model = tt.Transformer(ct, sd, device="cpu", trainable=True)
    tokens = _tokens((2, 16), 3)
    jm = jt.Transformer(cj)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jtrain.lm_loss(jm.apply({"params": p}, tokens), tokens))(
            params)
    loss = ttrain.lm_loss(model(_t(tokens)), _t(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = bridge.params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, ct)
    flat_r = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert [p for p, _ in flat_r] == [p for p, _ in flat_g]
    for (path, r), (_, g) in zip(flat_r, flat_g):
        np.testing.assert_allclose(g, np.asarray(r), atol=MODEL_TOL,
                                   rtol=MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_model_greedy_tokens_match_reference_at_head_dim(model_pair):
    cj, ct, params, sd = model_pair
    prompt = _tokens((1, 9), 5)
    ref = np.asarray(jd.generate(cj, params, prompt, 8))
    out = td.generate(ct, sd, prompt, 8, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
