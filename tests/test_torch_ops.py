"""The port's kernel layer (k8s_tpu_torch/ops) against the JAX Pallas
kernels on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_ops.py runs
them; the port's wrappers take their plain PyTorch versions because the
tensors lie on the CPU.  The hand-written CUDA and Triton kernels
themselves are held against those plain versions on the card by
chip_smoke.py.  Inputs are made with numpy from a seed and fed to both.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops import flash_attention as jax_flash_attention
from k8s_tpu.ops import rms_norm as jax_rms_norm
from k8s_tpu.ops._common import pick_block as jax_pick_block
from k8s_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from k8s_tpu_torch.ops import _build, _common
from k8s_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_fwd,
    flash_fwd_plain,
)
from k8s_tpu_torch.ops.fused_norm import rms_norm, rms_norm_plain
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

ATOL = RTOL = 2e-5  # the reference's flash tolerance (tests/test_ops.py)


def _rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# (B, H, Hkv, L, Lk, D, causal, window, block): blocks are divisors the
# Pallas kernel can take without degenerating to 1-row blocks
FLASH_CASES = [
    (1, 2, 2, 13, 13, 16, True, None, 13),
    (1, 2, 2, 37, 37, 16, True, None, 37),
    (2, 2, 2, 64, 64, 32, True, None, 16),
    (2, 2, 2, 64, 64, 32, False, None, 16),
    (1, 2, 2, 13, 37, 16, False, None, None),
    (1, 4, 2, 37, 37, 16, True, None, 37),
    (1, 4, 1, 64, 64, 16, True, None, 16),
    (1, 2, 2, 64, 64, 16, True, 1, 16),
    (1, 2, 2, 64, 64, 16, True, 4, 16),
    (1, 4, 2, 64, 64, 16, True, 16, 16),
    (1, 2, 2, 37, 37, 16, True, 4, 37),
]


@pytest.mark.parametrize("B,H,Hkv,L,Lk,D,causal,window,block", FLASH_CASES)
def test_flash_fwd_plain_matches_pallas(B, H, Hkv, L, Lk, D, causal, window,
                                        block):
    q = _rand(0, (B, H, L, D))
    k = _rand(1, (B, Hkv, Lk, D))
    v = _rand(2, (B, Hkv, Lk, D))
    scale = D ** -0.5
    rep = H // Hkv
    o_j, lse_j = jax_flash_fwd(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
        jnp.asarray(v).repeat(rep, axis=1), scale, causal,
        block or L, block or Lk, True, window)
    o_t, lse_t = flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), scale, causal, window)
    assert tuple(lse_t.shape) == (B, H, L, 1) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=RTOL)
    # the dispatching wrapper takes the plain version on the CPU
    o_w, lse_w = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, window=window)
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)


@pytest.mark.parametrize("causal,window,Hkv", [
    (True, None, 4), (False, None, 2), (True, 5, 2)])
def test_flash_attention_public_layout_matches_pallas(causal, window, Hkv):
    B, L, H, D = 2, 32, 4, 16
    q = _rand(3, (B, L, H, D))
    k = _rand(4, (B, L, Hkv, D))
    v = _rand(5, (B, L, Hkv, D))
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, block_q=16,
                              block_k=16, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert tuple(out.shape) == (B, L, H, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_flash_window_one_is_the_diagonal():
    # window 1: each query sees only its own key, so o is v and lse is the
    # diagonal score
    q, k, v = (torch.from_numpy(_rand(s, (1, 2, 9, 16))) for s in (6, 7, 8))
    o, lse = flash_fwd_plain(q, k, v, 0.25, True, 1)
    torch.testing.assert_close(o, v, atol=1e-6, rtol=1e-6)
    diag = (q * k).sum(-1, keepdim=True) * 0.25
    torch.testing.assert_close(lse, diag, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kwargs,match", [
    ({"causal": True, "Lk": 64}, "causal"),
    ({"causal": False, "window": 4}, "window requires causal"),
    ({"causal": True, "window": 0}, "window must be >= 1"),
    ({"causal": True, "Hkv": 3}, "not a multiple"),
])
@pytest.mark.parametrize("layout", ["public", "fwd"])
def test_flash_guards(kwargs, match, layout):
    L, Lk = 16, kwargs.get("Lk", 16)
    Hkv = kwargs.get("Hkv", 2)
    q = torch.zeros(1, L, 4, 16)
    k = torch.zeros(1, Lk, Hkv, 16)
    with pytest.raises(ValueError, match=match):
        if layout == "public":
            flash_attention(q, k, k, causal=kwargs["causal"],
                            window=kwargs.get("window"))
        else:
            flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                      k.transpose(1, 2), causal=kwargs["causal"],
                      window=kwargs.get("window"))


def test_rms_norm_matches_pallas_f32():
    x = _rand(0, (4, 96, 64))
    scale = 1.0 + 0.1 * _rand(1, (64,))
    ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(scale))
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_rms_norm_bf16_promotes_like_pallas():
    # (bf16 normalized) * (f32 scale) -> f32, as the reference's kernel
    x = _rand(2, (16, 128))
    scale = 1.0 + 0.1 * _rand(3, (128,))
    ref = jax_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    out = rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(scale))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_rms_norm_bf16_scale_stays_bf16():
    # --param_dtype bfloat16 casts the scales too: bf16 in, bf16 out
    x = _rand(4, (8, 64))
    scale = 1.0 + 0.1 * _rand(5, (64,))
    ref = jax_rms_norm(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(scale, jnp.bfloat16))
    out = rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(scale).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # one bf16 step of the normalized value plus one of the product
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7 + 2 ** -8, atol=1e-6)


def test_cpu_tensors_take_plain_version_without_counting():
    _common.reset_launches()
    x = torch.randn(3, 5, 64)
    s = torch.rand(64)
    assert torch.equal(rms_norm(x, s), rms_norm_plain(x, s))
    q = torch.randn(1, 9, 2, 16)
    flash_attention(q, q, q)
    flash_fwd(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    assert _common.LAUNCHES == {"flash_fwd": 0, "rms_norm": 0}


def test_mixed_devices_are_refused():
    with pytest.raises(ValueError, match="on cpu or all on cuda"):
        rms_norm(torch.zeros(2, 8), torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="scale shape"):
        rms_norm(torch.zeros(2, 8), torch.zeros(4))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        _common.resolve_device("cuda")
    assert _common.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("length,preferred", [
    (13, 8), (37, 64), (64, 16), (96, 64), (1, 4), (128, 128)])
def test_pick_block_matches_reference(length, preferred):
    assert _common.pick_block(length, preferred) == \
        jax_pick_block(length, preferred)


def test_build_paths_follow_sources():
    assert "flash_fwd" in _build.sources()
    path = _build.library_path("flash_fwd")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path("flash_fwd")  # stable hash
    if shutil.which("nvcc") is None:
        # no silent fallback: a build without nvcc raises
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()
