"""The port's flash-attention backward (k8s_tpu_torch/ops/flash_attention.py)
against the JAX Pallas backward on the CPU.

``flash_bwd_plain`` is held against ``_flash_bwd`` (Pallas interpret mode)
on the same forward's o and lse, and ``torch.autograd.grad`` through the
port's differentiable ``flash_attention`` / ``flash_fwd`` against
``jax.grad`` of the reference's, at the reference's own tolerances
(tests/test_ops.py: 5e-4 for flash grads, 5e-5 for windowed grads).  The
CUDA kernels (csrc/flash_bwd.cuh) are held against ``flash_bwd_plain`` on
the card by chip_smoke.py.  Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops import flash_attention as jax_flash_attention
from k8s_tpu.ops.flash_attention import _flash_bwd as jax_flash_bwd
from k8s_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from k8s_tpu_torch.ops import _common
from k8s_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_bwd,
    flash_bwd_plain,
    flash_fwd,
)
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

BWD_TOL = 5e-4     # tests/test_ops.py flash grads
WINDOW_TOL = 5e-5  # tests/test_ops.py windowed grads


def _rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# The forward's cases (tests/test_torch_ops.py FLASH_CASES): (B, H, Hkv, L,
# Lk, D, causal, window, block) -- causal and bidirectional, GQA, windows
# 1/4/16, a ragged 37.
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
def test_flash_bwd_plain_matches_pallas(B, H, Hkv, L, Lk, D, causal, window,
                                        block):
    q = _rand(0, (B, H, L, D))
    k = _rand(1, (B, Hkv, Lk, D))
    v = _rand(2, (B, Hkv, Lk, D))
    do = _rand(3, (B, H, L, D))
    scale = D ** -0.5
    G = H // Hkv
    bq, bk = block or L, block or Lk
    kr = jnp.repeat(jnp.asarray(k), G, axis=1)
    vr = jnp.repeat(jnp.asarray(v), G, axis=1)
    o, lse = jax_flash_fwd(jnp.asarray(q), kr, vr, scale, causal, bq, bk,
                           True, window)
    dq_j, dk_j, dv_j = jax_flash_bwd(jnp.asarray(q), kr, vr, o, lse,
                                     jnp.asarray(do), scale, causal, bq, bk,
                                     True, window)
    # the reference repeats K/V, so its dk/dv are per query head: sum each
    # group as the transpose of jnp.repeat does
    dk_j = np.asarray(dk_j).reshape(B, Hkv, G, Lk, D).sum(2)
    dv_j = np.asarray(dv_j).reshape(B, Hkv, G, Lk, D).sum(2)
    args = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)]
    got = flash_bwd_plain(*args, scale, causal, window)
    for name, t, ref in zip(("dq", "dk", "dv"), got,
                            (np.asarray(dq_j), dk_j, dv_j)):
        assert t.dtype == torch.float32 and tuple(t.shape) == ref.shape, name
        np.testing.assert_allclose(t.numpy(), ref, atol=2e-5, rtol=2e-5,
                                   err_msg=name)
    # the dispatching wrapper takes the plain version on the CPU
    _common.reset_launches()
    wrapped = flash_bwd(*args, scale, causal, window)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert _common.launches()["flash_bwd_dq"] == 0


def _jax_grads(q, k, v, cot, causal, window):
    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=16, block_k=16, interpret=True)
        return jnp.sum(out * cot)

    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("causal,window,Hkv", [
    (True, None, 4), (False, None, 4), (True, None, 2), (True, None, 1),
    (True, 5, 2), (True, 16, 4)])
def test_flash_attention_grads_match_jax(causal, window, Hkv):
    B, L, H, D = 2, 32, 4, 16
    q, k, v = _rand(4, (B, L, H, D)), _rand(5, (B, L, Hkv, D)), \
        _rand(6, (B, L, Hkv, D))
    cot = _rand(7, (B, L, H, D))
    ref = _jax_grads(q, k, v, cot, causal, window)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (qt, kt, vt))
    tol = WINDOW_TOL if window else BWD_TOL
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol,
                                   rtol=tol, err_msg=name)


def test_flash_fwd_grads_match_jax_and_lse_is_not_differentiable():
    # flash_fwd's [B, H, L, D] layout goes through the same Function
    B, H, Hkv, L, D = 1, 4, 2, 24, 16
    q, k, v = _rand(8, (B, H, L, D)), _rand(9, (B, Hkv, L, D)), \
        _rand(10, (B, Hkv, L, D))
    cot = _rand(11, (B, H, L, D))
    ref = _jax_grads(*(a.transpose(0, 2, 1, 3) for a in (q, k, v)),
                     cot.transpose(0, 2, 1, 3), True, None)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_fwd(qt, kt, vt)
    assert not lse.requires_grad
    grads = torch.autograd.grad((o * torch.from_numpy(cot)).sum(),
                                (qt, kt, vt))
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(r).transpose(0, 2, 1, 3),
                                   atol=BWD_TOL, rtol=BWD_TOL)


def test_expanded_gradient_is_accepted():
    # out.sum() hands the backward an expanded (stride 0) gradient
    q = torch.from_numpy(_rand(12, (1, 16, 2, 16))).requires_grad_()
    out = flash_attention(q, q, q)
    (g,) = torch.autograd.grad(out.sum(), (q,), retain_graph=True)
    (g2,) = torch.autograd.grad((out * torch.ones_like(out)).sum(), (q,))
    torch.testing.assert_close(g, g2, atol=0, rtol=0)


def test_bf16_plain_backward_keeps_input_types():
    q = torch.from_numpy(_rand(13, (1, 2, 9, 16))).to(torch.bfloat16)
    k = torch.from_numpy(_rand(14, (1, 1, 9, 16))).to(torch.bfloat16)
    o, lse = flash_fwd(q, k, k)
    dq, dk, dv = flash_bwd_plain(q, k, k, o, lse, torch.ones_like(o),
                                 16 ** -0.5, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert tuple(dk.shape) == (1, 1, 9, 16)
