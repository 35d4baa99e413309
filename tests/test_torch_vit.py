"""The port's ViT (k8s_tpu_torch/models/vit.py) against the JAX package's
flax module on the CPU.

Inputs come from numpy with a seed; flax parameters reach the port
through ``bridge.vit_from_jax`` and the port's gradients come back through
``bridge.vit_to_jax``.  With ``use_fused_norm`` the reference runs its
Pallas RMSNorm kernel in interpret mode and the port its plain version
(CPU tensors).  Tolerances, f32 throughout: logits and gradients 1e-4
relative to the largest magnitude of the reference array (summation order
of the projections and the attention).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import train as jtrain
from k8s_tpu.models import vit as jv
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import train as ttrain
from k8s_tpu_torch.models import vit as tv
from k8s_tpu_torch.models.mnist_data import load_dataset
from k8s_tpu_torch.models.transformer import rotary_embedding
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

TOL = 1e-4
MNIST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "mnist")
# (pool, use_fused_norm, remat)
CASES = [("cls", False, False), ("mean", False, False), ("cls", True, False),
         ("mean", True, True)]
IDS = ["cls", "mean", "cls-fused", "mean-fused-remat"]


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max abs err {err} vs scale {scale}"


def _configs(pool, fused, remat):
    kw = dict(pool=pool, use_fused_norm=fused, remat=remat)
    return (dataclasses.replace(jv.vit_tiny_test(), **kw),
            dataclasses.replace(tv.vit_tiny_test(), **kw))


def _pair(pool, fused, remat, seed=1):
    jc, tc = _configs(pool, fused, remat)
    jm = jv.ViT(jc)
    x = np.zeros((1, 32, 32, 3), np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x))["params"])
    # a nonzero cls token, so the cls pool reads a learned vector
    params["cls_token"] = np.random.default_rng(seed).normal(
        size=params["cls_token"].shape).astype(np.float32) * 0.1
    tm = tv.ViT(tc, device="cpu")
    tm.load_state_dict(bridge.vit_from_jax(params))
    return jm, params, tm, tc


def _batch(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


@pytest.mark.parametrize("pool,fused,remat", CASES, ids=IDS)
def test_logits_match_flax(pool, fused, remat):
    jm, params, tm, _ = _pair(pool, fused, remat)
    x, _ = _batch()
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    _close(got.numpy(), want, what="logits")


@pytest.mark.parametrize("pool,fused,remat", CASES, ids=IDS)
def test_gradients_match_jax_grad(pool, fused, remat):
    jm, params, tm, tc = _pair(pool, fused, remat, seed=2)
    x, y = _batch(seed=4)

    def loss_fn(p):
        return jtrain.cross_entropy_loss(
            jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))
    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    loss = ttrain.cross_entropy_loss(tm(torch.from_numpy(x)),
                                     torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(jloss), what="loss")
    grads = bridge.vit_to_jax({n: p.grad for n, p in tm.named_parameters()},
                              tc)
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, what=f"grad {path}"),
        grads, jax.device_get(jgrads))


def test_guards():
    x = np.zeros((1, 32, 32, 3), np.float32)
    bad = dataclasses.replace(tv.vit_tiny_test(), pool="max")
    with pytest.raises(ValueError, match="unknown pool"):
        tv.ViT(bad, device="cpu")
    with pytest.raises(ValueError, match="unknown pool"):
        jv.ViT(dataclasses.replace(jv.vit_tiny_test(), pool="max")).init(
            jax.random.PRNGKey(0), jnp.asarray(x))
    for mod in (tv, jv):
        with pytest.raises(ValueError, match="not divisible"):
            mod.ViTConfig(image_size=30, patch_size=16).num_patches
    with pytest.raises(ValueError, match="not divisible"):
        tv.ViT(tv.ViTConfig(image_size=30, patch_size=16), device="cpu")


def test_b16_parameters_match_reference():
    """ViT-B/16: every parameter, shape for shape, against the
    reference's, taken with jax.eval_shape (nothing runs at full size on
    the JAX side); ~86M, the canonical budget."""
    cfg = tv.vit_b16()
    assert cfg.num_patches == 196 and cfg.block_config().max_seq_len == 197
    shapes = jax.eval_shape(lambda: jv.ViT(jv.vit_b16()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"]
    model = tv.ViT(cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(shapes))
    assert 80e6 < n < 95e6, n
    got = jax.tree_util.tree_map(
        np.shape, bridge.vit_to_jax(model.state_dict(), cfg))
    assert got == jax.tree_util.tree_map(lambda a: tuple(a.shape), shapes)


def test_rope_is_the_identity_at_position_zero():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 5, 4, 8)).astype(np.float32))
    out = rotary_embedding(x, torch.zeros(2, 5, dtype=torch.long), 10000.0)
    assert torch.equal(out, x)


def test_trains_on_real_mnist_digits():
    """The 28x28 / patch-7 config (16 tokens) on the committed real-digit
    fixture, full-batch Adam: the loss falls well below uniform ln(10)
    and train accuracy clears chance by a wide margin (the bounds of
    tests/test_vit.py's reference run)."""
    x, y = load_dataset(MNIST)
    x = torch.from_numpy(np.repeat(x[:128], 3, axis=-1))  # gray -> 3ch
    y = torch.from_numpy(y[:128])
    cfg = tv.ViTConfig(image_size=28, patch_size=7, num_classes=10,
                       hidden=64, ffn_hidden=128, layers=2, heads=4,
                       dtype=torch.float32, remat=False)
    torch.manual_seed(0)
    model = tv.ViT(cfg, device="cpu")
    opt = ttrain.default_optimizer(2e-3)
    state = ttrain.init_state(model, opt)
    step = ttrain.make_train_step(lambda m, b: m(b), ttrain.cross_entropy_loss,
                                  opt)
    losses = [step(state, (x, y))[1].item() for _ in range(60)]
    assert losses[-1] < 1.0, losses[-1]
    with torch.no_grad():
        acc = (model(x).argmax(-1) == y).float().mean().item()
    assert acc > 0.7, acc
