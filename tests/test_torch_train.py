"""The port's training layer (k8s_tpu_torch/models/train.py, ops/fused_ce.py,
the RMSNorm Function, the trainable Transformer) against the JAX package
on the CPU.

Inputs and gradients come from numpy with a seed and go to both; JAX
parameters reach the port through ``bridge.params_from_jax`` and the
port's gradients come back through ``bridge.params_to_jax``.  Pallas runs
in interpret mode.  Tolerances: f32 throughout, 1e-5 for single ops and
optimizer updates (summation order), the reference's flash-grad 5e-4
(tests/test_ops.py) for whole-model gradients and loss curves.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.ops import rms_norm as jax_rms_norm
from k8s_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_fused_ce
from k8s_tpu.parallel import MeshConfig, make_mesh
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import checkpoint as tckpt
from k8s_tpu_torch.models import data as tdata
from k8s_tpu_torch.models import train as ttrain
from k8s_tpu_torch.models import transformer as tt
from k8s_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from k8s_tpu_torch.ops.fused_norm import rms_norm
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

OP_TOL = 1e-5
MODEL_TOL = 5e-4
TOKENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "tokens", "tokens-00000.npy")


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(
        np.float32)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


@pytest.mark.parametrize("eps", [1e-6, 0.5])
def test_rms_norm_grads_match_jax(eps):
    x, scale = _rand(0, (3, 5, 64)), 1.0 + 0.1 * _rand(1, (64,))
    cot = _rand(2, (3, 5, 64))
    ref = jax.grad(lambda x, s: jnp.sum(jax_rms_norm(x, s, eps=eps) * cot),
                   argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    xt, st = _t(x, True), _t(scale, True)
    out = rms_norm(xt, st, eps=eps)
    grads = torch.autograd.grad((out * _t(cot)).sum(), (xt, st))
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=OP_TOL,
                                   rtol=OP_TOL)


def test_cross_entropy_counts_invalid_labels_in_the_mean():
    logits = _rand(3, (4, 6, 11), 3.0)
    labels = np.random.RandomState(4).randint(-1, 11, (4, 6)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 0] = 11  # out of range: zero loss, counted
    ref, ref_g = jax.value_and_grad(jtrain.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    lt = _t(logits, True)
    loss = ttrain.cross_entropy_loss(lt, _t(labels))
    (g,) = torch.autograd.grad(loss, (lt,))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=OP_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=OP_TOL)
    assert np.all(g[0, :3].numpy() == 0)
    # the trap: ignore_index averages over the valid labels only
    ignore = torch.nn.functional.cross_entropy(
        lt.reshape(-1, 11), _t(labels).long().reshape(-1).clamp(max=10)
        .masked_fill(_t(labels).reshape(-1) > 10, -1), ignore_index=-1)
    assert abs(ignore.item() - loss.item()) > 1e-3

    tokens = np.random.RandomState(5).randint(0, 11, (4, 6)).astype(np.int32)
    np.testing.assert_allclose(
        ttrain.lm_loss(_t(logits), _t(tokens)).item(),
        float(jtrain.lm_loss(jnp.asarray(logits), jnp.asarray(tokens))),
        rtol=OP_TOL)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_fused_ce_matches_jax(z_loss):
    hidden, emb = _rand(6, (2, 9, 16)), _rand(7, (50, 16), 0.5)
    targets = np.random.RandomState(8).randint(-1, 50, (2, 9)).astype(np.int32)

    def jloss(h, e):
        return jax_fused_ce(h, e, jnp.asarray(targets), vocab_chunk=16,
                            z_loss=z_loss)

    ref, ref_g = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(emb))
    ht, et = _t(hidden, True), _t(emb, True)
    loss = fused_linear_cross_entropy(ht, et, _t(targets), vocab_chunk=16,
                                      z_loss=z_loss)
    grads = torch.autograd.grad(loss, (ht, et))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=OP_TOL)
    for g, r in zip(grads, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=OP_TOL,
                                   rtol=OP_TOL)
    if not z_loss:
        # loss-exact against the materialized head
        full = ttrain.cross_entropy_loss(ht @ et.T, _t(targets))
        np.testing.assert_allclose(loss.item(), full.item(), rtol=OP_TOL)


@pytest.mark.parametrize("schedule,warmup", [
    ("cosine", 3), ("linear", 3), ("cosine", 0), ("constant", 4)])
def test_lr_schedule_matches_optax_at_every_step(schedule, warmup):
    kw = dict(schedule=schedule, warmup_steps=warmup, decay_steps=10)
    ours = ttrain.lr_schedule(0.3, **kw)
    ref = jtrain.lr_schedule(0.3, **kw)
    for count in range(20):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-9, err_msg=str(count))


@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.1, clip_norm=0.5, schedule="cosine", warmup_steps=2,
         decay_steps=3),
    dict(clip_norm=100.0),
    dict(weight_decay=0.0)])
def test_default_optimizer_matches_optax(kw):
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [_rand(10 + i, s) for i, s in enumerate(shapes)]
    ref_opt = jtrain.default_optimizer(0.05, **kw)
    ref_params = [jnp.asarray(p) for p in params]
    ref_state = ref_opt.init(ref_params)
    opt_spec = ttrain.default_optimizer(0.05, **kw)
    tparams = [torch.nn.Parameter(_t(p)) for p in params]
    opt = opt_spec.init(tparams)
    for step in range(5):
        grads = [_rand(100 + 10 * step + i, s) for i, s in enumerate(shapes)]
        updates, ref_state = ref_opt.update(
            [jnp.asarray(g) for g in grads], ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        for p, g in zip(tparams, grads):
            p.grad = _t(g)
        opt_spec.update(opt)
        for p, r in zip(tparams, ref_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                       atol=OP_TOL, rtol=OP_TOL,
                                       err_msg=f"update {step}")


def test_clip_is_optax_form():
    g = [torch.full((4,), 3.0), torch.full((1,), 4.0)]
    norm = ttrain.clip_by_global_norm_(g, 1.0)
    np.testing.assert_allclose(norm.item(), np.sqrt(52.0), rtol=1e-6)
    total = torch.sqrt(sum((x ** 2).sum() for x in g))
    np.testing.assert_allclose(total.item(), 1.0, rtol=1e-6)


def _configs(dtype="float32", **kw):
    cj = dataclasses.replace(jt.tiny_test(), dtype=getattr(jnp, dtype), **kw)
    ct = dataclasses.replace(tt.tiny_test(), dtype=getattr(torch, dtype),
                             **kw)
    return cj, ct


def _pair(seed=1, **kw):
    cj, ct = _configs(**kw)
    params = jt.Transformer(cj).init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    model = tt.Transformer(ct, bridge.params_from_jax(jax.device_get(params)),
                           device="cpu", trainable=True)
    return cj, ct, params, model


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("kernels,remat,kv_heads", [
    (False, False, 4), (True, False, 2), (True, True, 4)],
    ids=["plain", "kernels-gqa", "kernels-remat"])
def test_tiny_model_grads_match_jax(kernels, remat, kv_heads):
    cj, ct, params, model = _pair(use_flash_attention=kernels,
                                  use_fused_norm=kernels, remat=remat,
                                  kv_heads=kv_heads)
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


def test_trainable_weights_are_f32_masters_cast_per_forward():
    # bf16 compute over f32 masters: the loss matches the reference's
    # param_dtype=float32 / dtype=bfloat16 model at its bf16 tolerance
    cj, ct, params, model = _pair(dtype="bfloat16")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    tokens = _tokens((2, 16), 4)
    ref = jtrain.lm_loss(jt.Transformer(cj).apply({"params": params}, tokens),
                         tokens)
    loss = ttrain.lm_loss(model(_t(tokens)), _t(tokens))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-2)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_grad_accum_equals_full_batch():
    ct = tt.tiny_test()
    sd = bridge.init_params(ct, 0, "cpu", dtype=torch.float32)
    tokens = _t(_tokens((4, 12), 5)).long()
    out = []
    for accum in (1, 2):
        model = tt.Transformer(ct, sd, device="cpu", trainable=True)
        opt = ttrain.default_optimizer(1e-2)
        state = ttrain.init_state(model, opt)
        step = ttrain.make_train_step(lambda m, x: m(x), ttrain.lm_loss, opt,
                                      grad_accum=accum)
        state, loss = step(state, (tokens, tokens))
        out.append((loss.item(), [p.grad.clone()
                                  for p in model.parameters()]))
    # the same loss and the same gradients reach the update
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.make_train_step(lambda m, x: m(x), ttrain.lm_loss, opt,
                               grad_accum=3)(state, (tokens, tokens))


def test_fit_loss_curve_matches_jax_on_fixture_tokens(tmp_path):
    """20 steps on windows of tests/fixtures/tokens, the same batches to
    both frameworks' fit (clipping, warmup and cosine on)."""
    L, B, steps = 32, 4, 20
    toks = np.load(TOKENS).astype(np.int32)
    windows = toks[:(len(toks) // L) * L].reshape(-1, L)
    batches = [b for (b,), _ in zip(tdata.array_batches((windows,), B, seed=3),
                                    range(steps))]
    kw = dict(clip_norm=1.0, schedule="cosine", warmup_steps=2,
              decay_steps=steps - 2)
    cj, ct, params, model = _pair(seed=2)

    jm = jt.Transformer(cj)
    jopt = jtrain.default_optimizer(3e-3, **kw)
    jres = jtrain.fit(lambda p, x: jm.apply(p, x), jtrain.lm_loss, jopt,
                      jtrain.init_state({"params": params}, jopt),
                      make_mesh(MeshConfig(), jax.devices()[:1]),
                      iter([(b, b) for b in batches]), steps=steps,
                      preemption_save=False)

    topt = ttrain.default_optimizer(3e-3, **kw)
    it = tdata.prefetch_to_device(((b, b) for b in batches), "cpu")
    try:
        tres = ttrain.fit(lambda m, x: m(x), ttrain.lm_loss, topt,
                          ttrain.init_state(model, topt), it, steps=steps,
                          preemption_save=False,
                          checkpoint_dir=str(tmp_path), checkpoint_every=10)
    finally:
        it.close()
    assert len(tres.losses) == steps and tres.losses[-1] < tres.losses[0]
    np.testing.assert_allclose(tres.losses, jres.losses, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    ck = tckpt.Checkpointer(str(tmp_path))
    assert ck.all_steps() == [0, 10, 19]


def test_checkpointer_interval_prune_and_restore(tmp_path):
    ct = tt.tiny_test()
    sd = bridge.init_params(ct, 0, "cpu", dtype=torch.float32)
    opt = ttrain.default_optimizer(1e-2)
    state = ttrain.init_state(tt.Transformer(ct, sd, device="cpu",
                                             trainable=True), opt)
    ck = tckpt.Checkpointer(str(tmp_path), max_to_keep=2,
                            save_interval_steps=3)
    saved = [s for s in range(8) if ck.maybe_save(s, state)]
    assert saved == [0, 3, 6]  # the first save, then on the interval
    assert ck.all_steps() == [3, 6]  # pruned to max_to_keep
    assert not ck.save(6, state) and ck.save(7, state, force=True)
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    fresh = ttrain.init_state(tt.Transformer(ct, bridge.init_params(
        ct, 1, "cpu", dtype=torch.float32), device="cpu", trainable=True),
        opt)
    fresh["step"] = -1
    state["step"] = 5
    ck.save(9, state, force=True)
    restored, nxt = ck.restore_or_init(fresh)
    assert nxt == 10 and restored["step"] == 5
    for a, b in zip(restored["model"].parameters(),
                    state["model"].parameters()):
        assert torch.equal(a, b)


def test_prefetch_contract():
    src = ((np.full((2,), i), np.full((2,), -i)) for i in range(10))
    it = tdata.prefetch_to_device(src, "cpu", buffer_size=2)
    it.skip(3)
    first = next(it)
    assert isinstance(first[0], torch.Tensor) and first[0][0].item() == 3
    with pytest.raises(RuntimeError, match="before consumption"):
        it.skip(1)
    assert [b[1][0].item() for b in it] == [-i for i in range(4, 10)]
    it.close()

    def boom():
        yield (np.zeros(1),)
        raise OSError("disk gone")

    it = tdata.prefetch_to_device(boom(), "cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    it.close()


def test_parallel_pieces_name_their_slice():
    # the FSDP step, sp, tp, pp and ep are ported (tests/test_torch_fsdp.py,
    # test_torch_sp_train.py, test_torch_pp_lm.py, test_torch_moe_ep.py):
    # the sharded step counts pp and ep ranks as replicas of a row's loss
    class PpMesh:
        mesh_dim_names = ("dp", "pp", "fsdp", "ep", "sp", "tp")
        mesh = np.zeros((1, 2, 1, 2, 2, 1))

    assert ttrain._replicas(PpMesh()) == 4
    # MoE training over a mesh (expert parallelism) is ported too
    assert callable(ttrain.make_moe_apply_fn(None))
    assert callable(ttrain.make_moe_apply_fn(None, mesh=object()))
    from k8s_tpu_torch.launcher import bootstrap

    cfg = bootstrap.LauncherConfig.from_env(
        {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
         "JAX_COORDINATOR_ADDRESS": "h:1", "CHECKPOINT_DIR": "/c"})
    assert (cfg.num_processes, cfg.process_id, cfg.checkpoint_dir) == \
        (2, 1, "/c") and not cfg.is_chief
    # a world of more processes needs its coordinator (the reference's
    # words); none is joined here
    with pytest.raises(RuntimeError, match="JAX_COORDINATOR_ADDRESS is not"):
        bootstrap.initialize_distributed(
            bootstrap.LauncherConfig(num_processes=2), device="cpu")
    assert bootstrap.initialize_distributed(
        bootstrap.LauncherConfig()).is_chief
