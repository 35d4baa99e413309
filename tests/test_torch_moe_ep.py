"""Expert parallelism of the port (``MoeMLP(mesh=)``, the (fsdp, ep)
train step of ``models/train.py``) against the JAX package's ep-sharded
``MoeMLP`` and ``make_moe_apply_fn(mesh=)`` step.

- ``MoeMLP`` over ep 2 and ep 4, alone and with a data axis of 2 (the
  model of ``tests/test_moe.py:66-76``, ep 4 x fsdp 2), its ranks as
  threads of this process (``ThreadRing``; the data ring is the grid's
  sp axis): the output, the aux loss and every gradient (router, experts,
  input) against JAX's on a virtual mesh of the same shape, at a
  capacity factor that drops pairs (the global batch's drops: data ranks
  route it as one).  Each rank's loss is its rows' ``sum(y**2)`` plus the
  aux loss over the data ranks; the gradients summed over the data
  ranks (ep ranks hold theirs whole: no gradient is ep times too large);
- one gloo world of 4 (``tests/torch_world.py`` ``moe`` worker): the MoE
  Transformer on an (fsdp 2, ep 2) mesh trains 3 AdamW steps with the
  clip active through ``make_moe_apply_fn(mesh=)`` against JAX's step on
  the same mesh: losses, final weights (each ep rank's experts) and the
  gradient at the final weights; then a DCP checkpoint of that state
  restored exactly into a fresh one.

f32; values at 2e-5 and gradients at 5e-5, ``tests/test_torch_ring.py``'s
(the experts' sums over ranks reorder f32 additions); the training run
at ``tests/test_torch_sp_train.py``'s tolerances (losses rtol 1e-5,
weights atol 5e-6 at lr 3e-4, gradients atol 2e-6).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.models.moe import MoeMLP as JMoe
from k8s_tpu.parallel.mesh import MeshConfig, make_mesh
from k8s_tpu_torch.models import bridge, moe
from k8s_tpu_torch.parallel.collectives import MeshRings, ThreadRing

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

VAL_TOL, GRAD_TOL = 2e-5, 5e-5
E, D, F = 4, 16, 32


def _jax_moe(ep, data, x, cf):
    mesh = make_mesh(MeshConfig(ep=ep, fsdp=data),
                     jax.devices()[:ep * data])
    m = JMoe(num_experts=E, ffn_hidden=F, dtype=jnp.float32,
             capacity_factor=cf, mesh=mesh)
    params = m.init(jax.random.PRNGKey(1), x)

    def loss(p, x):
        y, cols = m.apply(p, x, mutable=["losses"])
        aux = cols["losses"]["moe_aux_loss"]
        return jnp.sum(y ** 2) + aux, (y, aux)

    with mesh:
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
    return jax.device_get(params["params"]), y, aux, grads


@pytest.mark.parametrize("ep,data", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_moe_mlp_over_ep_matches_jax(ep, data):
    cf = 0.75  # a pair in every few overflows its expert
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (4, 16, D)))
    params, y, aux, (g_p, g_x) = _jax_moe(ep, data, jnp.asarray(x), cf)
    g_p = jax.device_get(g_p["params"])
    rows = len(x) // data

    def body(grid):
        rings = MeshRings(ep=grid.ep, fsdp=grid.sp)
        m = moe.MoeMLP(E, D, F, dtype=torch.float32, capacity_factor=cf,
                       mesh=rings)
        with torch.no_grad():
            for n in ("router", *moe.EXPERT_PARAMS):
                getattr(m, n).copy_(moe.expert_slice(n, rings.ep)(
                    torch.from_numpy(np.array(params[n]))))
        lo = rings.fsdp.rank * rows
        xs = torch.from_numpy(x[lo:lo + rows]).requires_grad_()
        ys, a = m(xs)
        (ys.square().sum() + a / data).backward()
        g = {n: rings.fsdp.all_reduce(p.grad) for n, p in
             m.named_parameters()}
        return ys.detach(), a.detach(), g, xs.grad

    res = ThreadRing.run_mesh(data, 1, body, ep=ep)
    El = E // ep
    for i, (ys, a, g, gx) in enumerate(res):
        e, r = divmod(i, data)  # (ep, data) grid, data innermost
        sl = slice(r * rows, (r + 1) * rows)
        np.testing.assert_allclose(ys.numpy(), np.asarray(y)[sl],
                                   rtol=VAL_TOL, atol=VAL_TOL)
        np.testing.assert_allclose(float(a), float(aux), rtol=VAL_TOL,
                                   atol=VAL_TOL)
        np.testing.assert_allclose(gx.numpy(), np.asarray(g_x)[sl],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(g["router"].numpy(),
                                   np.asarray(g_p["router"]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        for n in moe.EXPERT_PARAMS:
            np.testing.assert_allclose(
                g[n].numpy(), np.asarray(g_p[n])[e * El:(e + 1) * El],
                rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"ep {e} {n}")


def test_experts_must_divide_over_ep():
    with pytest.raises(ValueError, match="3 experts do not divide over ep 2"):
        ThreadRing.run_mesh(1, 1, lambda r: moe.MoeMLP(3, D, F, mesh=r),
                            ep=2)


# -- a gloo world of 4: the MoE Transformer on (fsdp 2, ep 2) ---------------

STEPS, B, L = 3, 4, 16
OPT = dict(lr=3e-4, weight_decay=0.01, clip_norm=0.1)
MOE = dict(num_experts=4, expert_top_k=2, expert_capacity_factor=1.0)


def _jax_run(cfg, params, tokens):
    mesh = make_mesh(MeshConfig(fsdp=2, ep=2), jax.devices()[:4])
    model = jt.Transformer(cfg)
    opt = jtrain.default_optimizer(OPT["lr"], OPT["weight_decay"],
                                   clip_norm=OPT["clip_norm"])
    apply_fn = jtrain.make_moe_apply_fn(model, mesh=mesh)
    state, sh = jtrain.shard_train_state(
        jtrain.init_state({"params": params}, opt), mesh)
    step = jtrain.make_sharded_train_step(apply_fn, jtrain.lm_loss, opt,
                                          mesh, sh)
    losses = []
    for t in tokens:
        state, loss = step(state, (jnp.asarray(t), jnp.asarray(t)))
        losses.append(float(loss))
    final = jax.device_get(state["params"]["params"])

    def loss_fn(p, t):
        logits, aux = apply_fn({"params": p}, t)
        return jtrain.lm_loss(logits, t) + aux

    with mesh:
        grads = jax.jit(jax.grad(loss_fn))(final, jnp.asarray(tokens[0]))
    return losses, final, jax.device_get(grads)


def test_world_of_four_moe_transformer_on_fsdp_ep(tmp_path):
    cfg = dataclasses.replace(jt.tiny_test(), **MOE)
    params = jax.device_get(jt.Transformer(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, L), jnp.int32))["params"])
    tokens = np.random.default_rng(13).integers(
        0, 256, (STEPS, B, L)).astype(np.int32)
    sd = bridge.params_from_jax(params)
    with open(tmp_path / "in.json", "w") as f:
        json.dump({"config": MOE, "mesh": {"fsdp": 2, "ep": 2},
                   "opt": OPT}, f)
    np.savez(tmp_path / "in.npz", tokens=tokens,
             **{f"param/{n}": t.numpy() for n, t in sd.items()})
    rcs, outs = torch_world.spawn(
        4, ["tests/torch_world.py", "moe", str(tmp_path)], timeout=150)
    assert rcs == [0] * 4, "\n".join(o[-3000:] for o in outs)
    got = json.load(open(tmp_path / "out.json"))
    assert got["mesh"] == {"dp": 1, "pp": 1, "fsdp": 2, "ep": 2, "sp": 1,
                           "tp": 1}
    # the DCP round trip restores every rank's weights and moments
    assert got["restored_equal"] and ".metadata" in got["ckpt_files"]
    jlosses, jfinal, jgrads = _jax_run(cfg, params, tokens)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, atol=1e-6)
    want_p = {n: t.numpy() for n, t in bridge.params_from_jax(jfinal).items()}
    want_g = {n: t.numpy() for n, t in bridge.params_from_jax(jgrads).items()}
    for rank in range(4):
        coord = json.load(open(tmp_path / f"coord_{rank}.json"))
        arrs = dict(np.load(tmp_path / f"out_{rank}.npz"))
        for key, a in arrs.items():
            kind, n = key.split("/", 1)
            want = (want_p if kind == "param" else want_g)[n]
            if moe.is_expert_param(n):  # this ep rank's experts
                El = len(want) // 2
                want = want[coord["ep"] * El:(coord["ep"] + 1) * El]
            np.testing.assert_allclose(
                a, want, rtol=1e-5, atol=5e-6 if kind == "param" else 2e-6,
                err_msg=f"rank {rank} {key}")
