"""The port's Mixture-of-Experts layer (k8s_tpu_torch/models/moe.py) and the
MoE Transformer against the JAX package on the CPU, in f32.

Parameters and inputs come from numpy with a seed.  The layer is held at
the dense Transformer's 1e-4 (tests/test_torch_transformer.py) over one
and four experts, top-1 and top-2, a capacity factor tight enough to
drop pairs, and rows of equal router logits (ties go to the lowest expert
index, as ``jax.lax.top_k`` breaks them); its gradients, router included,
at the single-op 1e-5 of tests/test_torch_train.py; the MoE Transformer's
logits in train, prefill and decode at 1e-4; ``make_moe_apply_fn`` and
``fit`` loss curves at the whole-model 5e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import moe as jmoe
from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.parallel import MeshConfig, make_mesh
from k8s_tpu_torch.models import bridge, moe
from k8s_tpu_torch.models import data as tdata
from k8s_tpu_torch.models import train as ttrain
from k8s_tpu_torch.models import transformer as tt
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

TOL = 1e-4
OP_TOL = 1e-5
MODEL_TOL = 5e-4
D, F = 16, 32


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def _params(E, seed=0, tie=False):
    router = _rand(seed, (D, E), 3.0 / np.sqrt(D))
    if tie and E > 2:
        router[:, 2] = router[:, 1]  # experts 1 and 2 tie on every row
    return {"router": router,
            "w_gate": _rand(seed + 1, (E, D, F), D ** -0.5),
            "w_up": _rand(seed + 2, (E, D, F), D ** -0.5),
            "w_down": _rand(seed + 3, (E, F, D), F ** -0.5)}


def _x(shape=(3, 4, D), seed=9, zero_row=False):
    x = _rand(seed, shape)
    if zero_row:
        x[0, 0] = 0.0  # every router logit 0: all experts tie
    return x


def _jax_layer(E, k, cf):
    return jmoe.MoeMLP(num_experts=E, ffn_hidden=F, top_k=k,
                       capacity_factor=cf, dtype=jnp.float32)


def _port_layer(E, k, cf, params):
    layer = moe.MoeMLP(E, D, F, top_k=k, capacity_factor=cf,
                       dtype=torch.float32)
    layer.load_state_dict({n: torch.from_numpy(v.copy())
                           for n, v in params.items()})
    return layer


def _jax_apply(E, k, cf, params, x):
    y, cols = _jax_layer(E, k, cf).apply(
        {"params": {n: jnp.asarray(v) for n, v in params.items()}},
        jnp.asarray(x), mutable=["losses"])
    return np.asarray(y), float(cols["losses"]["moe_aux_loss"])


CASES = {
    "e1_k1": (1, 1, 1.25, {}),
    "e4_k1": (4, 1, 1.25, {}),
    "e4_k2": (4, 2, 1.25, {}),
    "e4_k2_drops": (4, 2, 0.5, {}),
    "e4_k1_drops": (4, 1, 0.25, {}),
    "e4_k2_ties": (4, 2, 1.25, {"tie": True, "zero_row": True}),
    "e4_k2_ties_drops": (4, 2, 0.5, {"tie": True, "zero_row": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_reference(case):
    E, k, cf, kw = CASES[case]
    params = _params(E, tie=kw.get("tie", False))
    x = _x(zero_row=kw.get("zero_row", False))
    y_ref, aux_ref = _jax_apply(E, k, cf, params, x)
    with torch.no_grad():
        y, aux = _port_layer(E, k, cf, params)(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux.item(), aux_ref, atol=TOL, rtol=TOL)
    _, _, gate_idx, _, keep, C = moe.route(
        torch.from_numpy(x.reshape(-1, D)), torch.from_numpy(params["router"]),
        k, cf)
    assert C == max(1, int(np.ceil(min(k, E) * x.size // D / E * cf)))
    if "drops" in case:
        assert not bool(keep.all())  # the case really drops pairs
    if kw.get("tie"):
        # expert 2 duplicates expert 1: the lower index always wins, and
        # the all-zero row picks experts 0 and 1
        assert not bool((gate_idx[:, 0] == 2).any())
        assert gate_idx[0].tolist() == [0, 1]


def test_top_k_breaks_ties_by_lowest_index():
    rows = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                     [0.3, 0.2, 0.3, 0.2]], np.float32)
    vals, idx = moe.top_k_lowest_index(torch.from_numpy(rows), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(rows), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3],
                                                       [0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_single_expert_is_the_dense_swiglu():
    params = _params(1, seed=4)
    x = _x(seed=5)
    cfg = dataclasses.replace(tt.tiny_test(), hidden=D, ffn_hidden=F)
    mlp = tt.MLP(cfg)
    mlp.load_state_dict({
        "gate_proj.weight": torch.from_numpy(params["w_gate"][0].T.copy()),
        "up_proj.weight": torch.from_numpy(params["w_up"][0].T.copy()),
        "down_proj.weight": torch.from_numpy(params["w_down"][0].T.copy())})
    with torch.no_grad():
        y, aux = _port_layer(1, 2, 1.0, params)(torch.from_numpy(x))
        dense = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), dense.numpy(), atol=TOL, rtol=TOL)
    assert aux.item() == pytest.approx(1.0)  # E * f * p with E = 1


@pytest.mark.parametrize("case", ["e4_k2", "e4_k2_drops", "e4_k1"])
def test_layer_grads_match_jax_grad(case):
    E, k, cf, _ = CASES[case]
    params, x = _params(E, seed=6), _x(seed=7)
    cot = _rand(8, x.shape)
    w = 0.37

    def jloss(p, xx):
        y, cols = _jax_layer(E, k, cf).apply({"params": p}, xx,
                                             mutable=["losses"])
        return jnp.sum(y * cot) + w * cols["losses"]["moe_aux_loss"]

    jp = {n: jnp.asarray(v) for n, v in params.items()}
    gp_ref, gx_ref = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    layer = _port_layer(E, k, cf, params)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = layer(xt)
    ((y * torch.from_numpy(cot)).sum() + w * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref),
                               atol=OP_TOL, rtol=OP_TOL)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_ref[name]),
                                   atol=OP_TOL, rtol=OP_TOL, err_msg=name)
    assert float(np.abs(layer.router.grad.numpy()).max()) > 0


def _configs(**kw):
    moe_kw = dict(num_experts=4, expert_top_k=2, expert_capacity_factor=1.0)
    moe_kw.update(kw)
    return (dataclasses.replace(jt.tiny_test(), dtype=jnp.float32, **moe_kw),
            dataclasses.replace(tt.tiny_test(), dtype=torch.float32,
                                **moe_kw))


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_moe_transformer_logits_in_every_mode(kernels):
    cj, ct = _configs(use_flash_attention=kernels, use_fused_norm=kernels)
    params = jt.Transformer(cj).init(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    assert set(params["layer_0"]) == {"attn_norm", "attn", "mlp_norm",
                                      "moe_mlp"}
    model = tt.Transformer(ct, bridge.params_from_jax(jax.device_get(params)),
                           device="cpu")
    jm = jt.Transformer(cj)
    prompt = _tokens((2, 13))
    np.testing.assert_allclose(
        model(_t(prompt)).detach().numpy(),
        np.asarray(jm.apply({"params": params}, jnp.asarray(prompt))),
        atol=TOL, rtol=TOL)
    lj, varz = jm.apply({"params": params}, jnp.asarray(prompt),
                        mode="prefill", mutable=["cache"])
    cache = model.new_cache()
    lt = model(_t(prompt), mode="prefill", cache=cache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                               rtol=TOL)
    for step in range(3):
        tok = _tokens((2, 1), seed=10 + step)
        pos = np.full((2, 1), 13 + step, np.int32)
        lj, varz = jm.apply({"params": params, "cache": varz["cache"]},
                            jnp.asarray(tok), positions=jnp.asarray(pos),
                            mode="decode", mutable=["cache"])
        lt = model(_t(tok), positions=_t(pos), mode="decode", cache=cache)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL,
                                   rtol=TOL)


def test_bridge_round_trip_is_exact():
    cj, ct = _configs()
    params = jax.device_get(jt.Transformer(cj).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))["params"])
    back = bridge.params_to_jax(bridge.params_from_jax(params), ct)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    sd = bridge.init_params(ct, seed=0, device="cpu", dtype=torch.bfloat16)
    assert sd["layers.0.moe_mlp.router"].dtype == torch.float32
    assert sd["layers.0.moe_mlp.w_gate"].dtype == torch.bfloat16
    assert sd["layers.1.moe_mlp.w_down"].shape == (4, ct.ffn_hidden,
                                                   ct.hidden)
    assert not any(".mlp." in n for n in sd)


def test_make_moe_apply_fn_matches_reference():
    cj, ct = _configs()
    params = jt.Transformer(cj).init(jax.random.PRNGKey(2),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    model = tt.Transformer(ct, bridge.params_from_jax(jax.device_get(params)),
                           device="cpu", trainable=True)
    x = _tokens((2, 16), seed=4)
    jlogits, jaux = jtrain.make_moe_apply_fn(jt.Transformer(cj),
                                             aux_loss_weight=0.5)(
        {"params": params}, jnp.asarray(x))
    logits, aux = ttrain.make_moe_apply_fn(model, aux_loss_weight=0.5)(
        model, _t(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=TOL, rtol=TOL)
    # expert parallelism is ported (tests/test_torch_moe_ep.py): the
    # rule shards the expert stacks' leading dim over ep, nothing else
    assert moe.expert_sharding_rule(("w_gate",), object()) == ("ep",)
    assert moe.expert_sharding_rule("layers.0.moe_mlp.w_down", None) == \
        ("ep",)
    assert moe.expert_sharding_rule("layers.0.moe_mlp.router", None) is None


def test_fit_loss_curve_matches_jax():
    """5 Adam steps of the MoE model through ``make_moe_apply_fn`` in
    both frameworks' fit, the same batches."""
    L, B, steps = 16, 4, 5
    cj, ct = _configs(expert_capacity_factor=1.25)
    params = jt.Transformer(cj).init(jax.random.PRNGKey(5),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    model = tt.Transformer(ct, bridge.params_from_jax(jax.device_get(params)),
                           device="cpu", trainable=True)
    batches = [_tokens((B, L), seed=20 + i) for i in range(steps)]
    jopt = jtrain.default_optimizer(3e-3)
    jres = jtrain.fit(jtrain.make_moe_apply_fn(jt.Transformer(cj)),
                      jtrain.lm_loss, jopt,
                      jtrain.init_state({"params": params}, jopt),
                      make_mesh(MeshConfig(), jax.devices()[:1]),
                      iter([(b, b) for b in batches]), steps=steps,
                      preemption_save=False)
    topt = ttrain.default_optimizer(3e-3)
    it = tdata.prefetch_to_device(((b, b) for b in batches), "cpu")
    try:
        tres = ttrain.fit(ttrain.make_moe_apply_fn(model), ttrain.lm_loss,
                          topt, ttrain.init_state(model, topt), it,
                          steps=steps, preemption_save=False)
    finally:
        it.close()
    assert len(tres.losses) == steps
    np.testing.assert_allclose(tres.losses, jres.losses, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
