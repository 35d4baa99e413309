"""A Mixture-of-Experts model served by the port, against the JAX server on
the same parameters (tiny, f32, CPU): greedy tokens single-flight and
through the continuous-batching engine (requests one at a time, so the
same rows, the engine's idle rows at ``pad_id`` included, compete for
expert capacity in both), with capacity loose and tight enough to drop
pairs.  The serving artifact round-trips the MoE ``model_config.json``
and serves through ``serve_lm``; the served router stays f32 under a
bf16 config, as the reference serves it with ``param_dtype="model"``."""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import serving as jax_serving
from k8s_tpu.models import server as jax_server
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.util.metrics import Registry as JaxRegistry
from k8s_tpu_torch import serve_lm
from k8s_tpu_torch.models import bridge, moe, serving
from k8s_tpu_torch.models import server as server_mod
from k8s_tpu_torch.models.transformer import TransformerConfig, Transformer
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

SHAPE = dict(vocab_size=256, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=128, remat=False, num_experts=4,
             expert_top_k=2)
PROMPTS = [[3, 5, 7], [9] * 20, list(range(1, 40)),
           [(7 * i + 2) % 256 for i in range(17)]]


def _pair(cf):
    cj = JaxConfig(dtype=jnp.float32, expert_capacity_factor=cf, **SHAPE)
    ct = TransformerConfig(dtype=torch.float32, expert_capacity_factor=cf,
                           **SHAPE)
    params = JaxTransformer(cj).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 5), jnp.int32))["params"]
    # the reference's expert init is N(0, 0.02): widen the router so the
    # routing (and the capacity drops) vary from token to token
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if p[-1].key == "router" else v, params)
    return cj, ct, params, bridge.params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module", params=[1.25, 0.5], ids=["loose", "tight"])
def servers(request):
    cj, ct, params, sd = _pair(request.param)
    lms = {"jax_single": jax_server.LmServer(config=cj, params=params,
                                             slots=0, registry=JaxRegistry()),
           "jax_engine": jax_server.LmServer(config=cj, params=params,
                                             slots=2, registry=JaxRegistry()),
           "port_single": server_mod.LmServer(config=ct, params=sd, slots=0,
                                              device="cpu"),
           "port_engine": server_mod.LmServer(config=ct, params=sd, slots=2,
                                              device="cpu")}
    yield ct, lms
    for lm in lms.values():
        lm.close()


def _answer(lm, parse, cfg, body):
    return lm.generate(parse(cfg, body, 8))["tokens"]


@pytest.mark.parametrize("lane", ["single", "engine"])
def test_greedy_tokens_are_the_jax_servers(servers, lane):
    ct, lms = servers
    jlm, tlm = lms[f"jax_{lane}"], lms[f"port_{lane}"]
    for i, p in enumerate(PROMPTS):
        body = {"tokens": p, "max_new_tokens": 9}
        want = _answer(jlm, jax_server.parse_request, jlm.config, body)
        got = _answer(tlm, server_mod.parse_request, ct, body)
        assert got == want, (lane, i)
    if lane == "engine":
        assert tlm.engine.stats()["completed"] >= len(PROMPTS)


def test_tight_capacity_drops_pairs_at_decode():
    """At capacity factor 0.5 a 2-row decode call keeps C = 1 pair per
    expert: the engine's idle row competes with the live one."""
    _, ct, _, sd = _pair(0.5)
    model = Transformer(ct, sd, device="cpu")
    h = torch.randn(2, 1, ct.hidden, generator=torch.Generator().manual_seed(0))
    *_, keep, C = moe.route(h.reshape(2, -1),
                            model.layers[0].moe_mlp.router, 2, 0.5)
    assert C == 1 and not bool(keep.all())


def test_artifact_round_trip_and_serve_lm(tmp_path, capsys):
    cj, ct, params, sd = _pair(1.25)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_serving.export_serving(jdir, cj, {"params": params})
    serving.export_serving(tdir, ct, sd)
    with open(os.path.join(jdir, "serving", "model_config.json")) as f:
        jcfg = json.load(f)
    with open(os.path.join(tdir, "serving", "model_config.json")) as f:
        tcfg = json.load(f)
    assert tcfg == jcfg
    assert (tcfg["num_experts"], tcfg["expert_top_k"],
            tcfg["expert_capacity_factor"]) == (4, 2, 1.25)
    # the reference's own config file loads in the port
    assert serving.load_config(jdir) == ct
    cfg2, sd2 = serving.load_for_serving(tdir, device="cpu")
    assert cfg2 == ct and set(sd2) == set(sd)
    assert all(torch.equal(sd2[k], sd[k]) for k in sd)
    assert serve_lm.main([f"--train_dir={tdir}", "--tokens=5,12,99,5",
                          "--max_new_tokens=6", "--device=cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    jlm = jax_server.LmServer(config=cj, params=params, slots=0,
                              registry=JaxRegistry())
    try:
        want = _answer(jlm, jax_server.parse_request, cj,
                       {"tokens": [5, 12, 99, 5], "max_new_tokens": 6})
    finally:
        jlm.close()
    assert line == ",".join(map(str, want))


def test_served_router_stays_f32():
    ct = dataclasses.replace(TransformerConfig(**SHAPE),
                             dtype=torch.bfloat16)
    sd = bridge.init_params(ct, seed=1, device="cpu", dtype=torch.float32)
    lm = server_mod.LmServer(config=ct, params=sd, slots=2, device="cpu")
    try:
        layer = lm.model.layers[0].moe_mlp
        assert layer.router.dtype == torch.float32
        assert torch.equal(layer.router, sd["layers.0.moe_mlp.router"])
        for name in ("w_gate", "w_up", "w_down"):
            assert getattr(layer, name).dtype == torch.bfloat16
        toks = lm.generate(server_mod.parse_request(
            ct, {"tokens": [1, 2, 3], "max_new_tokens": 4}, 4))["tokens"]
        assert len(toks) == 4 and all(0 <= t < 256 for t in toks)
    finally:
        lm.close()
    # bf16 serving (param_dtype="bfloat16") casts every f32 leaf, the
    # router too, as the reference's cast_params_for_serving does
    cast = serving.cast_params_for_serving(sd)
    assert cast["layers.0.moe_mlp.router"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        cast["layers.0.attn_norm.scale"].float().numpy(), np.ones(32))
