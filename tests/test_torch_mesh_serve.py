"""Tensor-parallel serving in the port (models/mesh_serve.py: MeshPlacement,
the follower loop, the engine and server seams) on the CPU, in process:
the tp ranks run as ``ThreadRing`` threads and the followers replay the
chief's plan over the real plan bus on loopback.

The port's engine on a MeshPlacement at tp 1, 2 and 4 must give the JAX
engine's greedy tokens, token for token (mixed prompt lengths, a prefix
hit with a copy-on-write block, EOS, GQA at one kv head per rank, an int8
pool), as the reference pins its own tp mesh to its local engine.  On the
sampled and speculative lanes, fixed-seed tokens must equal the port's
LocalPlacement engine's.  Then the refusals (a windowed config, heads the
tp does not divide, spill and disaggregation under a mesh, the exclusive
lane at tp > 1) and the mesh fields ``serving_info`` reports, against the
reference's keys and values.  Every wait carries a timeout.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import engine as jax_engine
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu_torch.models import bridge, mesh_serve
from k8s_tpu_torch.models.engine import Engine
from k8s_tpu_torch.models.server import LmServer, serve
from k8s_tpu_torch.models.transformer import TransformerConfig
from k8s_tpu_torch.parallel import collectives
from k8s_tpu_torch.util import metrics as metrics_mod
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

WAIT = 60
SHAPE = dict(vocab_size=61, hidden=64, ffn_hidden=128, layers=2, heads=8,
             kv_heads=4, max_seq_len=64, remat=False)
ENGINE = dict(slots=2, queue_limit=32, block_size=8, prefix_blocks=24)
SETUPS = {"fp": {}, "int8": dict(kv_cache_dtype="int8")}


def prompt_of(length, seed=0):
    return np.asarray([(seed * 13 + i * 7 + length) % 61
                       for i in range(length)], np.int64)


P20 = prompt_of(20, 1)
# greedy requests, in order: mixed lengths, a 12-token share of P20 (one
# whole block attached, a copy-on-write of the next), an EOS stop
GREEDY = [(prompt_of(5), 8, None), (P20, 6, None),
          (np.concatenate([P20[:12], prompt_of(5, 7)]), 6, None),
          (prompt_of(13, 3), 7, None), (prompt_of(9, 4), 8, "eos")]
# the three lanes at fixed seeds, the reference's in-process set
THREE_LANES = [
    dict(ids=np.arange(5) + 1, max_new_tokens=8),
    dict(ids=np.arange(5) + 1, max_new_tokens=8, temperature=1.0, seed=3),
    dict(ids=np.asarray([9, 8, 7, 6, 5, 4, 3, 2, 1] * 2), max_new_tokens=6,
         temperature=0.7, top_k=5, seed=11),
    dict(ids=np.asarray([1, 2, 3, 1, 2, 3, 1, 2]), max_new_tokens=8,
         speculative=3),
    dict(ids=np.asarray([4, 5, 6, 4, 5, 6, 4, 5, 6, 4]), max_new_tokens=8,
         speculative=4, temperature=0.9, seed=21),
]


class _Ring(collectives.Ring):
    """A ring of a given size, rank 0, for checks that never reach a
    collective."""

    def __init__(self, size):
        self.size = size


@pytest.fixture(scope="module")
def params():
    cj = JaxConfig(dtype=jnp.float32, **SHAPE)
    p = JaxTransformer(cj).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 5), jnp.int32))["params"]
    return p, bridge.params_from_jax(jax.device_get(p))


def configs(setup="fp"):
    extra = SETUPS[setup]
    return (JaxConfig(dtype=jnp.float32, **SHAPE, **extra),
            TransformerConfig(dtype=torch.float32, **SHAPE, **extra))


def _eos(tokens):
    return tokens[3]  # a token the greedy run emits mid-way


@pytest.fixture(scope="module")
def jax_greedy(params):
    """The JAX engine's greedy tokens for GREEDY, per setup (the EOS
    request's stop token is its own fourth token without EOS)."""
    out = {}
    for setup in SETUPS:
        eng = jax_engine.Engine(configs(setup)[0], params[0], **ENGINE)
        try:
            toks = []
            for ids, n, eos in GREEDY:
                eos_id = _eos(eng.submit(ids.astype(np.int32), n)) \
                    if eos else None
                toks.append((eos_id, eng.submit(ids.astype(np.int32), n,
                                                eos_id=eos_id)))
            out[setup] = toks
        finally:
            eng.shutdown()
    return out


def _mesh_run(tp, cfg, sd, requests):
    """``requests`` (submit kwargs) in order through the port's engine on
    a tp mesh of threads; returns the tokens, the stats and the
    followers' reports."""
    def chief(placement):
        eng = Engine(cfg, sd, placement=placement, **ENGINE)
        try:
            return [eng.submit(**r, timeout=WAIT) for r in requests], \
                eng.stats()
        finally:
            eng.shutdown()
    (toks, stats), reports = mesh_serve.run_in_threads(
        tp, cfg, sd, chief, device="cpu", timeout=WAIT)
    return toks, stats, reports


@pytest.mark.parametrize("setup,tp", [("fp", 1), ("fp", 2), ("fp", 4),
                                      ("int8", 2)])
def test_mesh_engine_gives_the_jax_engines_greedy_tokens(
        params, jax_greedy, setup, tp):
    cfg = configs(setup)[1]
    reqs = [dict(ids=ids, max_new_tokens=n, eos_id=eos)
            for (ids, n, _), (eos, _) in zip(GREEDY, jax_greedy[setup])]
    toks, stats, reports = _mesh_run(tp, cfg, params[1], reqs)
    assert toks == [list(t) for _, t in jax_greedy[setup]]
    assert (stats["placement"], stats["tp_degree"], stats["mesh_shape"],
            stats["num_processes"]) == ("mesh", tp, {"tp": tp}, 1)
    assert stats["prefix_hits"] >= 1 and stats["cow_copies"] >= 1
    assert len(reports) == tp - 1
    for r in reports:
        assert r["pool_local_fraction"] == round(1 / tp, 4)
        assert 1 / tp < r["params_local_fraction"] < 1
        assert r["ops"] > 0 and r["compile_ledger"] is None


@pytest.mark.parametrize("tp", [2, 4])
def test_sampled_and_speculative_lanes_equal_the_local_engine(params, tp):
    cfg = configs()[1]
    local = Engine(cfg, params[1], device="cpu", **ENGINE)
    try:
        want = [local.submit(**r, timeout=WAIT) for r in THREE_LANES]
        want_stats = local.stats()
    finally:
        local.shutdown()
    toks, stats, _ = _mesh_run(tp, cfg, params[1], THREE_LANES)
    assert toks == want
    assert stats["spec_steps"] == want_stats["spec_steps"] > 0


def test_windowed_config_is_refused_on_a_mesh(params):
    cfg = dataclasses.replace(configs()[1], window_size=16, prefill_chunk=8)
    sd = bridge.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="paged block pool"):
        mesh_serve.run_in_threads(
            2, cfg, sd, lambda pl: Engine(cfg, sd, slots=2, placement=pl),
            device="cpu", timeout=WAIT)


def test_heads_the_tp_does_not_divide_are_refused():
    cfg = configs()[1]  # kv_heads 4
    with pytest.raises(ValueError, match="does not shard over tp=8"):
        mesh_serve.MeshPlacement(cfg, _Ring(8), device="cpu")


def test_spill_and_disaggregation_are_off_under_a_mesh(params):
    cfg = configs()[1]
    eng = Engine(cfg, params[1], slots=2, spill_mb=16,
                 placement=mesh_serve.MeshPlacement(cfg, device="cpu"))
    try:
        assert not eng.stats()["spill_enabled"]
        assert not eng.disagg_capable
        with pytest.raises(ValueError, match="single-host engines"):
            eng.prefill_export(prompt_of(9), 4, timeout=WAIT)
    finally:
        eng.shutdown()
    lm = LmServer(config=cfg, params=params[1], slots=2, role="decode",
                  registry=metrics_mod.Registry(),
                  placement=mesh_serve.MeshPlacement(cfg, device="cpu"))
    try:
        info = lm.serving_info()
        assert info["kvxfer_port"] is None and not info["spill_enabled"]
    finally:
        lm.close()


@pytest.mark.parametrize("kw", [dict(slots=0), dict(batch_sampling=False),
                                dict(batch_spec=False)],
                         ids=["single_flight", "batch_sampling_off",
                              "batch_spec_off"])
def test_the_exclusive_lane_is_refused_at_tp_above_one(params, kw):
    cfg = configs()[1]
    with pytest.raises(ValueError, match="exclusive lane"):
        LmServer(config=cfg, params=params[1], registry=metrics_mod.Registry(),
                 placement=mesh_serve.MeshPlacement(cfg, _Ring(2),
                                                    device="cpu"), **kw)


def test_the_exclusive_lane_runs_at_tp_one(params):
    """tp 1: the chief holds the whole model, so the exclusive lane runs
    and gives the local server's tokens."""
    cfg = configs()[1]
    req = {"tokens": [3, 1, 4, 1, 5], "max_new_tokens": 6,
           "temperature": 0.8, "seed": 5}
    out = {}
    for name, placement in (("mesh", mesh_serve.MeshPlacement(
            cfg, device="cpu")), ("local", None)):
        lm = LmServer(config=cfg, params=params[1], slots=2,
                      batch_sampling=False, device="cpu",
                      registry=metrics_mod.Registry(), placement=placement)
        try:
            assert lm.serving_info()["placement"] == name
            out[name] = _post(lm, req)
        finally:
            lm.close()
    assert out["mesh"] == out["local"]


def _post(lm, body):
    httpd = serve(lm)
    try:
        url = "http://%s:%d/v1/generate" % httpd.server_address[:2]
        r = urllib.request.Request(url, data=json.dumps(body).encode(),
                                   headers={"Content-Type":
                                            "application/json"})
        try:
            with urllib.request.urlopen(r, timeout=WAIT) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    finally:
        httpd.shutdown()
        httpd.server_close()


MESH_FIELDS = ("placement", "num_processes", "mesh_shape", "tp_degree")


def test_serving_info_mesh_fields_are_the_references(params):
    from k8s_tpu.models import mesh_serve as ref_mesh_serve
    from k8s_tpu.models.server import LmServer as RefLmServer
    from k8s_tpu.util.metrics import Registry as RefRegistry

    jcfg, cfg = configs()
    want = {}
    for name, placement in (
            ("mesh", ref_mesh_serve.MeshPlacement(
                jcfg, ref_mesh_serve.build_serve_mesh(tp=2))),
            ("local", None)):
        ref = RefLmServer(config=jcfg, params=params[0], slots=2,
                          queue_limit=8, registry=RefRegistry(),
                          placement=placement)
        try:
            want[name] = {k: ref.serving_info()[k] for k in MESH_FIELDS}
        finally:
            ref.close()

    def chief(placement):
        lm = LmServer(config=cfg, params=params[1], slots=2, queue_limit=8,
                      registry=metrics_mod.Registry(), placement=placement)
        try:
            info = lm.serving_info()
            # a one-token speculative prompt: the batched lane's 400 (the
            # exclusive lane's, which a tp 2 chief cannot run)
            code, body = _post(lm, {"tokens": [7], "max_new_tokens": 4,
                                    "speculative": 3})
            ok = _post(lm, {"tokens": [7, 8, 9], "max_new_tokens": 4})
        finally:
            lm.close()
        return info, (code, body), ok

    (info, bad, ok), _ = mesh_serve.run_in_threads(
        2, cfg, params[1], chief, device="cpu", timeout=WAIT)
    assert {k: info[k] for k in MESH_FIELDS} == want["mesh"]
    assert bad[0] == 400 and "prompt_len >= 2" in bad[1]["error"]
    assert ok[0] == 200 and len(ok[1]["tokens"]) == 4
    lm = LmServer(config=cfg, params=params[1], slots=2, queue_limit=8,
                  registry=metrics_mod.Registry(), device="cpu")
    try:
        assert {k: lm.serving_info()[k] for k in MESH_FIELDS} == \
            want["local"]
    finally:
        lm.close()
