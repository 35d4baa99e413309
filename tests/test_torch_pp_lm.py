"""The pipeline-parallel LM of the port (``k8s_tpu_torch/models/pp_lm.py``,
``train_lm --pp``) against the JAX package's ``k8s_tpu/models/pp_lm.py``.

- ``split_lm_params`` / ``merge_lm_params`` round trips, and the
  device-major chunk order of the interleaved layout equal to the
  reference's;
- ``pp_loss_and_grads`` and ``pp_apply`` with the ranks as threads of
  this process (``ThreadRing``) at pp 2 and pp 4, 1F1B and interleaved
  (v 2), against JAX's on a virtual mesh with pp = S: the loss and every
  gradient, the tied embedding's on both end ranks (bit-equal there);
- one gloo world of 2 (``tests/torch_world.py`` ``pp`` worker): 3 steps of
  ``make_pp_train_step`` with the clip active, 1F1B and interleaved,
  against JAX's ``make_pp_train_step``, and ``train_lm --pp 2`` and
  ``--pp 2 --pp_virtual 2`` for 4 steps, and for 2 then 4 steps resumed
  from DCP, equal to the uninterrupted run and to the same run at one
  process.  The tiny preset has 2 layers, which do not divide into 2 x 2
  chunks, so these runs use ``tiny_test`` raised to 4 layers.

The tiny Transformer in f32, its weights carried across by
``bridge.params_from_jax``.  Loss and gradients at 1e-5 (rtol) / 2e-6
(atol): the same f32 computation re-scheduled, whose microbatch sums and
the tied embedding's two parts reorder f32 additions (a few ulps of
gradients up to ~0.1), as ``test_torch_sp_train.py``.  Three AdamW steps
at lr 3e-4 with the clip at 0.1 (clipping every step): losses at rtol
1e-5, final weights at atol 5e-6 (Adam moves a weight by ~lr * g/|g|,
so a ~1e-8 gradient residue at a ~1e-5 gradient moves it ~lr * 1e-3 a
step, as there), and the gradient at the final weights at the tolerance
above.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from k8s_tpu.models import pp_lm as jpp
from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.parallel import pipeline as jpl
from k8s_tpu.parallel.mesh import MeshConfig, make_mesh
from k8s_tpu_torch import train_lm
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import pp_lm as tpp
from k8s_tpu_torch.models import transformer as tt
from k8s_tpu_torch.parallel.collectives import ThreadRing

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

RTOL, ATOL, PARAM_ATOL = 1e-5, 2e-6, 5e-6
B, L = 8, 16
OPT = dict(lr=3e-4, weight_decay=0.01, clip_norm=0.1)
LM_FLAGS = ["--device=cpu", "--preset=tiny", "--batch_size=8",
            "--seq_len=32", "--learning_rate=3e-4", "--clip_norm=1.0",
            "--log_every=1", "--checkpoint_every=2"]


def _params(layers, seed=7):
    cfg = dataclasses.replace(jt.tiny_test(), layers=layers)
    params = jax.device_get(jt.Transformer(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, L), jnp.int32))["params"])
    return params, bridge.params_from_jax(params)


def _tokens(shape, seed=11):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _configs(layers):
    return (dataclasses.replace(jt.tiny_test(), layers=layers),
            dataclasses.replace(tt.tiny_test(), layers=layers))


def _jax_grads_by_name(grads, S, v):
    """The reference's split-layout gradients under the port's names."""
    merged = jpp.merge_lm_params(jax.device_get(grads), S, v)["params"]
    return {n: t.numpy() for n, t in bridge.params_from_jax(merged).items()}


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("S,v", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_split_merge_round_trip_and_chunk_order(S, v):
    params, sd = _params(8)
    split = tpp.split_lm_params(sd, S, v)
    assert len(split["stages"]) == S * v
    merged = tpp.merge_lm_params(split, S, v)
    assert set(merged) == set(sd)
    assert all(torch.equal(merged[n], sd[n]) for n in sd)
    # chunk i of the (device-major) list holds the reference's chunk i:
    # label every layer with its index on both sides
    jlabels = {"embedding": np.zeros(1), "final_norm": {"scale": np.zeros(1)},
               **{f"layer_{i}": {"scale": np.array([i])} for i in range(8)}}
    want = np.asarray(jpp.split_lm_params(
        {"params": jlabels}, S, v)["stages"]["block_0"]["scale"])[:, 0]
    tlabels = {"embedding": torch.zeros(1),
               "final_norm.scale": torch.zeros(1),
               **{f"layers.{i}.scale": torch.tensor([i]) for i in range(8)}}
    got = [int(c["block_0.scale"]) for c in
           tpp.split_lm_params(tlabels, S, v)["stages"]]
    assert got == want.tolist()
    # each rank's LmStage holds exactly its chunks' layers
    for r in range(S):
        stage = tpp.LmStage(_configs(8)[1], sd, rank=r, num_stages=S,
                            num_virtual=v, device="cpu")
        want_layers = sorted(i for c in tpp.stage_layers(8, r, S, v)
                             for i in c)
        assert sorted(int(k) for k in stage.layers) == want_layers
        owners = tpp.pp_state_shardings(stage.config, S, v)
        assert all(r in owners[n] for n, _ in stage.named_parameters())


def test_split_refuses_indivisible_layers_as_the_reference():
    params, sd = _params(2)
    with pytest.raises(ValueError, match="2 layers not divisible into 3"):
        jpp.split_lm_params({"params": params}, 3)
    with pytest.raises(ValueError, match="2 layers not divisible into 3"):
        tpp.split_lm_params(sd, 3)


@pytest.mark.parametrize("S,v,M", [(2, 1, 4), (4, 1, 4), (2, 2, 4),
                                   (4, 2, 8)])
def test_pp_loss_and_grads_match_jax(S, v, M):
    cj, ct = _configs(8)
    params, sd = _params(8)
    tokens = _tokens((B, L))
    mesh = make_mesh(MeshConfig(pp=S), jax.devices()[:S])
    j_loss, j_grads = jpp.pp_loss_and_grads(
        mesh, cj, jpp.split_lm_params({"params": params}, S, v),
        jnp.asarray(tokens), jnp.asarray(tokens), num_stages=S,
        num_microbatches=M, num_virtual=v)
    want = _jax_grads_by_name(j_grads, S, v)

    def body(rings):
        stage = tpp.LmStage(ct, sd, rank=rings.pp.rank, num_stages=S,
                            num_virtual=v, device="cpu")
        t = torch.from_numpy(tokens).long()
        return tpp.pp_loss_and_grads(rings, ct, stage, t, t,
                                     num_microbatches=M, num_virtual=v)

    res = ThreadRing.run_mesh(1, 1, body, pp=S)
    seen = set()
    for r, (loss, grads) in enumerate(res):
        _close(float(loss), float(j_loss), f"loss on rank {r}")
        for n, g in grads.items():
            _close(g, want[n], f"rank {r} {n}")
            seen.add(n)
    assert seen == set(want)
    # the tied embedding's gradient is bit-equal on the two end ranks
    assert torch.equal(res[0][1]["embedding"], res[-1][1]["embedding"])


def test_pp_apply_matches_jax():
    S, M = 2, 4
    cj, ct = _configs(4)
    params, sd = _params(4)
    tokens = _tokens((B, L), seed=12)
    mesh = make_mesh(MeshConfig(pp=S), jax.devices()[:S])
    want = jpp.pp_apply(mesh, cj, jpp.split_lm_params({"params": params}, S),
                        jnp.asarray(tokens), num_stages=S,
                        num_microbatches=M)

    def body(rings):
        stage = tpp.LmStage(ct, sd, rank=rings.pp.rank, num_stages=S,
                            device="cpu")
        return tpp.pp_apply(rings, ct, stage,
                            torch.from_numpy(tokens).long(),
                            num_microbatches=M)

    out = ThreadRing.run_mesh(1, 1, body, pp=S)
    assert out[0] is None
    np.testing.assert_allclose(out[1].numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# -- a gloo world of 2 -------------------------------------------------------

CASES = {"f1b": dict(pp=2, num_virtual=1, M=4),
         "interleaved": dict(pp=2, num_virtual=2, M=4)}
STEPS = 3


def _jax_train(case, params, tokens):
    S, v, M = case["pp"], case["num_virtual"], case["M"]
    cfg = _configs(4)[0]
    mesh = make_mesh(MeshConfig(pp=S), jax.devices()[:S])
    opt = jtrain.default_optimizer(OPT["lr"], OPT["weight_decay"],
                                   clip_norm=OPT["clip_norm"])
    state = jtrain.init_state(jpp.split_lm_params(
        jax.tree.map(jnp.array, {"params": params}), S, v), opt)
    sh = jpp.pp_state_shardings(state, mesh, num_virtual=v)
    state = jax.device_put(state, sh)
    step = jpp.make_pp_train_step(cfg, opt, mesh, num_stages=S,
                                  num_microbatches=M, num_virtual=v,
                                  state_shardings=sh)
    losses = []
    for t in tokens:
        state, loss = step(state, (jnp.asarray(t), jnp.asarray(t)))
        losses.append(float(loss))
    final = jax.device_get(state["params"])
    _, grads = jpp.pp_loss_and_grads(
        mesh, cfg, final, jnp.asarray(tokens[0]), jnp.asarray(tokens[0]),
        num_stages=S, num_microbatches=M, num_virtual=v)
    return (losses, _jax_grads_by_name(final, S, v),
            _jax_grads_by_name(grads, S, v))


def _lm_losses(recs, key="loss"):
    return [r[key] for r in recs if key in r]


@pytest.fixture
def tiny4(monkeypatch):
    """train_lm's tiny preset raised to 4 layers (2 stages x 2 chunks)."""
    orig = tt.tiny_test
    monkeypatch.setattr(tt, "tiny_test",
                        lambda: dataclasses.replace(orig(), layers=4))


def test_world_of_two_pp_step_and_train_lm(tmp_path, tiny4):
    params, sd = _params(4)
    tokens = _tokens((STEPS, B, L))
    lm = {"lm_f1b": [*LM_FLAGS, "--pp=2"],
          "lm_interleaved": [*LM_FLAGS, "--pp=2", "--pp_virtual=2"]}
    with open(tmp_path / "in.json", "w") as f:
        json.dump({"cases": [{"name": n, **c, "config": {"layers": 4}}
                             for n, c in CASES.items()],
                   "opt": OPT, "train_lm": lm, "train_lm_layers": 4}, f)
    np.savez(tmp_path / "in.npz", tokens=tokens,
             **{f"param/{n}": t.numpy() for n, t in sd.items()})
    rcs, outs = torch_world.spawn(
        2, ["tests/torch_world.py", "pp", str(tmp_path)], timeout=150)
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    got = json.load(open(tmp_path / "out.json"))

    for name, case in CASES.items():
        jlosses, jparams, jgrads = _jax_train(case, params, tokens)
        _close(got[name]["losses"], jlosses, f"{name} losses", atol=1e-6)
        assert got[name]["count"] == [STEPS]
        # rank 0 holds the most ring inputs: the reference's memory figure
        sched = "interleaved" if case["num_virtual"] > 1 else "1f1b"
        assert got[name]["peak_stashed"] == \
            jpl.peak_activation_microbatches(sched, case["M"], case["pp"],
                                             case["num_virtual"])
        ranks = [dict(np.load(tmp_path / f"out_{name}_{r}.npz"))
                 for r in range(2)]
        for r, arrs in enumerate(ranks):
            for key, a in arrs.items():
                kind, n = key.split("/", 1)
                want = jparams[n] if kind == "param" else jgrads[n]
                _close(a, want, f"{name} rank {r} {key}",
                       atol=PARAM_ATOL if kind == "param" else ATOL)
        # the tied embedding's two copies stayed bit-equal
        np.testing.assert_array_equal(ranks[0]["param/embedding"],
                                      ranks[1]["param/embedding"])

    # train_lm --pp: a resumed run ends where the uninterrupted one ends,
    # and the pipelined losses are the one-process run's
    one = tmp_path / "one"
    assert train_lm.main([*LM_FLAGS, f"--train_dir={one}",
                          "--train_steps=4"]) == 0
    plain = _lm_losses([json.loads(x) for x in open(one / "metrics.jsonl")])
    for name in lm:
        run = got[name]
        (rc_w, whole), (rc_f, _), (rc_r, resumed) = (
            run["whole"], run["first"], run["resumed"])
        assert (rc_w, rc_f, rc_r) == (0, 0, 0)
        assert [r["step"] for r in resumed if "loss" in r] == [1, 2, 3, 4]
        assert _lm_losses(resumed)[2:] == _lm_losses(whole)[2:]
        assert {"1", "3"} <= set(run["files"])
        np.testing.assert_allclose(_lm_losses(whole), plain, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
