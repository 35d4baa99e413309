"""The port's sharded train step (``models/train.py``
``shard_train_state`` / ``make_sharded_train_step`` through
``fit(mesh=...)``) in gloo worlds of 2 (fsdp 2) and 4 (dp 2 x fsdp 2, the
hybrid mesh of a 2-slice job) against the JAX package's
``make_sharded_train_step`` on a virtual mesh of the same shape, and
against the port's own unsharded step; and ``train_lm`` at 2 processes
against 1.

The tiny Transformer in f32, its weights carried across by
``bridge.params_from_jax``; AdamW with a clip norm low enough to clip
every step; 3 steps, and a ``grad_accum=2`` case.  Losses and final
parameters at rtol 1e-5 / atol 1e-6: the shards' sums reorder the f32
arithmetic.  Adam's first steps move a weight by about ``lr * g / |g|``,
so a gradient that is a cancellation residue (~1e-10, where any
reordering changes a few percent of it) moves by a different amount in
every layout by about ``lr * 1e-3``; at lr 3e-4 that stays under the
atol.  Because clipping and Adam are blind to a gradient's overall scale,
the gradient at the final weights on the first batch is compared as
well (FSDP's average over the data shards).  The worlds run as
subprocesses (``tests/torch_world.py``); each also restores its final
checkpoint (``torch.distributed.checkpoint``) into a fresh sharded state
and reports the update count and the weights it got back.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_world
from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.parallel.mesh import (
    DcnConfig, MeshConfig, make_hybrid_mesh, make_mesh,
)
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import train as ttrain
from k8s_tpu_torch.models import transformer as tt

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

RTOL, ATOL = 1e-5, 1e-6
STEPS, B, L = 3, 4, 16
OPT = dict(lr=3e-4, weight_decay=0.01, clip_norm=0.1)


def _jax_run(mesh, params, tokens, grad_accum):
    cfg = jt.tiny_test()
    model = jt.Transformer(cfg)
    opt = jtrain.default_optimizer(OPT["lr"], OPT["weight_decay"],
                                   clip_norm=OPT["clip_norm"])
    state, shardings = jtrain.shard_train_state(
        jtrain.init_state({"params": params}, opt), mesh)
    step = jtrain.make_sharded_train_step(
        model.apply, jtrain.lm_loss, opt, mesh, shardings,
        grad_accum=grad_accum)
    losses = []
    for t in tokens:
        state, loss = step(state, (jnp.asarray(t), jnp.asarray(t)))
        losses.append(float(loss))
    params = jax.device_get(state["params"]["params"])
    grads = jax.grad(lambda p: jtrain.lm_loss(
        model.apply({"params": p}, tokens[0]), tokens[0]))(params)
    return losses, params, grads


def _port_unsharded(sd, tokens, grad_accum):
    model = tt.Transformer(tt.tiny_test(), sd, device="cpu", trainable=True)
    opt = ttrain.default_optimizer(**OPT)
    state = ttrain.init_state(model, opt)
    step = ttrain.make_train_step(lambda m, x: m(x), ttrain.lm_loss, opt,
                                  grad_accum=grad_accum)
    losses = []
    for t in tokens:
        t = torch.from_numpy(t)
        state, loss = step(state, (t, t))
        losses.append(loss.item())
    return losses, {n: p.detach().numpy()
                    for n, p in model.named_parameters()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def inputs():
    params = jax.device_get(jt.Transformer(jt.tiny_test()).init(
        jax.random.PRNGKey(7), jnp.zeros((1, L), jnp.int32))["params"])
    tokens = np.random.default_rng(11).integers(
        0, 256, (STEPS, B, L)).astype(np.int32)
    sd = bridge.params_from_jax(params)
    # the clip is active: the first step's gradient norm is above it
    grads = jax.grad(lambda p: jtrain.lm_loss(
        jt.Transformer(jt.tiny_test()).apply({"params": p}, tokens[0]),
        tokens[0]))(params)
    assert float(optax.global_norm(grads)) > 5 * OPT["clip_norm"]
    return params, sd, tokens


@pytest.mark.parametrize("world,slices,grad_accum", [
    (2, 1, 1), (2, 1, 2), (4, 2, 1)], ids=["fsdp2", "fsdp2-accum2",
                                          "dp2xfsdp2-hybrid"])
def test_sharded_step_matches_jax_and_unsharded(tmp_path, inputs, world,
                                                slices, grad_accum):
    params, sd, tokens = inputs
    with open(tmp_path / "in.json", "w") as f:
        json.dump({"config": {}, "opt": OPT, "grad_accum": grad_accum}, f)
    np.savez(tmp_path / "in.npz", tokens=tokens,
             **{f"param/{n}": t.numpy() for n, t in sd.items()})
    rcs, outs = torch_world.spawn(
        world, ["tests/torch_world.py", "fsdp", str(tmp_path)],
        num_slices=slices)
    assert rcs == [0] * world, "\n".join(o[-1500:] for o in outs)
    got = json.load(open(tmp_path / "out.json"))
    port = dict(np.load(tmp_path / "out.npz"))

    devices = jax.devices()[:world]
    if slices > 1:
        mesh = make_hybrid_mesh(MeshConfig(fsdp=world // slices),
                                DcnConfig(dp=slices), devices)
    else:
        mesh = make_mesh(MeshConfig(fsdp=world), devices)
    assert got["mesh"] == {k: int(v) for k, v in mesh.shape.items()}
    assert got["data_shard"] == [0, world]
    jlosses, jparams, jgrads = _jax_run(mesh, params, tokens, grad_accum)
    _close(got["losses"], jlosses, "losses vs jax")
    want = bridge.params_from_jax(jparams)
    assert sorted(port) == sorted([*want, *(f"grad/{n}" for n in want)])
    for name, t in want.items():
        _close(port[name], t.numpy(), f"{name} vs jax")
    for name, t in bridge.params_from_jax(jgrads).items():
        _close(port[f"grad/{name}"], t.numpy(), f"{name} gradient vs jax")

    ulosses, uparams = _port_unsharded(sd, tokens, grad_accum)
    _close(got["losses"], ulosses, "losses vs the unsharded step")
    for name, a in uparams.items():
        _close(port[name], a, f"{name} vs the unsharded step")

    # the DCP round trip: weights, moments and the schedule's count
    assert got["count"] == [STEPS] and got["restored_count"] == [STEPS]
    assert got["restored_step"] == STEPS and got["next_step"] == STEPS
    assert got["restored_equal"]
    # the first step (no checkpoint yet, the orbax policy) and the last
    assert got["ckpt_steps"] == [0, STEPS - 1]
    assert ".metadata" in got["ckpt_files"]
    assert sum(f.endswith(".distcp") for f in got["ckpt_files"]) == world


def test_shard_train_state_refuses_model_axes_and_resharding():
    # pp and ep meshes are accepted since pipeline and expert parallelism
    # are ported (tests/test_torch_pp_lm.py, test_torch_moe_ep.py); what
    # stays refused is sharding a state twice, and a pipeline stage
    # counts as sharded (each rank holds its own part)
    from k8s_tpu_torch.models import pp_lm

    cfg = tt.tiny_test()
    stage = pp_lm.LmStage(cfg, bridge.init_params(
        cfg, 0, "cpu", dtype=torch.float32), rank=0, num_stages=2,
        device="cpu")
    state = ttrain.init_state(stage, ttrain.default_optimizer(1e-3))
    assert ttrain.is_sharded(stage)
    with pytest.raises(ValueError, match="sharded already"):
        ttrain.shard_train_state(state, object())
    model = tt.Transformer(cfg, bridge.init_params(
        cfg, 0, "cpu", dtype=torch.float32), device="cpu", trainable=True)
    assert not ttrain.is_sharded(model)


LM_ARGS = ["--preset=tiny", "--batch_size=8", "--seq_len=64",
           "--learning_rate=1e-2", "--log_every=1", "--clip_norm=1.0",
           "--checkpoint_every=2"]


def _metric_losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_train_lm_two_processes_log_the_one_process_losses(tmp_path):
    """``python -m k8s_tpu_torch.train_lm`` under the operator's env at 2
    processes (no ``--device``: ``K8S_TPU_PLATFORM=cpu``) trains through
    the sharded fit on the same global batches as one process, checkpoints
    its shards per step directory, exports nothing, and resumes."""
    two, one = tmp_path / "two", tmp_path / "one"
    rcs, outs = torch_world.spawn(
        2, ["-m", "k8s_tpu_torch.train_lm", *LM_ARGS, "--train_steps=4",
            f"--train_dir={two}"])
    assert rcs == [0, 0], "\n".join(o[-1500:] for o in outs)
    assert all("fsdp': 2" in o for o in outs)
    r = subprocess.run(
        [sys.executable, "-m", "k8s_tpu_torch.train_lm",
         "--device=cpu", *LM_ARGS, "--train_steps=4", f"--train_dir={one}"],
        capture_output=True, text=True, cwd=torch_world.REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=torch_world.REPO))
    assert r.returncode == 0, r.stderr[-1500:]
    _close(_metric_losses(two), _metric_losses(one), "logged losses")
    assert len(_metric_losses(two)) == 4  # process 0 alone writes
    assert not (two / "serving").exists() and (one / "serving").exists()
    assert sorted(p.name for p in two.iterdir()
                  if p.is_dir()) == ["0", "2", "3"]

    rcs, outs = torch_world.spawn(
        2, ["-m", "k8s_tpu_torch.train_lm", *LM_ARGS, "--train_steps=6",
            f"--train_dir={two}"])
    assert rcs == [0, 0], "\n".join(o[-1500:] for o in outs)
    assert all("resumed from step 3" in o for o in outs)
    assert "training complete: 6 steps" in outs[0]
