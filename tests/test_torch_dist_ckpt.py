"""The port's sharded checkpoints and multi-process ``dist_mnist`` on the
CPU, and the pod env's ``K8S_TPU_PLATFORM`` (``launcher/bootstrap.py``).

- ``models/checkpoint.py`` over an FSDP-sharded state in a gloo world of
  2 (``tests/torch_world.py ckpt``): the orbax interval and
  ``max_to_keep`` policy, a ``torch.distributed.checkpoint`` round trip
  of weights, moments, the schedule's count and the step, and an
  ``async_save`` that keeps what it was handed while the next step moves
  the weights; ``wait()`` joins it.
- ``save_on_preemption`` on SIGTERM, as ``tests/test_checkpoint.py``
  holds the reference's, and the one-process async save.
- ``python -m k8s_tpu_torch.dist_mnist`` at 2 processes (the operator's
  env through ``k8s_tpu.e2e.multiprocess.localhost_env``) ends with the
  one-process run's weights and optimizer count on the same global
  batches, at the MNIST tests' tolerance (1e-4 of the largest weight).
  Its learning rate is 1e-4: Adam moves a weight whose gradient is a
  cancellation residue by ~lr whatever its last digits, and the shard
  sums reorder those digits, so the weights of two layouts part by
  ~lr * 1e-2 at most over a few steps.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import torch_world
from k8s_tpu_torch import dist_mnist
from k8s_tpu_torch.launcher import bootstrap
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import checkpoint as tckpt
from k8s_tpu_torch.models import train as ttrain
from k8s_tpu_torch.models import transformer as tt

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "tests", "fixtures", "mnist")


def _state(seed):
    cfg = tt.tiny_test()
    model = tt.Transformer(cfg, bridge.init_params(cfg, seed, "cpu",
                                                   dtype=torch.float32),
                           device="cpu", trainable=True)
    return ttrain.init_state(model, ttrain.default_optimizer(1e-2))


def test_sharded_checkpoints_at_two_processes(tmp_path):
    rcs, outs = torch_world.spawn(
        2, ["tests/torch_world.py", "ckpt", str(tmp_path)])
    assert rcs == [0, 0], "\n".join(o[-1500:] for o in outs)
    got = json.load(open(tmp_path / "out.json"))
    assert got["saved"] == [0, 3, 6]  # the first save, then the interval
    assert got["kept"] == [3, 6]  # pruned to max_to_keep
    assert got["resave_refused"] and got["forced"]
    assert got["next_step"] == 8
    # the async save counts as the latest while it is in flight
    assert got["pending_latest"] == 9 and got["async_steps"] == [9]
    assert got["restored_equal"]
    assert got["async_files"] == [".metadata", "__0_0.distcp",
                                  "__1_0.distcp"]


def test_one_process_async_save_then_wait(tmp_path):
    state = _state(0)
    ck = tckpt.Checkpointer(str(tmp_path), async_save=True)
    assert ck.save(4, state) and ck.latest_step() == 4
    want = {n: p.detach().clone() for n, p in state["model"].named_parameters()}
    with torch.no_grad():
        for p in state["model"].parameters():
            p.add_(1.0)  # the copy was taken when save() returned
    ck.wait()
    assert ck.all_steps() == [4]
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    restored, nxt = ck.restore_or_init(_state(1))
    assert nxt == 5
    for n, p in restored["model"].named_parameters():
        assert torch.equal(p, want[n]), n
    ck.close()


def test_save_on_preemption_saves_on_sigterm(tmp_path, monkeypatch):
    from k8s_tpu_torch.util import signals

    # isolate the module state so other tests' handlers do not interfere
    monkeypatch.setattr(signals, "_callbacks", [])
    monkeypatch.setattr(signals, "_stop", threading.Event())
    monkeypatch.setattr(signals, "_installed", False)
    monkeypatch.setattr(signals, "_prev_handlers", {})

    ck = tckpt.Checkpointer(str(tmp_path))
    live = {"state": _state(9), "step": 41}
    unsub = ck.save_on_preemption(lambda: live["state"], lambda: live["step"])
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        # the handler runs synchronously in the main thread
        assert signals._stop.is_set()
        assert ck.latest_step() == 41
        restored, _ = ck.restore_latest(_state(0))
        for a, b in zip(restored["model"].parameters(),
                        live["state"]["model"].parameters()):
            assert torch.equal(a, b)
    finally:
        unsub()  # restore the process's SIGTERM disposition
        ck.close()


def test_save_on_preemption_skips_while_a_save_holds_the_lock(tmp_path,
                                                              monkeypatch):
    from k8s_tpu_torch.util import signals

    monkeypatch.setattr(signals, "_callbacks", [])
    monkeypatch.setattr(signals, "_stop", threading.Event())
    monkeypatch.setattr(signals, "_installed", False)
    monkeypatch.setattr(signals, "_prev_handlers", {})
    ck = tckpt.Checkpointer(str(tmp_path))
    state = _state(0)
    unsub = ck.save_on_preemption(lambda: state, lambda: 3)
    try:
        with ck._lock:  # an interval save in flight
            os.kill(os.getpid(), signal.SIGTERM)
        assert signals._stop.is_set() and ck.latest_step() is None
    finally:
        unsub()


def _mnist_args(train_dir):
    return ["--data_dir", MNIST, "--batch_size=16", "--train_steps=6",
            "--checkpoint_every=3", "--learning_rate=1e-4",
            f"--train_dir={train_dir}"]


def test_dist_mnist_two_processes_equal_one(tmp_path):
    rcs, outs = torch_world.spawn(
        2, ["-m", "k8s_tpu_torch.dist_mnist", *_mnist_args(tmp_path / "two"),
            "--eval_holdout=256"])
    assert rcs == [0, 0], "\n".join(o[-1500:] for o in outs)
    # the reference's rule: no held-out eval across processes
    assert "--eval_holdout skipped" in outs[0]
    assert outs[0].count("saved checkpoint at step") == 3
    assert "saved checkpoint" not in outs[1]  # process 0 alone writes
    one = subprocess.run(
        [sys.executable, "-m", "k8s_tpu_torch.dist_mnist", "--device=cpu",
         *_mnist_args(tmp_path / "one")], capture_output=True, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert one.returncode == 0, one.stderr[-1500:]
    a = torch.load(tmp_path / "two" / dist_mnist.CKPT_NAME, weights_only=True)
    b = torch.load(tmp_path / "one" / dist_mnist.CKPT_NAME, weights_only=True)
    assert a["step"] == b["step"] == 6
    for name, want in b["model"].items():
        got = a["model"][name].numpy()
        scale = np.abs(want.numpy()).max()
        assert np.abs(got - want.numpy()).max() <= 1e-4 * scale, name
    ga, gb = a["optimizer"]["param_groups"], b["optimizer"]["param_groups"]
    assert [g["count"] for g in ga] == [g["count"] for g in gb] == [6]
    assert ga[0]["params"] == gb[0]["params"]
    # the one-process format: a one-process run resumes from it
    resumed = subprocess.run(
        [sys.executable, "-m", "k8s_tpu_torch.dist_mnist", "--device=cpu",
         *_mnist_args(tmp_path / "two"), "--train_steps=8"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert resumed.returncode == 0, resumed.stderr[-1500:]
    assert "restored checkpoint at step 6" in resumed.stderr


def test_platform_env_picks_the_device(tmp_path, monkeypatch, caplog):
    assert bootstrap.apply_platform_env({"K8S_TPU_PLATFORM": "cpu"}) == "cpu"
    for value in ("gpu", "cuda", "GPU"):
        assert bootstrap.apply_platform_env(
            {"K8S_TPU_PLATFORM": value}) == "cuda"
    assert bootstrap.apply_platform_env({"K8S_TPU_PLATFORM": ""}) is None
    assert bootstrap.apply_platform_env({}) is None
    assert bootstrap.default_device("cpu") == "cpu"
    # the flag wins over the env, the env over the cuda default
    monkeypatch.setenv("K8S_TPU_PLATFORM", "cpu")
    assert bootstrap.default_device(None) == "cpu"
    assert bootstrap.default_device("cuda") == "cuda"

    # dist_mnist trains on the CPU with no --device
    with caplog.at_level(logging.INFO, logger="dist_mnist"):
        assert dist_mnist.main(["--data_dir", MNIST, "--batch_size=16",
                                "--train_steps=2",
                                f"--train_dir={tmp_path}"]) == 0
    assert any("training complete at step 2" in r.getMessage()
               for r in caplog.records)
    saved = torch.load(tmp_path / dist_mnist.CKPT_NAME, weights_only=True)
    assert all(t.device.type == "cpu" for t in saved["model"].values())


def test_platform_env_refuses_what_the_port_cannot_run(tmp_path,
                                                      monkeypatch):
    with pytest.raises(ValueError, match="'tpu'"):
        bootstrap.apply_platform_env({"K8S_TPU_PLATFORM": "tpu"})
    monkeypatch.setenv("K8S_TPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="K8S_TPU_PLATFORM='tpu'"):
        dist_mnist.main(["--data_dir", MNIST, f"--train_dir={tmp_path}"])
    # an explicit CUDA request without a card raises; nothing falls back
    monkeypatch.setenv("K8S_TPU_PLATFORM", "gpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dist_mnist.main(["--data_dir", MNIST, f"--train_dir={tmp_path}"])
