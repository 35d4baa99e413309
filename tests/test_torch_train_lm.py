"""``python -m k8s_tpu_torch.train_lm`` on the CPU (``--device cpu
--preset tiny``): the reference's CLI contract (tests/test_train_lm.py) —
trains, checkpoints, resumes, exits 0 when already complete, exits 143 on
SIGTERM with a checkpoint behind, exports a serving artifact the port's
server loads, and refuses the flags of later slices by name."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from k8s_tpu_torch import train_lm
from k8s_tpu_torch.models import checkpoint, server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device=cpu", "--preset=tiny", "--batch_size=8", "--seq_len=64",
        "--learning_rate=1e-2", "--log_every=2"]


def _cmd(tmp_path, args):
    return [sys.executable, "-m", "k8s_tpu_torch.train_lm",
            f"--train_dir={tmp_path}", *BASE, *args]


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def run_lm(tmp_path, args):
    return subprocess.run(_cmd(tmp_path, args), capture_output=True,
                          text=True, env=_env(), cwd=REPO, timeout=300)


def test_trains_resumes_completes_and_exports(tmp_path):
    first = run_lm(tmp_path, ["--train_steps=4", "--checkpoint_every=2"])
    assert first.returncode == 0, first.stderr
    assert "training complete: 4 steps" in first.stderr
    assert "serving artifact exported" in first.stderr
    assert "flash=False" in first.stderr  # the CPU runs the plain versions

    # the exported artifact loads in the port's server and answers
    lm = server.LmServer(train_dir=str(tmp_path), device="cpu")
    try:
        out = lm.generate(server.parse_request(
            lm.config, {"tokens": [5, 9, 12], "max_new_tokens": 6}, 4))
    finally:
        lm.close()
    assert len(out["tokens"]) == 6
    assert all(0 <= t < 256 for t in out["tokens"])

    second = run_lm(tmp_path, ["--train_steps=6", "--checkpoint_every=2",
                               "--generate=4"])
    assert second.returncode == 0, second.stderr
    assert "resumed from step 3" in second.stderr, second.stderr[-600:]
    assert "training complete: 6 steps" in second.stderr
    assert "generated[1] (greedy, 4 tokens):" in second.stderr

    third = run_lm(tmp_path, ["--train_steps=6", "--checkpoint_every=2"])
    assert third.returncode == 0, third.stderr
    assert "already complete" in third.stderr, third.stderr[-600:]
    assert checkpoint.Checkpointer(str(tmp_path)).latest_step() == 5


def test_sigterm_exits_143_with_a_checkpoint(tmp_path):
    proc = subprocess.Popen(
        _cmd(tmp_path, ["--train_steps=100000", "--checkpoint_every=100000",
                        "--log_every=1"]),
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
        env=_env(), cwd=REPO)
    try:
        deadline = time.monotonic() + 240
        for line in proc.stderr:
            # synchronize on the trainer's output, not a fixed sleep
            if "step 2 loss" in line:
                break
            assert time.monotonic() < deadline, "trainer never logged"
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 143, rest[-600:]
    assert "preempted at step" in rest
    step = checkpoint.Checkpointer(str(tmp_path)).latest_step()
    assert step is not None and step >= 1


@pytest.mark.parametrize("args,match", [
    (["--sp=2"], "parallel slice"),
    (["--tp=2"], "parallel slice"),
    (["--pp=2"], "parallel slice"),
    (["--data_dir=tests/fixtures/tokens"], "TokenDataset"),
])
def test_later_slice_flags_are_refused(tmp_path, args, match):
    with pytest.raises(SystemExit, match=match):
        train_lm.main([f"--train_dir={tmp_path}", *BASE, *args])


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        train_lm.main([f"--train_dir={tmp_path}", "--preset=tiny"])
