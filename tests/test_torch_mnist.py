"""The port's MNIST pieces against the JAX package on the CPU: the IDX
files (``k8s_tpu_torch/models/mnist_data.py``, byte for byte), the CNN
(``models/mnist.py``: logits and Adam training from bridged parameters)
and ``python -m k8s_tpu_torch.dist_mnist --device cpu`` (train,
checkpoint, resume, held-out accuracy).

Tolerances, f32: logits and losses 1e-4 relative (summation order of the
convolutions and the dense layers).
"""

import gzip
import hashlib
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import mnist as jmnist
from k8s_tpu.models import mnist_data as jdata
from k8s_tpu.models import train as jtrain
from k8s_tpu_torch import dist_mnist
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import mnist as tmnist
from k8s_tpu_torch.models import mnist_data as tdata
from k8s_tpu_torch.models import train as ttrain
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "tests", "fixtures", "mnist")
TOL = 1e-4


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max abs err {err} vs scale {scale}"


# -- IDX files ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["images", "labels"])
def test_idx_bytes_match_reference_both_ways(tmp_path, kind):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(7, 28, 28) if kind == "images"
                        else (7,)).astype(np.uint8)
    # one file name in two directories: gzip's header records the name
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port_path, ref_path = tmp_path / "port" / "f.gz", tmp_path / "ref" / "f.gz"
    getattr(tdata, f"write_idx_{kind}")(str(port_path), data)
    getattr(jdata, f"write_idx_{kind}")(str(ref_path), data)
    assert port_path.read_bytes() == ref_path.read_bytes()
    # each package reads the other's file (and the raw, ungzipped bytes)
    raw = tmp_path / "raw.idx"
    raw.write_bytes(gzip.decompress(ref_path.read_bytes()))
    for reader in (getattr(tdata, f"read_idx_{kind}"),
                   getattr(jdata, f"read_idx_{kind}")):
        for path in (port_path, ref_path, raw):
            np.testing.assert_array_equal(reader(str(path)), data)


def test_idx_errors_match_reference(tmp_path):
    images = tmp_path / "images.gz"
    tdata.write_idx_images(str(images), np.zeros((2, 28, 28), np.uint8))
    truncated = tmp_path / "short.idx"
    truncated.write_bytes(gzip.decompress(images.read_bytes())[:100])
    tiny = tmp_path / "tiny.idx"
    tiny.write_bytes(b"\x00\x00")
    for path, read in ((images, "read_idx_labels"),
                       (truncated, "read_idx_images"),
                       (tiny, "read_idx_images")):
        msgs = []
        for mod in (tdata, jdata):
            with pytest.raises(ValueError) as e:
                getattr(mod, read)(str(path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_load_dataset_matches_reference_and_fixture_is_intact():
    with open(os.path.join(MNIST, "SHA256SUMS")) as f:
        for line in f:
            digest, name = line.split()
            with open(os.path.join(MNIST, name), "rb") as g:
                assert hashlib.sha256(g.read()).hexdigest() == digest
    x, y = tdata.load_dataset(MNIST)
    jx, jy = jdata.load_dataset(MNIST)
    assert x.shape == (1797, 28, 28, 1) and x.dtype == np.float32
    assert y.dtype == np.int32 and 0.0 <= x.min() and x.max() <= 1.0
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_build_digits_fixture_writes_the_committed_bytes(tmp_path):
    pytest.importorskip("sklearn")
    tdata.build_digits_fixture(str(tmp_path))
    for name in (tdata.TRAIN_IMAGES, tdata.TRAIN_LABELS):
        with open(os.path.join(MNIST, name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read()


# -- the CNN -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cnn():
    """(flax model, its params, the port model holding them, a batch)."""
    x, y = tdata.load_dataset(MNIST)
    x, y = x[:32], y[:32]
    jm = jmnist.MnistCNN()
    params = jax.device_get(jm.init(jax.random.PRNGKey(3),
                                    jnp.asarray(x[:1]))["params"])
    tm = tmnist.MnistCNN(device="cpu")
    tm.load_state_dict(bridge.mnist_from_jax(params))
    return jm, params, tm, (x, y)


def test_cnn_logits_match_flax(cnn):
    jm, params, tm, (x, _) = cnn
    tm.load_state_dict(bridge.mnist_from_jax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), jm.apply({"params": params}, jnp.asarray(x)),
           what="logits")


def test_cnn_adam_losses_match_jax_train_step(cnn):
    """5 Adam steps through the JAX package's make_train_step and the
    port's, from the same bridged parameters and batches."""
    jm, params, tm, (x, y) = cnn
    tm.load_state_dict(bridge.mnist_from_jax(params))
    batches = [(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
               for i in range(4)] + [(x[:8], y[:8])]
    jopt = jtrain.default_optimizer(1e-3)
    jstate = jtrain.init_state(params, jopt)
    jstep = jax.jit(jtrain.make_train_step(
        lambda p, b: jm.apply({"params": p}, b), jtrain.cross_entropy_loss,
        jopt))
    topt = ttrain.default_optimizer(1e-3)
    tstate = ttrain.init_state(tm, topt)
    tstep = ttrain.make_train_step(lambda m, b: m(b),
                                   ttrain.cross_entropy_loss, topt)
    for i, (bx, by) in enumerate(batches):
        jstate, jloss = jstep(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tstate, tloss = tstep(tstate, (torch.from_numpy(bx),
                                       torch.from_numpy(by)))
        # the losses, not the parameters: Adam divides by sqrt(v), so a
        # gradient entry that is rounding noise (the fixture's blank
        # border pixels) still moves its weight a full learning rate
        _close(tloss.item(), float(jloss), what=f"loss step {i}")


def test_bridge_round_trips(cnn):
    _, params, _, _ = cnn
    back = bridge.mnist_to_jax(bridge.mnist_from_jax(params))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)


def test_synthetic_batch_is_reproducible_within_the_port():
    a = tmnist.synthetic_batch(torch.Generator().manual_seed(5), 16)
    b = tmnist.synthetic_batch(torch.Generator().manual_seed(5), 16)
    assert a[0].shape == (16, 28, 28, 1) and a[0].dtype == torch.float32
    assert a[1].shape == (16,) and 0 <= a[1].min() and a[1].max() < 10
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- dist_mnist --------------------------------------------------------------


def _cli(train_dir, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "k8s_tpu_torch.dist_mnist", "--device", "cpu",
         f"--train_dir={train_dir}", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)


def test_dist_mnist_trains_checkpoints_resumes(tmp_path):
    args = ["--data_dir", MNIST, "--eval_holdout", "256", "--batch_size",
            "16", "--checkpoint_every", "3"]
    first = _cli(tmp_path, "--train_steps=6", *args)
    assert first.returncode == 0, first.stderr
    for line in ("held out 256 examples for evaluation",
                 "step 0 loss", "step 5 loss", "saved checkpoint at step 3",
                 "held-out accuracy", "training complete at step 6"):
        assert line in first.stderr, (line, first.stderr)
    assert (tmp_path / "mnist_state.pt").exists()
    second = _cli(tmp_path, "--train_steps=9", *args)
    assert second.returncode == 0, second.stderr
    assert "restored checkpoint at step 6" in second.stderr
    assert "training complete at step 9" in second.stderr
    saved = torch.load(tmp_path / "mnist_state.pt", weights_only=True)
    assert saved["step"] == 9 and set(saved) == {"model", "optimizer", "step"}


def test_dist_mnist_resume_equals_an_uninterrupted_run(tmp_path,
                                                       monkeypatch):
    """A run stopped at step 4 and resumed to 8 trains, as the reference
    does, on a stream reseeded with the resume step: its first batch is
    element for element the first batch of the reference's
    ``array_batches(..., seed=4)`` over the synthetic draw, and its
    losses and final weights equal a control that restores the same
    step-4 checkpoint and trains on that reseeded stream."""
    from k8s_tpu.models import data as jdata_lib

    seen = []  # (batch, loss) of every step main runs
    make_step = ttrain.make_train_step

    def recording_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch):
            state, loss = step(state, batch)
            seen.append(([t.clone() for t in batch], float(loss)))
            return state, loss
        return run
    monkeypatch.setattr(ttrain, "make_train_step", recording_step)
    common = ["--device", "cpu", "--batch_size", "16", "--checkpoint_every",
              "4", f"--train_dir={tmp_path}"]
    assert dist_mnist.main(common + ["--train_steps=4"]) == 0
    ckpt = tmp_path / "at4"  # the step-4 checkpoint, kept for the control
    ckpt.mkdir()
    shutil.copy(tmp_path / dist_mnist.CKPT_NAME, ckpt / dist_mnist.CKPT_NAME)
    seen.clear()
    assert dist_mnist.main(common + ["--train_steps=8"]) == 0
    resumed = list(seen)
    assert len(resumed) == 4

    # the reference's synthetic draw and its reseeded stream
    rng = np.random.default_rng(0)
    ds_x = rng.normal(size=(64 * 16, 28, 28, 1)).astype(np.float32)
    ds_y = rng.integers(0, 10, size=(64 * 16,)).astype(np.int32)
    ref_stream = jdata_lib.array_batches((ds_x, ds_y), 16, seed=4)
    want = [next(ref_stream) for _ in range(4)]
    for (got, _), ref in zip(resumed, want):
        for t, a in zip(got, ref):
            np.testing.assert_array_equal(t.numpy(), a)

    # control: the step-4 checkpoint trained on that reseeded stream
    model = tmnist.MnistCNN(device="cpu", seed=0)
    opt = ttrain.default_optimizer(1e-3)
    state = ttrain.init_state(model, opt)
    assert dist_mnist.restore_checkpoint(str(ckpt), state, "cpu") == 4
    step = make_step(lambda m, x: m(x), ttrain.cross_entropy_loss, opt)
    control = []
    for x, y in want:
        state, loss = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        control.append(float(loss))
    assert [loss for _, loss in resumed] == control
    final = torch.load(tmp_path / dist_mnist.CKPT_NAME, weights_only=True)
    assert final["step"] == 8
    for name, t in state["model"].state_dict().items():
        assert torch.equal(t, final["model"][name]), name


def test_dist_mnist_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="fewer than one training batch"):
        dist_mnist.main(["--device", "cpu", "--data_dir", MNIST,
                         "--eval_holdout", "1790", "--batch_size", "16"])
    # more processes train sharded (tests/test_torch_dist_ckpt.py); they
    # need the operator's coordinator address
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="JAX_COORDINATOR_ADDRESS"):
        dist_mnist.main(["--device", "cpu", f"--train_dir={tmp_path}"])
