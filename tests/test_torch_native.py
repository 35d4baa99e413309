"""The port's native window reader (k8s_tpu_torch/native/: its own copy
of ``dataloader.cc``, built by g++ into ``k8s_tpu_torch/_build/``) on the
CPU: ``reader="native"`` yields the reference's ``reader="mmap"`` windows
byte for byte on shards either package wrote (shuffle, seed, epochs,
split and ``eval_fraction``, ``start_window``, ``BatchStream.skip``, int32
shards); a corrupted shard fails its checksum and a truncated one poisons
the loader; a ring smaller than the stream stays ordered; ``"auto"``
follows ``K8S_TPU_NATIVE`` as the reference does; ``train_lm --data_dir``
through the native reader gives the reference script's losses; and the
reader's stress binary passes plain and under ThreadSanitizer.

The reference's own native library is never built here (its build
writes one shared temporary file, which races between processes): the
reference is read through its mmap reader, which its own tests hold
equal to its native one."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k8s_tpu.models import dataset as jds
from k8s_tpu.models import transformer as jt
from k8s_tpu_torch import native, train_lm
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import dataset as tds
from k8s_tpu_torch.native import dataloader as ndl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tokens")
MODEL_TOL = 5e-4  # whole-model loss curves (tests/test_torch_train.py)


@pytest.fixture(autouse=True)
def _port_native(monkeypatch):
    """The port's side reads K8S_TPU_NATIVE unset (native when it
    builds); the reference runs only inside ``_reference_mmap``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native window reader cannot be built")
    monkeypatch.delenv("K8S_TPU_NATIVE", raising=False)
    assert native.build() is not None


@contextlib.contextmanager
def _reference_mmap(monkeypatch):
    # the reference's reader="auto" (its batches) must not build its
    # native library: K8S_TPU_NATIVE=0 gives its mmap reader
    monkeypatch.setenv("K8S_TPU_NATIVE", "0")
    try:
        yield
    finally:
        monkeypatch.delenv("K8S_TPU_NATIVE")


def _stream(n, seed=0, big=False):
    hi = 70000 if big else 256
    return np.random.RandomState(seed).randint(0, hi, n)


@pytest.fixture(params=["jax_writes", "port_writes"])
def shards(request, tmp_path):
    """5 shards of 1000 tokens and a short tail, by either writer."""
    write = (jds if request.param == "jax_writes" else tds).write_token_shards
    d = str(tmp_path / "shards")
    write(d, _stream(5300), shard_tokens=1000, vocab_size=256)
    return d


def _seqs(ds, n, *args, **kw):
    it = ds.sequences(*args, **kw)
    out = [next(it) for _ in range(n)]
    it.close()  # stops the native reader's threads now
    return out


STREAMS = [
    dict(shuffle=False),
    dict(shuffle=True, seed=0),
    dict(shuffle=True, seed=7, epochs=2),
    dict(shuffle=True, seed=3, start_window=70),
    dict(shuffle=False, start_window=5),
    dict(shuffle=True, seed=1, split="train", eval_fraction=0.1),
    dict(shuffle=True, seed=1, split="eval", eval_fraction=0.1),
    dict(shuffle=False, split="eval", eval_fraction=0.25, start_window=3),
]


@pytest.mark.parametrize("kw", STREAMS, ids=range(len(STREAMS)))
def test_native_windows_are_the_references_mmap(shards, kw):
    kw = dict(kw)
    epochs = kw.pop("epochs", None)
    # past one epoch of the 132 windows of 40 (all of both with epochs=2)
    n = 264 if epochs == 2 else 150
    if kw.get("split") == "eval":
        n = 40
    ref = _seqs(jds.TokenDataset(shards), n, 40, epochs=epochs,
                reader="mmap", **kw)
    before = ndl.delivered()
    got = _seqs(tds.TokenDataset(shards), n, 40, epochs=epochs,
                reader="native", **kw)
    assert [g.tobytes() for g in got] == [r.tobytes() for r in ref]
    assert all(g.dtype == np.int32 for g in got)
    assert ndl.delivered() - before >= n
    if epochs is not None:  # the bounded stream ends where the reference's does
        rest = list(tds.TokenDataset(shards).sequences(
            40, epochs=epochs, reader="native", start_window=n, **kw))
        assert rest == []


@pytest.mark.parametrize("skip", [0, 3, 40])
def test_native_batches_and_skip_are_the_references(shards, skip,
                                                    monkeypatch):
    kw = dict(seed=5, epochs=3, split="train", eval_fraction=0.2)
    with _reference_mmap(monkeypatch):
        b = jds.TokenDataset(shards).batches(4, 64, **kw)
        b.skip(skip)
        ref = [x.tolist() for x, _ in b]
    b = tds.TokenDataset(shards).batches(4, 64, **kw)  # "auto": native
    b.skip(skip)
    before = ndl.delivered()
    got = [x.tolist() for x, _ in b]
    assert got == ref and len(got) > 0
    assert ndl.delivered() - before == 4 * len(got)


def test_native_reads_int32_shards(tmp_path):
    toks = _stream(5000, seed=2, big=True)  # ids past uint16
    d = str(tmp_path / "wide")
    jds.write_token_shards(d, toks, shard_tokens=1024)
    assert json.load(open(os.path.join(d, "MANIFEST.json")))["dtype"] \
        == "int32"
    kw = dict(shuffle=True, seed=4)
    ref = _seqs(jds.TokenDataset(d), 30, 100, reader="mmap", **kw)
    got = _seqs(tds.TokenDataset(d), 30, 100, reader="native", **kw)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    assert max(int(g.max()) for g in got) >= 1 << 16


def test_corrupted_shard_fails_its_checksum(tmp_path):
    d = str(tmp_path / "c")
    tds.write_token_shards(d, _stream(3000), shard_tokens=1000)
    path = os.path.join(d, "tokens-00001.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    msgs, counts = [], []
    for ds, reader in ((jds.TokenDataset(d), "mmap"),
                       (tds.TokenDataset(d), "native")):
        it = ds.sequences(100, shuffle=False, reader=reader)
        got = []
        with pytest.raises(ValueError, match="checksum mismatch") as e:
            got.extend(next(it) for _ in range(20))
        msgs.append(str(e.value))
        counts.append(len(got))
    assert msgs[1] == msgs[0]
    # mmap reads shard 0's ten windows first; the native reader hashes a
    # shard when it submits its first window, up to 16 windows ahead
    assert counts[0] == 10 and counts[1] <= 10
    # verify=False reads the corrupted shard without a check
    assert len(list(tds.TokenDataset(d, verify=False).sequences(
        100, shuffle=False, epochs=1, reader="native"))) == 30


def test_truncated_shard_poisons_the_loader(tmp_path):
    d = str(tmp_path / "t")
    tds.write_token_shards(d, _stream(3000), shard_tokens=1000)
    want = _seqs(jds.TokenDataset(d), 30, 100, shuffle=False,
                 reader="mmap")
    it = tds.TokenDataset(d, verify=False).sequences(
        100, shuffle=False, epochs=1, reader="native")
    got = [next(it)]
    # shard 2 loses its last 250 tokens after the stream started: the
    # reads of its windows 8-10 come up short, and every later window
    # fails rather than skip one
    path = os.path.join(d, "tokens-00002.npy")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 500)
    with pytest.raises(IOError, match="short read|rejected"):
        for w in it:
            got.append(w)
    assert 1 <= len(got) < 27
    assert [g.tolist() for g in got] == [w.tolist()
                                         for w in want[:len(got)]]


def test_a_ring_smaller_than_the_stream_stays_ordered(tmp_path):
    path = str(tmp_path / "seq.bin")
    vals = np.arange(1 << 14, dtype=np.uint32)
    vals.tofile(path)
    wb = 256 * 4
    n = len(vals) * 4 // wb
    order = np.random.default_rng(0).permutation(n)
    with ndl.NativeWindowReader([path, path], wb, n_slots=2,
                                n_threads=3) as r:
        got = list(r.stream((int(i) % 2, int(i) * wb) for i in order))
    assert len(got) == n
    for i, raw in zip(order, got):
        np.testing.assert_array_equal(
            np.frombuffer(raw, np.uint32), vals[i * 256:(i + 1) * 256])
    with pytest.raises(FileNotFoundError, match="cannot open"):
        ndl.NativeWindowReader([str(tmp_path / "missing")], wb)


def test_auto_follows_k8s_tpu_native(tmp_path, monkeypatch):
    ds = tds.TokenDataset(FIXTURE)
    want = _seqs(ds, 5, 64, reader="mmap")

    def auto_delivered():
        before = ndl.delivered()
        got = _seqs(ds, 5, 64, reader="auto")
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        return ndl.delivered() - before

    assert auto_delivered() >= 5  # unset: native, the counter moves
    monkeypatch.setenv("K8S_TPU_NATIVE", "0")
    assert auto_delivered() == 0  # "0": mmap
    assert not ndl.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        next(ds.sequences(64, reader="native"))
    monkeypatch.setenv("K8S_TPU_NATIVE", "1")
    assert auto_delivered() >= 5  # "1": native, it builds
    # "1" with a build made to fail: no g++ on PATH, an empty build dir
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    with pytest.raises(RuntimeError, match="K8S_TPU_NATIVE=1"):
        next(ds.sequences(64, reader="auto"))
    with pytest.raises(RuntimeError, match="K8S_TPU_NATIVE=1"):
        native.load()  # raises on every call, not only the first
    # unset with the failed build: "auto" takes mmap, "native" raises
    monkeypatch.delenv("K8S_TPU_NATIVE")
    assert auto_delivered() == 0
    with pytest.raises(RuntimeError, match="unavailable"):
        next(ds.sequences(64, reader="native"))
    assert not (tmp_path / "empty").exists()


def test_the_build_names_the_library_by_its_sources(tmp_path, monkeypatch):
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libk8stpu_dataloader-")
    # a fresh build directory: g++ writes a temp name of this process,
    # then renames it into place; nothing else is left behind
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    built = native.build()
    assert built == native.library_path() and os.path.exists(built)
    assert os.listdir(tmp_path / "b") == [os.path.basename(built)]
    assert os.path.basename(built) == os.path.basename(path)
    assert native.build() == built  # reused, not rebuilt


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm",
        os.path.join(REPO, "examples", "train_lm", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return ([r["loss"] for r in rows if "loss" in r],
            [r["eval_loss"] for r in rows if "eval_loss" in r])


ARGS = ["--preset=tiny", "--batch_size=8", "--seq_len=64",
        "--learning_rate=1e-2", "--log_every=1", f"--data_dir={FIXTURE}",
        "--eval_every=2", "--eval_fraction=0.1", "--eval_batches=2"]


def test_train_lm_data_dir_on_the_native_reader(tmp_path, monkeypatch):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with _reference_mmap(monkeypatch):
        assert _reference_script().main(
            [f"--train_dir={jdir}", "--train_steps=4", *ARGS]) == 0
    cfg = jt.tiny_test()
    init = jax.device_get(jt.Transformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32))["params"])
    monkeypatch.setattr(bridge, "init_params",
                        lambda *a, **k: bridge.params_from_jax(init))
    ndl.reset_delivered()
    assert train_lm.main([f"--train_dir={tdir}", "--train_steps=4",
                          "--device=cpu", *ARGS]) == 0
    # 4 training batches and 2 evals of 2 batches, plus what the prefetch
    # stage read ahead on each of the 3 streams: its 2 queued batches,
    # the one it holds and the one it draws before it sees the stop
    consumed = 8 * (4 + 2 * 2)
    assert consumed <= ndl.delivered() <= consumed + 3 * 8 * 4
    jl, je = _metrics(jdir)
    tl, te = _metrics(tdir)
    assert len(tl) == 4 and len(te) == 2
    np.testing.assert_allclose(tl, jl, atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(te, je, atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.mark.parametrize("tsan", [False, True], ids=["plain", "tsan"])
def test_stress_binary_passes(tsan, tmp_path):
    path = native.build_stress_binary(tsan=tsan)
    if path is None:
        assert tsan, "the plain stress binary failed to build"
        pytest.skip("libtsan not available")
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1")
    out = subprocess.run([path, str(tmp_path)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ThreadSanitizer" not in out.stdout + out.stderr
    assert "PASS" in out.stdout
    assert os.listdir(tmp_path) == []  # its scratch file is removed
