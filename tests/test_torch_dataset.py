"""The port's token-shard dataset (k8s_tpu_torch/models/dataset.py) against
the reference's ``k8s_tpu.models.dataset`` on the CPU: shards written by
either package are read by the other with identical windows and batches
(seed, shuffle, epochs, split and ``eval_fraction``, ``start_window`` and
``BatchStream.skip``), the writers produce the same files, a corrupted
shard fails its sha256 check, ``tests/fixtures/tokens`` reads the same,
``"auto"`` and the native C++ reader yield the mmap reader's windows
(tests/test_torch_native.py holds the native reader against the
reference), and ``train_lm --data_dir``
on ``--preset tiny`` gives the reference script's losses from the same
initial weights, its eval losses on the held-out tail, and resumes at
the next unread window."""

from __future__ import annotations

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k8s_tpu.models import dataset as jds
from k8s_tpu.models import transformer as jt
from k8s_tpu_torch import train_lm
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import dataset as tds
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tokens")
MODEL_TOL = 5e-4  # whole-model loss curves (tests/test_torch_train.py)


@pytest.fixture(autouse=True)
def _mmap_reader(monkeypatch):
    # the reference's reader="auto" must not build its native library
    # here: it yields the same windows as its mmap reader, which the
    # port copies
    monkeypatch.setenv("K8S_TPU_NATIVE", "0")


def _stream(n, seed=0, big=False):
    hi = 70000 if big else 256
    return np.random.RandomState(seed).randint(0, hi, n)


@pytest.fixture(params=["jax_writes", "port_writes"])
def shards(request, tmp_path):
    """(writer, reader) pair over one shard directory: 5 shards of 1000
    tokens and a short tail."""
    write = (jds if request.param == "jax_writes" else tds).write_token_shards
    d = str(tmp_path / "shards")
    write(d, _stream(5300), shard_tokens=1000, vocab_size=256)
    return d


def _seqs(ds, n, *args, **kw):
    it = ds.sequences(*args, **kw)
    return [next(it).tolist() for _ in range(n)]


STREAMS = [
    dict(shuffle=False),
    dict(shuffle=True, seed=0),
    dict(shuffle=True, seed=7),
    dict(shuffle=True, seed=3, start_window=70),
    dict(shuffle=False, start_window=5),
    dict(shuffle=True, seed=1, split="train", eval_fraction=0.1),
    dict(shuffle=True, seed=1, split="eval", eval_fraction=0.1),
    dict(shuffle=False, split="eval", eval_fraction=0.25, start_window=3),
]


@pytest.mark.parametrize("kw", STREAMS, ids=range(len(STREAMS)))
def test_windows_are_the_references(shards, kw):
    j, t = jds.TokenDataset(shards), tds.TokenDataset(shards)
    n = 130  # past one epoch of the 132 windows of 40
    got = _seqs(t, n, 40, epochs=None, **kw)
    assert got == _seqs(j, n, 40, epochs=None, reader="mmap", **kw)
    assert t.num_sequences(40) == j.num_sequences(40) == 132
    for split in ("train", "eval"):
        assert t.num_split_sequences(40, split, 0.1) == \
            j.num_split_sequences(40, split, 0.1)


@pytest.mark.parametrize("skip", [0, 3, 40])
def test_batches_and_skip_are_the_references(shards, skip):
    out = []
    for pkg in (jds, tds):
        b = pkg.TokenDataset(shards).batches(4, 64, seed=5, epochs=3,
                                              split="train",
                                              eval_fraction=0.2)
        b.skip(skip)
        out.append([x.tolist() for x, _ in b])
    assert out[1] == out[0] and len(out[1]) > 0


def test_bounded_skip_and_errors_are_the_references(shards):
    for pkg in (jds, tds):
        ds = pkg.TokenDataset(shards)
        b = ds.batches(4, 64, epochs=1)
        b.skip(19)  # exactly to the end: the completed-run resume
        assert list(b) == []
        with pytest.raises(ValueError, match="jumps past"):
            ds.batches(4, 64, epochs=1).skip(20)
        with pytest.raises(ValueError, match="need >= batch_size"):
            ds.batches(4, 64, split="eval", eval_fraction=0.05)
        with pytest.raises(ValueError, match="eval_fraction requires"):
            next(ds.sequences(64, eval_fraction=0.1))
        with pytest.raises(ValueError, match="longer than every shard"):
            next(ds.sequences(5000))
        b = ds.batches(4, 64)
        next(b)
        with pytest.raises(RuntimeError, match="before consumption"):
            b.skip(1)


def test_writers_write_the_same_files(tmp_path):
    toks = _stream(2500, seed=2, big=True)  # ids past uint16: int32 shards
    for pkg, name in ((jds, "jax"), (tds, "port")):
        pkg.write_token_shards(str(tmp_path / name), toks, shard_tokens=1024)
        pkg.write_text_corpus(str(tmp_path / f"{name}_text"),
                              ["hello world\n", b"bytes \xff\n", "more"],
                              shard_tokens=7)
    for sub in ("", "_text"):
        a, b = tmp_path / f"jax{sub}", tmp_path / f"port{sub}"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for f in os.listdir(a):
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    man = json.loads((tmp_path / "port" / "MANIFEST.json").read_text())
    assert man["dtype"] == "int32" and len(man["shards"]) == 3
    with pytest.raises(ValueError, match="negative token ids"):
        tds.write_token_shards(str(tmp_path / "neg"), np.array([1, -1]))
    with pytest.raises(ValueError, match="empty"):
        tds.write_token_shards(str(tmp_path / "e"), np.array([], np.int32))


def test_checksum_mismatch_fails_loudly(tmp_path):
    d = str(tmp_path / "c")
    tds.write_token_shards(d, _stream(3000), shard_tokens=1000)
    path = os.path.join(d, "tokens-00001.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    msgs = []
    for pkg in (jds, tds):
        ds = pkg.TokenDataset(d)
        it = ds.sequences(100, shuffle=False)
        assert len([next(it) for _ in range(10)]) == 10  # shard 0 is fine
        with pytest.raises(ValueError, match="checksum mismatch") as e:
            next(it)
        msgs.append(str(e.value))
        # verify=False reads the corrupted shard without a check
        assert len(list(pkg.TokenDataset(d, verify=False).sequences(
            100, shuffle=False, epochs=1))) == 30
    assert msgs[1] == msgs[0]
    with pytest.raises(FileNotFoundError, match="MANIFEST"):
        tds.TokenDataset(str(tmp_path))


def test_fixture_corpus_reads_the_same():
    j, t = jds.TokenDataset(FIXTURE), tds.TokenDataset(FIXTURE)
    assert (t.total_tokens, t.vocab_size) == (j.total_tokens, j.vocab_size)
    kw = dict(seed=0, split="train", eval_fraction=0.05)
    jb, tb = j.batches(8, 64, **kw), t.batches(8, 64, **kw)
    for _ in range(5):
        (a, _), (b, _) = next(jb), next(tb)
        np.testing.assert_array_equal(b, a)
        assert b.dtype == np.int32
    assert tds.decode_bytes(t._shard("tokens-00000.npy")[:20]) == \
        jds.decode_bytes(j._shard("tokens-00000.npy")[:20])


def test_readers_by_name(monkeypatch):
    ds = tds.TokenDataset(FIXTURE)
    with pytest.raises(ValueError, match="unknown reader"):
        next(ds.sequences(64, reader="fast"))
    # with K8S_TPU_NATIVE unset (the port's side only) "auto" is the
    # native reader, and both yield the mmap reader's windows
    monkeypatch.delenv("K8S_TPU_NATIVE")
    want = _seqs(ds, 3, 64, reader="mmap")
    assert _seqs(ds, 3, 64, reader="auto") == want
    assert _seqs(ds, 3, 64, reader="native") == want


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


def test_train_lm_data_dir_matches_the_reference_script(tmp_path,
                                                        monkeypatch):
    jdir, tdir, rdir = (str(tmp_path / n) for n in ("jax", "port", "resume"))
    assert _reference_script().main(
        [f"--train_dir={jdir}", "--train_steps=4", *ARGS]) == 0
    # the port starts from the reference script's initial weights
    cfg = jt.tiny_test()
    init = jax.device_get(jt.Transformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32))["params"])
    monkeypatch.setattr(bridge, "init_params",
                        lambda *a, **k: bridge.params_from_jax(init))
    common = ["--device=cpu", *ARGS]
    assert train_lm.main([f"--train_dir={tdir}", "--train_steps=4",
                          *common]) == 0
    jl, je = _metrics(jdir)
    tl, te = _metrics(tdir)
    assert len(tl) == 4 and len(te) == 2
    np.testing.assert_allclose(tl, jl, atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(te, je, atol=MODEL_TOL, rtol=MODEL_TOL)
    # interrupted at step 2, resumed: steps 3-4 read the next windows
    assert train_lm.main([f"--train_dir={rdir}", "--train_steps=2",
                          "--checkpoint_every=2", *common]) == 0
    assert train_lm.main([f"--train_dir={rdir}", "--train_steps=4",
                          "--checkpoint_every=2", *common]) == 0
    rl, _ = _metrics(rdir)
    assert len(rl) == 4
    np.testing.assert_allclose(rl, tl, rtol=1e-6, atol=1e-6)


def test_train_lm_refuses_a_dataset_past_the_vocab(tmp_path):
    d = str(tmp_path / "big")
    tds.write_token_shards(d, _stream(4000, big=True))
    with pytest.raises(SystemExit, match="exceeds model vocab"):
        train_lm.main([f"--train_dir={tmp_path}", "--device=cpu",
                       "--preset=tiny", f"--data_dir={d}"])
    with pytest.raises(SystemExit, match="holdout covers one batch"):
        train_lm.main([f"--train_dir={tmp_path}", "--device=cpu",
                       "--preset=tiny", "--seq_len=64", "--batch_size=8",
                       f"--data_dir={FIXTURE}", "--eval_every=1",
                       "--eval_fraction=0.01"])
