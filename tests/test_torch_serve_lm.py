"""``python -m k8s_tpu_torch.serve_lm`` (the port of
``examples/train_lm/serve_lm.py``) on a tiny export with ``--device cpu``.

Each mode prints what the reference's script prints for the same
parameters (JAX-initialised, carried by ``bridge.params_from_jax``; the
reference reads its own orbax export, the port its ``params.pt``):
greedy over ``--tokens`` and ``--text``, ``--beam``,
``--chunked_prefill``, ``--speculative`` (with its tokens/model-call log
line), ``--kv_cache int8`` and ``--eos``.  Sampled modes are held to
determinism under one seed within the port.  The argument checks refuse
with the reference's messages.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from k8s_tpu.models import serving as jax_serving
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu_torch import serve_lm
from k8s_tpu_torch.models import bridge, serving
from k8s_tpu_torch.models.transformer import TransformerConfig
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(vocab_size=256, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=128, prefill_chunk=4, remat=False)


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_lm",
        os.path.join(REPO, "examples", "train_lm", "serve_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """(reference export dir, port export dir) over the same weights."""
    cj = JaxConfig(dtype=jnp.float32, **SHAPE)
    ct = TransformerConfig(dtype=torch.float32, **SHAPE)
    params = JaxTransformer(cj).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 5), jnp.int32))["params"]
    jdir = str(tmp_path_factory.mktemp("jax_export"))
    tdir = str(tmp_path_factory.mktemp("port_export"))
    jax_serving.export_serving(jdir, cj, {"params": params})
    serving.export_serving(tdir, ct, bridge.params_from_jax(
        jax.device_get(params)))
    return jdir, tdir


def run(main, train_dir, args, capsys):
    assert main([f"--train_dir={train_dir}", *args]) == 0
    return capsys.readouterr().out.strip().splitlines()[-1]


PROMPT = "--tokens=5,12,99,5,12,99,5,12"


@pytest.mark.parametrize("args", [
    [PROMPT, "--max_new_tokens=10"],
    ["--text=once upon a ", "--max_new_tokens=8"],
    [PROMPT, "--max_new_tokens=6", "--beam=3"],
    ["--tokens=" + ",".join(str(7 * i % 256) for i in range(11)),
     "--max_new_tokens=6", "--chunked_prefill"],
    [PROMPT, "--max_new_tokens=12", "--speculative=3"],
    [PROMPT, "--max_new_tokens=8", "--kv_cache=int8"],
], ids=["greedy", "text", "beam", "chunked_prefill", "speculative", "int8"])
def test_prints_what_the_reference_prints(exports, capsys, args):
    jdir, tdir = exports
    want = run(_reference_script().main, jdir, args, capsys)
    got = run(serve_lm.main, tdir, args + ["--device=cpu"], capsys)
    assert got == want and got


def test_eos_and_speculative_log_line(exports, capsys, caplog):
    jdir, tdir = exports
    full = run(serve_lm.main, tdir, [PROMPT, "--max_new_tokens=10",
                                     "--device=cpu"], capsys).split(",")
    eos = full[4]
    args = [PROMPT, "--max_new_tokens=10", f"--eos={eos}"]
    got = run(serve_lm.main, tdir, args + ["--device=cpu"], capsys)
    assert got == ",".join(full[:full.index(eos)])
    assert got == run(_reference_script().main, jdir, args, capsys)
    with caplog.at_level(logging.INFO, logger="serve_lm"):
        run(serve_lm.main, tdir, [PROMPT, "--max_new_tokens=10",
                                  "--speculative=4", "--device=cpu"], capsys)
    assert any(r.getMessage().startswith("speculative: ")
               and "tokens/model-call over" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("extra", [
    ["--temperature=0.9", "--top_k=20"],
    ["--temperature=0.9", "--speculative=3"],
], ids=["sampled", "sampled_speculative"])
def test_sampled_modes_repeat_under_one_seed(exports, capsys, extra):
    _, tdir = exports
    args = [PROMPT, "--max_new_tokens=8", "--device=cpu", *extra]
    a = run(serve_lm.main, tdir, args + ["--seed=3"], capsys)
    assert a == run(serve_lm.main, tdir, args + ["--seed=3"], capsys)
    assert len(a.split(",")) == 8


@pytest.mark.parametrize("args", [
    [],
    ["--text=a", "--tokens=1"],
    ["--tokens=1,2", "--beam=2", "--chunked_prefill"],
    ["--tokens=1,2", "--top_k=-1"],
    ["--tokens=1,2", "--speculative=3", "--beam=2"],
    ["--tokens=1,2", "--speculative=1"],
], ids=["no_prompt", "two_prompts", "beam_chunked", "top_k", "spec_beam",
        "spec_1"])
def test_refusals_are_the_references(exports, args):
    _, tdir = exports
    with pytest.raises(SystemExit) as ej:
        _reference_script().main([f"--train_dir={tdir}", *args])
    with pytest.raises(SystemExit) as et:
        serve_lm.main([f"--train_dir={tdir}", *args, "--device=cpu"])
    assert str(et.value) == str(ej.value)


def test_bad_tokens_and_cuda_default(exports):
    _, tdir = exports
    with pytest.raises(SystemExit, match="outside"):
        serve_lm.main([f"--train_dir={tdir}", "--tokens=1,900",
                       "--device=cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve_lm.main([f"--train_dir={tdir}", "--tokens=1,2"])


def test_module_entry_point(exports):
    _, tdir = exports
    out = subprocess.run(
        [sys.executable, "-m", "k8s_tpu_torch.serve_lm",
         f"--train_dir={tdir}", PROMPT, "--max_new_tokens=5", "--beam=2",
         "--device=cpu"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    toks = out.stdout.strip().split(",")
    assert len(toks) == 5 and all(0 <= int(t) < 256 for t in toks)
    assert "beam score" in out.stderr
