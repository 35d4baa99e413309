"""The port's profiler hooks (``k8s_tpu_torch.launcher.bootstrap``'s
``setup_observability`` / ``stop_observability``) against the
reference's (``k8s_tpu.launcher.bootstrap``) on the same pod env, on the
CPU: ``{}`` for an empty env, ``{"profile_dir": d}`` from both for
``JAX_PROFILE_DIR`` (the port's trace, a per-host, per-pid JSON file in
``d``, holds the CPU activity), a second directory is ignored with a
warning, ``stop`` without a start does nothing, a CUDA process without a
card raises rather than trace the CPU alone, and ``XLA_DUMP_TO`` /
``JAX_PROFILER_PORT``, which have no counterpart, are named in a warning,
appear in no dict and leave ``XLA_FLAGS`` as it was."""

from __future__ import annotations

import json
import logging
import os
import socket

import jax.numpy as jnp
import pytest
import torch

from k8s_tpu.launcher import bootstrap as jboot
from k8s_tpu_torch.launcher import bootstrap as tboot


@pytest.fixture(autouse=True)
def _stopped(monkeypatch):
    """Every test starts and ends with no session in either package, and
    with no device bound by an earlier bring-up in this process (the
    hooks then take the env's K8S_TPU_PLATFORM)."""
    monkeypatch.setattr(tboot, "_device", None)
    tboot.stop_observability()
    jboot.stop_observability()
    yield
    tboot.stop_observability()
    jboot.stop_observability()


def _cpu_env(**kw) -> dict:
    return {"K8S_TPU_PLATFORM": "cpu", **kw}


def test_empty_env_enables_nothing():
    for env in ({}, _cpu_env()):
        assert tboot.setup_observability(env) == \
            jboot.setup_observability(env) == {}
    assert tboot._profiler is None


def test_profile_dir_traces_into_the_directory(tmp_path):
    d = str(tmp_path / "trace")
    env = _cpu_env(JAX_PROFILE_DIR=d)
    want = jboot.setup_observability(env)
    got = tboot.setup_observability(env)
    assert got == want == {"profile_dir": d}
    x = torch.ones(64, 64)
    (x @ x).sum().item()
    jnp.dot(jnp.ones((8, 8)), jnp.ones((8, 8))).block_until_ready()
    tboot.stop_observability(env)
    jboot.stop_observability(env)
    name = f"{socket.gethostname()}_{os.getpid()}."
    traces = [f for f in os.listdir(d)
              if f.startswith(name) and f.endswith(".pt.trace.json")]
    assert len(traces) == 1, os.listdir(d)
    with open(os.path.join(d, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    assert "aten::mm" in ops, sorted(ops)[:20]
    assert not any(e.get("cat") == "kernel" for e in events)
    tboot.stop_observability(env)  # a second stop does nothing


def test_a_second_directory_is_ignored_with_a_warning(tmp_path, caplog):
    first, second = str(tmp_path / "a"), str(tmp_path / "b")
    out = {}
    for name, pkg in (("jax", jboot), ("port", tboot)):
        with caplog.at_level(logging.WARNING, logger=pkg.log.name):
            caplog.clear()
            a = pkg.setup_observability(_cpu_env(JAX_PROFILE_DIR=first))
            b = pkg.setup_observability(_cpu_env(JAX_PROFILE_DIR=second))
        out[name] = (a, b, [r.getMessage() for r in caplog.records])
        pkg.stop_observability()
    assert out["port"][:2] == out["jax"][:2] == (
        {"profile_dir": first}, {"profile_dir": first})
    assert out["port"][2] == out["jax"][2] == [
        f"JAX_PROFILE_DIR={second} ignored: trace already writing to "
        f"{first}"]
    assert not os.path.exists(second)


def test_stop_without_a_start_is_a_no_op():
    assert tboot._profiler is None
    tboot.stop_observability()
    tboot.stop_observability({"JAX_PROFILE_DIR": "/nonexistent"})
    jboot.stop_observability()
    assert tboot._profiler is None


def test_a_cuda_process_never_traces_the_cpu_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a process without a card")
    env = {"K8S_TPU_PLATFORM": "gpu", "JAX_PROFILE_DIR": str(tmp_path)}
    with pytest.raises(RuntimeError, match="cuda"):
        tboot.setup_observability(env)
    assert tboot._profiler is None and os.listdir(tmp_path) == []


@pytest.mark.parametrize("var", ["XLA_DUMP_TO", "JAX_PROFILER_PORT"])
def test_hooks_without_a_counterpart_warn(var, tmp_path, caplog,
                                          monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--existing=1")
    value = str(tmp_path) if var == "XLA_DUMP_TO" else "9999"
    with caplog.at_level(logging.WARNING, logger=tboot.log.name):
        got = tboot.setup_observability(_cpu_env(**{var: value}))
    assert got == {}
    assert os.environ["XLA_FLAGS"] == "--existing=1"
    msgs = [r.getMessage() for r in caplog.records
            if r.name == tboot.log.name]
    assert len(msgs) == 1 and msgs[0].startswith(f"{var}={value} ignored")
    # beside JAX_PROFILE_DIR: only the trace is enabled
    d = str(tmp_path / "t")
    got = tboot.setup_observability(_cpu_env(**{var: value},
                                             JAX_PROFILE_DIR=d))
    assert got == {"profile_dir": d}
    tboot.stop_observability()
    assert os.environ["XLA_FLAGS"] == "--existing=1"
    if var == "XLA_DUMP_TO":
        # the reference appends the flag and reports it; the port cannot
        assert jboot.setup_observability({var: value}) == \
            {"xla_dump_to": value}
        assert f"--xla_dump_to={value}" in os.environ["XLA_FLAGS"]
