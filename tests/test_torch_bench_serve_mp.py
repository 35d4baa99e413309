"""The port's serving-gang bench (k8s_tpu_torch/harness/bench_serve_mp.py)
against the JAX package's (k8s_tpu/harness/bench_serve_mp.py) on the CPU:
the request script and the spec-derived shard fractions are the
reference's, and one ``run_bench(processes=2)`` over gloo holds token
identity between the 1- and 2-process gangs, clean exits, and each
worker's measured pool and params share against the expectation.  The
0.12 efficiency floor is a wall-time ratio of a loopback gang on a
shared host: it may fail here, and only it may."""

from __future__ import annotations

import pytest

from k8s_tpu.harness import bench_serve_mp as ref
from k8s_tpu_torch.harness import bench_serve_mp as mp
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)


@pytest.mark.parametrize("requests,max_new", [(1, 1), (3, 8), (7, 24),
                                              (24, 24)])
def test_bench_script_is_the_references(requests, max_new):
    assert mp.bench_script(requests, max_new) == \
        ref.bench_script(requests, max_new)


@pytest.mark.parametrize("tp,hidden,layers", [(2, 64, 2), (4, 256, 4)])
def test_shard_fractions_are_the_references(tp, hidden, layers):
    assert mp._shard_fractions(tp, hidden, layers) == \
        ref._shard_fractions(tp, hidden, layers)


def test_two_process_gang_matches_one_process():
    try:
        result = mp.run_bench(processes=2, requests=6, max_new=8, slots=4,
                              threads=2, hidden=64, layers=2, timeout=120,
                              device="cpu")
    except RuntimeError as e:
        result = e.result
        for msg in result["failures"]:
            assert msg.startswith("2-process mesh at"), msg
    assert result["token_identity_ok"] is True
    assert result["single_host"]["exit_codes"] == [0]
    assert result["mesh"]["exit_codes"] == [0, 0]
    assert result["single_host"]["tp_degree"] == 1
    assert result["mesh"]["tp_degree"] == 2
    assert result["mesh"]["errors"] == []
    assert result["mesh"]["tokens"] == 6 * 8
    expect = result["shard_fractions_expected"]
    assert expect == mp._shard_fractions(2, 64, 2)
    measured = result["shard_fractions_measured"]
    assert [m["process_id"] for m in measured] == [1]
    for m in measured:
        assert abs(m["pool"] - expect["pool"]) < 1e-3
        assert abs(m["params"] - expect["params"]) < 1e-3
    assert result["plan_bus"]["pipelined"]
    # a CPU gang launches no hand-written kernel
    assert not any(result["mesh"]["launches"].values())
