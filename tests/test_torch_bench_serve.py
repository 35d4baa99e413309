"""The port's serving bench (k8s_tpu_torch/harness/bench_serve.py) against
the JAX package's (k8s_tpu/harness/bench_serve.py) on the CPU: the
workload generators give the reference's token lists call for call, the
grounded speculative prompts equal the reference's on bridged weights,
and the port's phases, equivalence checks and ``run_bench`` run over real
HTTP at tiny size.  The wall-time bounds of ``run_bench`` (recorder
within 3%, spec_batched >= 1.5x, batched >= single-flight) were set for
the reference's model on a quiet host; under a parallel test run they
may fail, and only they may."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from k8s_tpu.harness import bench_serve as ref
from k8s_tpu_torch.harness import bench_serve as bs
from k8s_tpu_torch.models import bridge

GRID = [(rank, n) for rank in (0, 1, 5, 31, 99) for n in (1, 4, 13, 40)]


@pytest.fixture(autouse=True)
def _one_thread():
    # the phases run a server, an engine thread and clients in this
    # process: torch's intra-op threads on top of them oversubscribe a
    # host shared with other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rank,length", GRID)
def test_prompt_is_the_references(rank, length):
    assert bs._prompt(rank, length) == ref._prompt(rank, length)


@pytest.mark.parametrize("length", [0, 1, 6, 40, 300])
def test_template_is_the_references(length):
    assert bs._template(length) == ref._template(length)


@pytest.mark.parametrize("rank,i", [(0, 0), (3, 1), (4, 2), (17, 5),
                                    (99, 0)])
@pytest.mark.parametrize("length", [6, bs.SPEC_PROMPT_LEN, 41])
def test_spec_prompt_is_the_references(rank, i, length):
    assert bs.SPEC_PROMPT_LEN == ref.SPEC_PROMPT_LEN
    assert bs._spec_prompt(rank, i, length) == \
        ref._spec_prompt(rank, i, length)
    assert bs._spec_prompt(rank, i) == ref._spec_prompt(rank, i)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("rank,i,template_len,tail_len",
                         [(0, 0, 40, 6), (3, 1, 40, 6), (99, 99, 40, 6),
                          (7, 2, 17, 3), (12, 4, 8, 0)])
def test_shared_prompt_is_the_references(rank, i, template_len, tail_len,
                                         shared):
    assert bs._shared_prompt(rank, i, template_len, tail_len, shared) == \
        ref._shared_prompt(rank, i, template_len, tail_len, shared)


def test_constants_and_downsample_are_the_references():
    assert bs.PROMPT_LENGTHS == ref.PROMPT_LENGTHS
    timeline = [(i, i % 5) for i in range(77)]
    for points in (4, 32, 100):
        assert bs._downsample(timeline, points) == \
            ref._downsample(timeline, points)


def _bridged(hidden=64, layers=2):
    """The reference's bench model and the port's config, the port's
    weights carried across from the JAX params."""
    jcfg, jparams = ref.build_model(0, hidden=hidden, layers=layers)
    cfg, _ = bs.build_model(0, hidden=hidden, layers=layers, device="cpu")
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == torch.float32
    return jcfg, jparams, cfg, bridge.params_from_jax(jparams)


def test_grounded_spec_prompts_equal_the_references_on_bridged_weights():
    # at this width the first three bases have no repetitive tail and are
    # skipped, so the fourth generation gives the prompt
    jcfg, jparams, cfg, sd = _bridged(hidden=48, layers=1)
    want = ref._grounded_spec_prompts(jcfg, jparams, n=1)
    got = bs._grounded_spec_prompts(cfg, sd, n=1, device="cpu")
    assert got == want
    assert len(got) == 1 and len(got[0]) == bs.SPEC_PROMPT_LEN
    assert got[0][:8] == [(3 * 29 + j * 11 + 3) % 256 for j in range(8)]


@pytest.fixture(scope="module")
def tiny():
    return bs.build_model(0, hidden=64, layers=2, device="cpu")


@pytest.mark.parametrize("slots,request_log", [(0, False), (2, True)])
def test_run_phase_serves_without_errors(tiny, slots, request_log):
    cfg, sd = tiny
    phase = bs.run_phase(cfg, sd, slots=slots, concurrency=3,
                         requests_per_client=2, max_new_short=3,
                         max_new_long=6, request_log=request_log,
                         device="cpu")
    assert phase["errors"] == [] and phase["requests"] == 6
    assert phase["mode"] == ("batched" if slots else "single_flight")
    # client 0 issues long generations, the others short ones
    assert phase["tokens"] == 2 * 6 + 4 * 3
    assert phase["tokens_per_s"] > 0
    assert "compile" not in phase and "compile_ledger" not in phase
    if request_log:
        # cleared at the warm-up boundary: the measured requests only
        assert phase["request_phases"]["requests"] == 6
        assert phase["requests_audit"] is not None
        assert phase["decode_steps"] > 0
    else:
        assert phase["request_phases"] is None


def test_run_phase_sampled_and_spec_workloads(tiny):
    cfg, sd = tiny
    sampled = bs.run_phase(cfg, sd, slots=2, concurrency=2,
                           requests_per_client=2, max_new_short=3,
                           max_new_long=6, temperature=1.0,
                           shared_frac=0.8, device="cpu")
    assert sampled["errors"] == [] and sampled["tokens"] == 12
    assert sampled["prefix"]["hits"] >= 1  # the template is shared
    spec = bs.run_phase(cfg, sd, slots=2, concurrency=2,
                        requests_per_client=2, max_new_short=5,
                        max_new_long=6, spec_k=3, device="cpu")
    assert spec["errors"] == [] and spec["tokens"] == 20
    assert spec["spec"]["verify_steps"] > 0 and spec["spec"]["draft_k"] == 3


def test_lane_equivalence_checks_hold(tiny):
    cfg, sd = tiny
    assert bs.check_sampled_equivalence(cfg, sd, device="cpu")
    assert bs.check_spec_equivalence(cfg, sd, device="cpu")


WALL_TIME_FAILURES = ("request recorder overhead too high",
                      "spec_batched only", "batched greedy")


def test_run_bench_keys_and_failures(monkeypatch):
    # the spec phases' hidden-512 model at the smallest depth that keeps
    # their shape; both lanes serve the same model either way
    build = bs.build_model
    monkeypatch.setattr(
        bs, "build_model",
        lambda seed=0, hidden=256, layers=4, device="cuda":
        build(seed, hidden=hidden // 4, layers=1, device=device))
    try:
        result = bs.run_bench(concurrency=2, slots=2,
                              requests_per_client=1, max_new_short=2,
                              max_new_long=4, device="cpu")
        failures = []
    except RuntimeError as e:
        result = e.result
        failures = result["failures"]
    for msg in failures:
        assert msg.startswith(WALL_TIME_FAILURES), msg
    assert result["sampled_equivalence_ok"] is True
    assert result["spec_equivalence_ok"] is True
    want = {"metric", "value", "unit", "concurrency", "requests_per_client",
            "max_new_short", "max_new_long", "single_flight", "batched",
            "batched_recorder_off", "recorder_overhead", "speedup",
            "short_p99_single_s", "short_p99_batched_s",
            "sampled_exclusive", "sampled_batched", "sampled_speedup",
            "sampled_shared_frac", "sampled_equivalence_ok",
            "spec_exclusive", "spec_batched", "spec_speedup",
            "spec_draft_k", "spec_acceptance_rate", "spec_equivalence_ok",
            "requests_audit"}
    assert set(result) - {"failures"} == want
    # the reference's phase keys, less its compile inventory
    phase_keys = {"mode", "slots", "request_log", "request_phases",
                  "requests_audit", "temperature", "batch_sampling",
                  "batch_spec", "shared_frac", "prefix", "spec",
                  "requests", "errors", "wall_s", "tokens", "tokens_per_s",
                  "latency_p50_s", "latency_p99_s", "short_p99_s",
                  "mean_batch_occupancy", "occupancy_timeline",
                  "decode_steps", "prefill_programs"}
    for mode in ("single_flight", "batched", "batched_recorder_off",
                 "sampled_exclusive", "sampled_batched", "spec_exclusive",
                 "spec_batched"):
        assert set(result[mode]) == phase_keys, mode
        assert result[mode]["errors"] == [], mode
    assert result["recorder_overhead"]["ratio"] > 0
    assert set(result["requests_audit"]) == {
        "batched", "sampled_batched", "sampled_exclusive", "spec_batched",
        "spec_exclusive"}
    assert np.isfinite(result["value"])


def test_bench_failures_name_each_broken_bound():
    ok = {"tokens_per_s": 10.0, "errors": [], "mode": "m"}
    result = {"single_flight": dict(ok, tokens_per_s=20.0),
              "batched": ok, "batched_recorder_off": ok,
              "recorder_overhead": {"ratio": 0.5},
              "sampled_equivalence_ok": False,
              "spec_equivalence_ok": False, "spec_speedup": 1.0,
              "spec_batched": dict(ok, errors=["HTTPError: 503"])}
    got = bs.bench_failures(result)
    assert len(got) == 6
    assert got[0].startswith("phase m: request errors")
    assert any("output-invariant" in m and "sampled" in m for m in got)
    assert any("output-invariant" in m and "speculative" in m for m in got)
    assert not bs.bench_failures(dict(
        result, single_flight=ok, recorder_overhead={"ratio": 1.0},
        sampled_equivalence_ok=True, spec_equivalence_ok=True,
        spec_speedup=2.0, spec_batched=ok))


def test_cuda_without_a_card_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg, sd = tiny
    with pytest.raises(RuntimeError, match="cuda"):
        bs.run_phase(cfg, sd, slots=2, concurrency=1,
                     requests_per_client=1, max_new_short=2,
                     max_new_long=2)
