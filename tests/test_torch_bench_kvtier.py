"""The port's tiered-KV bench (k8s_tpu_torch/harness/bench_kvtier.py)
against the JAX package's (k8s_tpu/harness/bench_kvtier.py) on the CPU:
the lanes and prompts are the reference's, and each stage runs on the
port's engine and servers at tiny size: the spill arm demotes and
promotes and beats evict-recompute on prefix hits, identity holds through
demote and promote on every lane (int8 pool), and a dedup migration
storm skips blocks and answers as the local oracle."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from k8s_tpu.harness import bench_kvtier as ref
from k8s_tpu_torch.harness import bench_kvtier as kv
from k8s_tpu_torch.harness import bench_serve as bs


def test_lanes_are_the_references():
    assert kv.LANES == ref.LANES


@pytest.mark.parametrize("lane", ref.LANES)
def test_lane_kwargs_are_the_references(lane):
    assert kv._lane_kwargs(lane) == ref._lane_kwargs(lane)


@pytest.mark.parametrize("rank,n", [(0, 1), (7, 64), (500, 80), (999, 96),
                                    (23, 16)])
def test_prompt_is_the_references(rank, n):
    got, want = kv._prompt(rank, n), ref._prompt(rank, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(autouse=True)
def _one_thread():
    # an engine thread and servers in this process: torch's intra-op
    # threads on top of them oversubscribe a host shared with other
    # test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return bs.build_model(0, hidden=64, layers=2, device="cpu")


def test_spill_arm_demotes_promotes_and_beats_recompute_on_hits(tiny):
    cfg, sd = tiny
    kw = dict(corpus=12, prompt_len=96, rounds=1, prefix_blocks=6,
              max_new=2, device="cpu")
    spill = kv._spill_arm(cfg, sd, spill_mb=16, **kw)
    base = kv._spill_arm(cfg, sd, spill_mb=None, **kw)
    assert spill["spill_demotions"] >= 1 and spill["spill_promotions"] >= 1
    assert base["spill_demotions"] == 0 and base["spill_promotions"] == 0
    assert spill["tokens"] == base["tokens"] == 12 * 2
    assert spill["prefix_hit_rate"] > base["prefix_hit_rate"]
    # the hit-rate and demote/promote messages stay quiet; tokens/s is a
    # wall-time ratio and may go either way here
    for msg in kv.spill_failures(spill, base):
        assert msg.startswith("spill tokens/s"), msg


def test_spill_identity_holds_on_every_lane(tiny):
    cfg, sd = tiny
    failures: list = []
    out = kv._spill_identity(cfg, sd, prompt_len=80, max_new=8,
                             failures=failures, device="cpu")
    assert failures == []
    assert set(out) == set(kv.LANES)
    assert all(r["ok"] and r["promoted_blocks"] >= 1 for r in out.values())


def test_dedup_storm_skips_blocks_and_answers_as_local(tiny):
    cfg, sd = tiny
    failures: list = []
    out = kv._dedup_storm(cfg, sd, base_len=64, tail_len=16, storm=3,
                          max_new=4, failures=failures, device="cpu")
    assert failures == []
    assert out["skipped_blocks"] > 0 and out["bytes_saved_est"] > 0
    assert all(r["ok"] and r["deduped_blocks"] >= 1
               for r in out["identity"].values())
