"""A whole run of each kind of cell on the CPU, at a tiny size."""

from __future__ import annotations

import pytest
import torch

from portbench import run


def _run(cell, seed=2**31 + 12345, seconds=1.5, trace=0):
    args = run.parse_args(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)])
    code, line = run.run(args, device=torch.device("cpu"))
    assert code == 0
    return line


@pytest.mark.parametrize("cell", ["tiny_dense.train", "tiny_moe.chat"])
def test_tiny_cell_runs_correct(tiny, cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-2] == "checks"
    assert line["failed"] == 0 and line["attempted"] > 0
    assert "setup_s" in line["metrics"]


def test_window_counts_every_request_sent_until_the_last_answer():
    """Requests in flight at the deadline count in the rate, over the time
    to the last answer, and in the tail; one never answered fails and
    has no end."""
    from portbench import common
    from portbench.drivers import serve

    spec = common.ModelSpec.from_config(TINY)
    plan = [[{"prompt": [1] * 8, "max_new": 4}] * 2]
    results = [
        {"c": 0, "i": 0, "send": 0.0, "done": 4.0, "status": 200,
         "tokens": [1] * 4},
        {"c": 0, "i": 1, "send": 5.0, "done": 20.0, "status": 200,
         "tokens": [1] * 4},
        {"c": 0, "i": 1, "send": 9.0, "done": None, "status": None}]
    w = serve._window(results, plan, spec, t0=0.0, deadline=10.0)
    assert w["e2e"]["serve_tokens_per_s"] == pytest.approx(8 / 20.0)
    assert w["attempted"] == 3 and w["failed"] == 1 and w["answered"] == 2
    assert w["drain_s"] == pytest.approx(10.0)
    assert w["e2e_p95_ms"] == float("inf")


TINY = {"hidden_act": "silu", "hidden_size": 8, "intermediate_size": 16,
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "max_position_embeddings": 16, "rope_theta": 1e4,
        "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
        "vocab_size": 32}
