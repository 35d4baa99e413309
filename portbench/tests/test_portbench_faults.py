"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a cell can have (one card: no exchange
between chips to leave out), and so does the control, the reference in
fp8 in the program's place.  The look for a card is skipped; the sizes
are tiny."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, common, run, traffic
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.tests.conftest import TINY_CELLS


def _line(cell, seed=2**31 + 77):
    args = run.parse_args(["--workload", cell, "--seed", str(seed),
                           "--seconds", "1", "--trace", "0"])
    code, line = run.run(args, device=torch.device("cpu"))
    assert code == 0
    return line


def test_sound_runs_are_correct(tiny):
    assert _line("tiny_dense.train")["correct"]
    assert _line("tiny_moe.chat")["correct"]


def test_train_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    from k8s_tpu_torch.models import train

    monkeypatch.setattr(train.Optimizer, "update", lambda self, opt: None)
    line = _line("tiny_dense.train")
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(tiny, monkeypatch):
    from k8s_tpu_torch.models import train

    full = train.lm_loss

    def half(logits, tokens):
        n = tokens.shape[0] // 2
        return full(logits[:n], tokens[:n])

    monkeypatch.setattr(train, "lm_loss", half)
    assert not _line("tiny_dense.train")["correct"]


def test_serve_token_altered_where_it_is_produced(tiny, monkeypatch):
    from k8s_tpu_torch.models import engine

    first = engine.Engine._first_token

    def altered(self, req, last_logits):
        tok, gen = first(self, req, last_logits)
        return (tok + 1) % self.config.vocab_size, gen

    monkeypatch.setattr(engine.Engine, "_first_token", altered)
    assert not _line("tiny_moe.chat")["correct"]


def test_serve_step_that_leaves_the_cache_unchanged(tiny, monkeypatch):
    from k8s_tpu_torch.models import paged

    monkeypatch.setattr(paged, "paged_kv_write", lambda *a, **k: None)
    assert not _line("tiny_moe.chat")["correct"]


def test_train_control_fp8_fails_the_limits(tiny):
    wl = TINY_CELLS["tiny_dense.train"]
    spec = common.ModelSpec.from_config(common.load_json("configs",
                                                         wl["config"]))
    B, L = wl["batch"], wl["seq_len"]
    rows = list(traffic.token_corpus(5, 3 * B * L, spec.vocab)
                .astype(np.int64).reshape(3, B, L))
    ref = ref_train.run_steps(spec, 5, rows, 1e-3, "cpu")
    low = ref_train.run_steps(spec, 5, rows, 1e-3, "cpu", precision="fp8")
    checks = check.judge(check.train_numbers(low, ref), wl["limits"])
    assert not all(c["ok"] for c in checks)


def test_serve_control_fp8_fails_the_limit(tiny):
    wl = TINY_CELLS["tiny_moe.chat"]
    spec = common.ModelSpec.from_config(common.load_json("configs",
                                                         wl["config"]))
    plan = traffic.serve_plan(wl["traffic"], 5, spec.vocab)
    seqs = [(r["prompt"], [1] * r["max_new"]) for r in plan[0]]
    f32 = ref_serve.logits_at_served(spec, 5, seqs, "cpu", torch.float32)
    low = ref_serve.logits_at_served(spec, 5, seqs, "cpu", torch.float32,
                                     precision="fp8")
    gaps = [x for g in ref_serve.control_gaps(f32, low) for x in g]
    assert sum(gaps) / len(gaps) > wl["limits"]["served_gap_mean"]
