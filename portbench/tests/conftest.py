"""CPU fixtures: tiny configurations and cells of each kind, found by name
as the real ones are, and torch held to one thread."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import common

TINY_CONFIGS = {
    "tiny_dense": {
        "source": "test", "hidden_act": "silu", "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "max_position_embeddings": 64, "rope_theta": 10000.0,
        "sliding_window": 7, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True, "torch_dtype": "float32",
        "vocab_size": 128},
    "tiny_moe": {
        "source": "test", "hidden_act": "silu", "hidden_size": 64,
        "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 128, "rope_theta": 1e6,
        "sliding_window": None, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True, "torch_dtype": "float32",
        "vocab_size": 128, "num_local_experts": 4, "num_experts_per_tok": 2,
        "expert_capacity_factor": 2.0},
}

TINY_CELLS = {
    "tiny_dense.train": {
        "config": "tiny_dense", "driver": "train", "chips": 1, "why": "test",
        "batch": 2, "seq_len": 32, "corpus_windows": 16, "shard_windows": 8,
        "optimizer": {"lr": 0.001}, "trace_slice_s": 0.5,
        "limits": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3,
                   "rows_outside_corpus": 0}},
    "tiny_moe.chat": {
        "config": "tiny_moe", "driver": "serve", "chips": 1, "why": "test",
        "slots": 4, "trace_slice_s": 0.5,
        "traffic": {"clients": 4, "requests_per_client": 4, "stagger_s": 0.01,
                    "prompt": {"median": 12, "sigma": 0.6, "min": 4,
                               "max": 40},
                    "output": {"median": 6, "sigma": 0.5, "min": 2,
                               "max": 12}},
        "check": {"sample_requests": 3},
        "limits": {"served_gap_mean": 1e-3, "failed_requests": 0,
                   "wrong_lengths": 0}},
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The tiny configurations and cells, and BENCHMARK.json's metrics
    extended to them; returns the directory their files are in."""
    for kind, items in (("configs", TINY_CONFIGS), ("workloads", TINY_CELLS)):
        (tmp_path / kind).mkdir()
        for name, body in items.items():
            (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
    real_load = common.load_json

    def load_json(kind, name):
        path = tmp_path / kind / f"{name}.json"
        if path.exists():
            return json.loads(path.read_text())
        return real_load(kind, name)

    bench = common.benchmark()
    train = [c for c in TINY_CELLS if TINY_CELLS[c]["driver"] == "train"]
    serve = [c for c in TINY_CELLS if TINY_CELLS[c]["driver"] == "serve"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is not None:
            kind = common.load_json("workloads", cells[0])["driver"]
            m["workloads"] = cells + (train if kind == "train" else serve)
    monkeypatch.setattr(common, "load_json", load_json)
    monkeypatch.setattr(common, "benchmark", lambda: bench)
    return tmp_path
