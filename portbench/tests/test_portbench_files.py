"""Everything is found by name: BENCHMARK.json's configurations, cells
and per-layer metrics each have their file, and a new cell runs from a
new workload file without an edit to any existing file."""

from __future__ import annotations

import json
import os
import uuid

import pytest
import torch

from portbench import common, run
from portbench.tests.conftest import TINY_CELLS, TINY_CONFIGS

BENCH = common.benchmark()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    c = common.load_json("configs", cfg["name"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    assert c["source"] == cfg["source"]
    assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    assert sorted(c["published"]) == sorted(cfg["reduced"])
    common.ModelSpec.from_config(c)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_departures_take_the_published_keys_place(cfg):
    """The file keeps the published values; what the port forces is
    under ``departures``, each ``as_run``, and is what the spec runs."""
    c = common.load_json("configs", cfg["name"])
    assert not set(c["departures"]) & set(cfg["reduced"])
    assert c["tie_word_embeddings"] is False and c["rms_norm_eps"] == 1e-5
    spec = common.ModelSpec.from_config(c)
    assert spec.eps == c["departures"]["rms_norm_eps"]["as_run"] == 1e-6
    assert c["departures"]["lm_head_dtype"]["as_run"] == "float32"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file_found_by_name(cell):
    wl = common.load_json("workloads", cell["name"])
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"]
    assert wl["why"] == cell["why"]
    assert os.path.exists(os.path.join(common.PKG, "drivers",
                                       wl["driver"] + ".py"))
    assert wl["limits"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    read = run.reader(metric["name"])
    assert read({"device_name": "cpu", "recorder": {}}) is None


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in BENCH["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(BENCH, cell["name"],
                                                   "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.cell_metrics(BENCH, cell["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in e2e


def test_a_new_workload_file_runs_without_an_edit():
    """A cell added as new files: a configuration and a workload written
    into the real folders run through ``run.run`` untouched."""
    tag = "t" + uuid.uuid4().hex[:8]
    cfg_path = os.path.join(common.PKG, "configs", f"{tag}.json")
    wl_path = os.path.join(common.PKG, "workloads", f"{tag}.serve.json")
    try:
        with open(cfg_path, "w") as f:
            json.dump(TINY_CONFIGS["tiny_moe"], f)
        with open(wl_path, "w") as f:
            json.dump(dict(TINY_CELLS["tiny_moe.chat"], config=tag), f)
        args = run.parse_args(["--workload", f"{tag}.serve", "--seed", "7",
                               "--seconds", "1", "--trace", "0"])
        code, line = run.run(args, device=torch.device("cpu"))
    finally:
        os.remove(cfg_path)
        os.remove(wl_path)
    assert code == 0 and line["correct"]
    assert "setup_s" in line["metrics"]
