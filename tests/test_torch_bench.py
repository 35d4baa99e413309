"""The port's bench (k8s_tpu_torch/bench.py) against the root bench.py on
the CPU: the Recorder's persistence rules case for case on both modules,
the same line from the same records, gpt2-small's decode accounting
against the JAX package's Transformer (shapes only, through
``jax.eval_shape``), every cell at tiny widths, and ``main``'s exit
codes."""

from __future__ import annotations

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import bench as ref
from k8s_tpu_torch import bench as port
from k8s_tpu_torch.models import resnet, vit
from k8s_tpu_torch.ops import _common

MODULES = pytest.mark.parametrize("bench", [ref, port],
                                  ids=["reference", "port"])
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("BENCH_NO_PERSIST", "BENCH_ALLOW_SINGLE_REPEAT", "BENCH_ONLY",
              "BENCH_SMOKE", "BENCH_SEQ", "BENCH_WINDOW", "BENCH_KV_CACHE",
              "BENCH_FUSED_CE", "BENCH_DECODE_PARAM_DTYPE",
              "BENCH_NO_CONTROL", "BENCH_FLASH_BLOCK_Q",
              "BENCH_FLASH_BLOCK_K", "BENCH_PHASE_TIMEOUT",
              "K8S_TPU_PLATFORM"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BENCH_REPEATS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def lastgood(tmp_path):
    return str(tmp_path / "LASTGOOD.json")


# -- the Recorder: tests/test_bench_recorder.py's cases on both modules ----

@MODULES
def test_single_repeat_never_persists(bench, lastgood):
    r = bench.Recorder(lastgood)
    r.record("transformer", {"tokens_per_sec_per_chip": 1.0, "repeats": 1},
             on_hardware=True, device_kind=H100)
    assert "transformer" not in r.last_good["benchmarks"]
    assert not os.path.exists(lastgood)
    got, stale = r.get("transformer", allow_stale=True)
    assert got["repeats"] == 1 and not stale


@MODULES
def test_missing_repeats_key_treated_as_single(bench, lastgood):
    r = bench.Recorder(lastgood)
    r.record("decode", {"tokens_per_sec_per_chip": 9.9}, on_hardware=True)
    assert "decode" not in r.last_good["benchmarks"]


@MODULES
def test_override_flag_persists_single_repeat(bench, lastgood, monkeypatch):
    monkeypatch.setenv("BENCH_ALLOW_SINGLE_REPEAT", "1")
    r = bench.Recorder(lastgood)
    r.record("transformer", {"tokens_per_sec_per_chip": 2.0, "repeats": 1},
             on_hardware=True)
    assert "transformer" in r.last_good["benchmarks"]


@MODULES
def test_multi_repeat_persists_with_provenance(bench, lastgood):
    r = bench.Recorder(lastgood)
    r.record("resnet50", {"value": 5.0, "repeats": 3}, on_hardware=True,
             device_kind=H100)
    rec = json.load(open(lastgood))["benchmarks"]["resnet50"]
    assert rec["repeats"] == 3
    assert rec["measured_at"] and rec["device_kind"] == H100


@MODULES
def test_no_persist_env_blocks_hardware_write(bench, lastgood, monkeypatch):
    monkeypatch.setenv("BENCH_NO_PERSIST", "1")
    r = bench.Recorder(lastgood)
    r.record("resnet50", {"value": 5.0, "repeats": 3}, on_hardware=True)
    assert not os.path.exists(lastgood)


@MODULES
def test_stale_record_missing_required_keys_reads_as_absent(bench, lastgood):
    with open(lastgood, "w") as f:
        json.dump({"benchmarks": {"decode_depth": {"old": 1}}}, f)
    r = bench.Recorder(lastgood)
    got, stale = r.get("decode_depth", allow_stale=True)
    assert got is None and not stale


@MODULES
def test_round5_record_names_have_required_keys(bench):
    for name in ("resnet50", "transformer", "decode", "vit", "decode_depth"):
        assert name in bench._REQUIRED_KEYS, name


def test_required_keys_are_the_references():
    assert port._REQUIRED_KEYS == ref._REQUIRED_KEYS


# a battery as both recorders see it: (name, result, on_hardware, kind)
RESULTS = {
    "resnet50": {"images_per_sec_per_chip": 3600.5, "stem": "conv",
                 "images_per_sec_per_chip_std": 11.25, "repeats": 5,
                 "step_time_ms": 35.5, "flops_per_step": 3.1488e12,
                 "flops_per_sec_per_chip": 8.87e13},
    "transformer": {"tokens_per_sec_per_chip": 91000.0,
                    "tokens_per_sec_per_chip_std": 120.5,
                    "step_time_ms": 90.02, "n_params": 123532032,
                    "flash_attention": True, "fused_ce": False,
                    "flops_per_sec_per_chip": 7.2e13, "seq": 1024,
                    "repeats": 5},
    "transformer_xla_control": {"tokens_per_sec_per_chip": 70000.0,
                                "repeats": 3},
    "decode": {"tokens_per_sec_per_chip": 2500.25,
               "tokens_per_sec_per_chip_std": 3.5, "per_token_ms": 12.8,
               "n_params": 123532032, "batch_per_chip": 32,
               "prompt_len": 128, "new_tokens": 128, "repeats": 5,
               "flops_per_sec_per_chip": 6.2e11, "hbm_utilization": 0.0061,
               "hbm_bound_tokens_per_sec_per_chip": 402000.5,
               "hbm_bytes_per_token": 8333000},
    "vit": {"images_per_sec_per_chip": 1079.5,
            "images_per_sec_per_chip_std": 2.0, "repeats": 5,
            "step_time_ms": 118.6, "flops_per_step": 1.35e13,
            "flops_per_sec_per_chip": 1.14e14},
    "decode_depth": {"prefill_oneshot_prompt_tokens_per_sec_per_chip": 1e6,
                     "prefill_chunked_prompt_tokens_per_sec_per_chip": 8e5,
                     "chunked_prefill_vs_oneshot": 0.8, "beam4_overhead": 1.7,
                     "greedy_per_token_ms": 0.5, "beam4_per_token_ms": 0.9,
                     "spec_tokens_per_sec_per_chip": 9000.0,
                     "spec_tokens_per_call": 3.9, "spec_draft_k": 4,
                     "sweep_batch": 128,
                     "decode_b128_tokens_per_sec_per_chip": 8000.0,
                     "repeats": 5},
}


def _fill(bench, path, names, on_hardware=True, kind=None):
    r = bench.Recorder(path)
    for name in names:
        r.record(name, RESULTS[name], on_hardware, kind)
    return r


def test_the_same_records_persist_the_same_file(tmp_path, monkeypatch):
    files = {}
    for bench in (ref, port):
        monkeypatch.setattr(bench, "_utcnow", lambda: "2026-01-01T00:00:00Z")
        path = str(tmp_path / f"{bench.__name__}.json")
        r = _fill(bench, path, list(RESULTS), kind=H100)
        r.record("decode", {"tokens_per_sec_per_chip": 1.0, "repeats": 1},
                 True, H100)  # a single repeat: fresh only
        files[bench] = open(path).read()
        reread = bench.Recorder(path)
        files[bench, "get"] = [reread.get(n, allow_stale=s)
                               for n in list(RESULTS) + ["missing"]
                               for s in (False, True)]
    assert files[ref] == files[port]
    assert files[ref, "get"] == files[port, "get"]


LINES = [  # (fresh names, stale names, the want_* flags)
    (["resnet50", "transformer", "transformer_xla_control"], [],
     dict(want_resnet=True, want_transformer=True)),
    (["transformer"], [], dict(want_resnet=False, want_transformer=True)),
    (["decode"], [], dict(want_resnet=False, want_transformer=False,
                          want_decode=True)),
    (["vit"], [], dict(want_resnet=False, want_transformer=False,
                       want_vit=True)),
    (["decode_depth"], [], dict(want_resnet=False, want_transformer=False,
                                want_decode_depth=True)),
    (["resnet50"], ["transformer", "transformer_xla_control"],
     dict(want_resnet=True, want_transformer=True)),
    (["transformer"], ["transformer_xla_control"],
     dict(want_resnet=False, want_transformer=True)),
]


@pytest.mark.parametrize("fresh,stale,want", LINES)
def test_build_output_gives_the_references_line(tmp_path, monkeypatch,
                                                fresh, stale, want):
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"resnet50_images_per_sec_per_chip": 3000.0,
                                "transformer_tokens_per_sec_per_chip": 9e4,
                                "decode_tokens_per_sec_per_chip": 2000.0}))
    lines = []
    for bench in (ref, port):
        monkeypatch.setattr(bench, "BASELINE_FILE", str(base))
        path = str(tmp_path / f"{bench.__name__}.json")
        _fill(bench, path, stale)
        r = _fill(bench, path, fresh, on_hardware=False)
        for allow_stale in (False, True):
            lines.append(bench.build_output(r, allow_stale=allow_stale,
                                            device_kind=None, n_chips=1,
                                            **want))
    assert lines[:2] == lines[2:]


def test_h100_mfu_is_flops_over_989_tflops(tmp_path, monkeypatch):
    monkeypatch.setattr(port, "BASELINE_FILE", str(tmp_path / "none.json"))
    r = _fill(port, str(tmp_path / "lg.json"),
              ["resnet50", "transformer", "decode", "vit"], False, H100)
    out = {}
    for want in (dict(want_resnet=True, want_transformer=True),
                 dict(want_resnet=False, want_transformer=False,
                      want_decode=True),
                 dict(want_resnet=False, want_transformer=False,
                      want_vit=True)):
        out.update(port.build_output(r, allow_stale=False, device_kind=None,
                                     n_chips=1, **want))
    for key, cell in (("resnet50_mfu", "resnet50"),
                      ("transformer_mfu", "transformer"),
                      ("decode_mfu", "decode"), ("vit_mfu", "vit")):
        want = round(RESULTS[cell]["flops_per_sec_per_chip"] / 989e12, 4)
        assert out[key] == want, key
    assert out["peak_flops_per_chip"] == 989e12
    assert out["device_kind"] == H100 and out["vs_baseline"] == 1.0


@pytest.mark.parametrize("kind,flops,hbm", [
    (H100, 989e12, 3350.0), ("NVIDIA H100 PCIe", None, None),
    ("NVIDIA A100-SXM4-80GB", None, None), ("TPU v5 lite", None, None),
    ("cpu", None, None)])
def test_peak_tables_know_the_h100_sxm_only(kind, flops, hbm):
    assert port.peak_flops_for(kind) == flops
    assert port.peak_hbm_gbps_for(kind) == hbm


# -- gpt2-small's decode accounting against the JAX package's model ------

def _jax_roofline(kv_cache_dtype):
    """bench.py's bench_decode accounting over the JAX Transformer's
    params, shapes only."""
    from k8s_tpu.models.serving import cast_params_for_serving
    from k8s_tpu.models.transformer import Transformer

    cfg = ref._gpt2_small_config(max_seq_len=256, use_flash_attention=False,
                                 kv_cache_dtype=kv_cache_dtype)
    tokens = jax.ShapeDtypeStruct((1, 128), jnp.int32)
    params = jax.eval_shape(
        lambda t: Transformer(cfg).init(jax.random.PRNGKey(1), t), tokens
    )["params"]
    params = jax.eval_shape(cast_params_for_serving, params)
    leaves = jax.tree_util.tree_leaves(params)
    n_params = sum(math.prod(x.shape) for x in leaves)
    param_bytes = sum(math.prod(x.shape) * x.dtype.itemsize for x in leaves)
    head_dim = cfg.head_dim or cfg.hidden // cfg.heads
    if cfg.kv_cache_dtype == "int8":
        kv_vec_bytes = head_dim * 1 + 4
    else:
        kv_vec_bytes = head_dim * jnp.dtype(cfg.dtype).itemsize
    avg_len = 128 + 128 / 2.0
    kv = 2 * cfg.layers * cfg.kv_heads * kv_vec_bytes * avg_len
    return {"n_params": n_params, "param_bytes": int(param_bytes),
            "hbm_bytes_per_token": int(param_bytes / 32 + kv),
            "kv_cache_bytes_per_token": int(kv)}


@pytest.fixture(scope="module")
def gpt2_serving_params():
    from k8s_tpu_torch.models.serving import cast_params_for_serving

    cfg = port._gpt2_small_config(max_seq_len=256)
    return cast_params_for_serving(port._params(cfg, torch.device("cpu")))


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_gpt2_small_decode_accounting_is_the_jax_models(
        gpt2_serving_params, kv_cache_dtype):
    cfg = port._gpt2_small_config(max_seq_len=256,
                                  kv_cache_dtype=kv_cache_dtype)
    got = port.decode_roofline(cfg, gpt2_serving_params, 32, 128, 128)
    assert got == _jax_roofline(kv_cache_dtype)
    # the transformer cell counts the same parameters
    assert got["n_params"] == sum(
        t.numel() for t in gpt2_serving_params.values())


# -- every cell at tiny widths on the CPU ---------------------------------

_GPT2_SMALL = port._gpt2_small_config


def _tiny_lm(max_seq_len, **overrides):
    cfg = _GPT2_SMALL(max_seq_len, **overrides)
    return dataclasses.replace(cfg, vocab_size=256, hidden=64, ffn_hidden=128,
                               layers=2, heads=4, kv_heads=4)


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setenv("K8S_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(port, "_gpt2_small_config", _tiny_lm)
    monkeypatch.setattr(port, "IMAGE_SIZE", 16)
    monkeypatch.setattr(resnet, "resnet50", lambda **kw: resnet.ResNet(
        (1, 1), num_filters=8, **kw))
    monkeypatch.setattr(vit, "vit_b16", lambda **kw: vit.ViTConfig(
        image_size=32, patch_size=8, hidden=64, ffn_hidden=128, layers=2,
        heads=4, **kw))
    _common.reset_launches()
    yield
    assert not any(_common.launches().values()), _common.launches()


CELL_CALLS = {
    "resnet50": lambda: port.bench_resnet50(batch_per_chip=2, iters=1,
                                            warmup=1),
    "transformer": lambda: port.bench_transformer(batch_per_chip=1, seq=32,
                                                  iters=1, warmup=1),
    "transformer_xla_control": lambda: port.bench_transformer(
        batch_per_chip=1, seq=32, iters=1, warmup=1, use_flash=False,
        repeats=3),
    "vit": lambda: port.bench_vit(batch_per_chip=2, iters=1, warmup=1),
    "decode": lambda: port.bench_decode(batch_per_chip=2, prompt_len=8,
                                        new_tokens=4, calls=1),
    # BENCH_SMOKE (set by the test) cuts the speculative prompt to 16
    "decode_depth": lambda: port.bench_decode_depth(
        batch_per_chip=2, prompt_len=16, chunk=4, beam_prompt=8, beam_new=4,
        sweep_batch=3, calls=1),
}


@pytest.mark.parametrize("cell", list(CELL_CALLS))
def test_cell_at_tiny_width_has_every_required_key(tiny, cell, monkeypatch):
    monkeypatch.setenv("BENCH_SMOKE", "1")
    out = CELL_CALLS[cell]()
    for key in port._REQUIRED_KEYS[cell]:
        assert key in out, key
        if not isinstance(out[key], (bool, str)):
            assert math.isfinite(out[key]), (key, out[key])
    if "repeats" in out:
        assert out["repeats"] == (3 if cell.endswith("control") else 2)
    if cell.startswith("transformer"):
        assert not out["flash_attention"]  # no kernel off CUDA
        assert math.isfinite(out["first_loss"])
        assert out["xla_flops_per_step"] is None


def test_decode_cell_on_int8_kv_and_f32_params(tiny, monkeypatch):
    monkeypatch.setenv("BENCH_KV_CACHE", "int8")
    monkeypatch.setenv("BENCH_DECODE_PARAM_DTYPE", "float32")
    out = CELL_CALLS["decode"]()
    assert out["kv_cache_dtype"] == "int8" and out["param_dtype"] == "float32"
    assert "hbm_utilization" not in out  # the CPU has no HBM peak
    cfg = _tiny_lm(12, kv_cache_dtype="int8")
    assert out["param_bytes"] == 4 * out["n_params"]
    assert out["kv_cache_bytes_per_token"] == int(
        2 * cfg.layers * cfg.kv_heads * (cfg.dims_per_head + 4) * 10.0)


@pytest.mark.parametrize("knob", ["BENCH_FLASH_BLOCK_Q", "BENCH_FLASH_BLOCK_K"])
def test_flash_block_knobs_are_refused_by_name(monkeypatch, knob):
    monkeypatch.setenv(knob, "128")
    with pytest.raises(SystemExit, match="BENCH_FLASH_BLOCK_Q"):
        port.bench_transformer()


def test_window_without_flash_is_refused(tiny, monkeypatch):
    monkeypatch.setenv("BENCH_WINDOW", "16")
    with pytest.raises(SystemExit, match="BENCH_WINDOW needs the flash"):
        CELL_CALLS["transformer"]()


# -- main ------------------------------------------------------------------

@pytest.fixture()
def records(tmp_path, monkeypatch):
    monkeypatch.setattr(port, "LASTGOOD_FILE", str(tmp_path / "lg.json"))
    monkeypatch.setattr(port, "BASELINE_FILE", str(tmp_path / "base.json"))
    return tmp_path


def test_main_decode_on_the_cpu_prints_one_line(tiny, records, monkeypatch,
                                                capsys):
    monkeypatch.setenv("BENCH_ONLY", "decode")
    cell = port.bench_decode
    monkeypatch.setattr(port, "bench_decode", lambda: cell(
        batch_per_chip=2, prompt_len=8, new_tokens=4, calls=1))
    assert port.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "decode_tokens_per_sec_per_chip"
    assert out["device_kind"] == "cpu" and out["n_chips"] == 1
    assert "partial" not in out and "decode_mfu" not in out
    assert os.listdir(records) == []  # nothing persisted off CUDA


def test_main_without_a_card_is_fatal_and_measures_nothing(
        records, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")

    def measured(*a, **kw):
        raise AssertionError("a cell ran without a device")
    for cell in ("bench_resnet50", "bench_transformer", "bench_vit",
                 "bench_decode", "bench_decode_depth"):
        monkeypatch.setattr(port, cell, measured)
    assert port.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "FATAL" in out.err
    assert os.listdir(records) == []


def test_main_without_a_card_prints_the_last_good_record(
        records, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setenv("BENCH_ONLY", "vit")
    port.Recorder(port.LASTGOOD_FILE).record("vit", RESULTS["vit"], True,
                                             H100)
    assert port.main() == 0
    out = json.loads(capsys.readouterr().out)
    assert out["results_from_last_good"] == ["vit"]
    assert out["vit_mfu"] == round(1.14e14 / 989e12, 4)


def test_main_refuses_an_unknown_cell(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ONLY", "bert")
    assert port.main() == 2
    assert "FATAL: unknown BENCH_ONLY" in capsys.readouterr().err
