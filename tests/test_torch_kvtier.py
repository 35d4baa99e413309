"""The port's tiered-KV primitives (k8s_tpu_torch/models/kvtier.py)
against the JAX package's (k8s_tpu/models/kvtier.py) on the CPU: chain
fingerprints against the router's affinity hash and the reference's
chains, the spill payload codec byte for byte for f32, f16, bf16 and int8
leaves (a bf16 leaf is stored raw in both packages, as the reference's
dtype rule gives), the spill tier's LRU, budget and counters under one
random operation sequence, and the ``K8S_TPU_SERVE_SPILL_MB`` reader."""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest

from k8s_tpu.models import kvtier as ref
from k8s_tpu.models.paged import quantize_kv as jax_quantize_kv
from k8s_tpu.router import ring
from k8s_tpu_torch.models import engine as engine_lib
from k8s_tpu_torch.models import kvtier
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

TOKENS = [(i * 7 + 3) % 256 for i in range(133)]


@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_chain_fingerprints_are_the_routers(block_size):
    fps = kvtier.chain_fingerprints(TOKENS, block_size)
    assert len(fps) == len(TOKENS) // block_size
    for k, fp in enumerate(fps):
        assert fp == ring.fingerprint_tokens(TOKENS, block_size,
                                             affinity_blocks=k + 1)
    assert fps == ref.chain_fingerprints(TOKENS, block_size)


@pytest.mark.parametrize("max_blocks", [None, 0, 3, 100, -2])
def test_chain_fingerprints_cap_as_the_reference(max_blocks):
    assert kvtier.chain_fingerprints(TOKENS, 16, max_blocks) == \
        ref.chain_fingerprints(TOKENS, 16, max_blocks)


def test_chain_fingerprints_refuse_block_size_zero():
    with pytest.raises(ValueError, match="block_size"):
        kvtier.chain_fingerprints(TOKENS, 0)


def _block(dtype: str, seed: int = 0):
    """One gathered block's leaves in both packages' host forms: the
    reference's numpy (ml_dtypes bfloat16) and the port's (bf16 as
    :data:`kvtier.BF16` bits)."""
    rng = np.random.default_rng(seed)
    shape = (8, 2, 16)  # [block_size, kv_heads, head_dim]
    if dtype == "int8":
        j = {"layer_0/attn/k": rng.integers(-127, 128, shape, np.int8),
             "layer_0/attn/v": rng.integers(-127, 128, shape, np.int8),
             "layer_0/attn/k_scale": rng.random(shape[:2], np.float32),
             "layer_0/attn/v_scale": rng.random(shape[:2], np.float32)}
        return j, {p: a.copy() for p, a in j.items()}
    x = {p: (rng.standard_normal(shape) * 3).astype(np.float32)
         for p in ("layer_0/attn/k", "layer_0/attn/v")}
    if dtype == "bfloat16":
        j = {p: a.astype(ml_dtypes.bfloat16) for p, a in x.items()}
        return j, {p: a.view(np.uint16).view(kvtier.BF16)
                   for p, a in j.items()}
    j = {p: a.astype(dtype) for p, a in x.items()}
    return j, {p: a.copy() for p, a in j.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8).tobytes(), a.shape


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "int8"])
def test_payload_codec_matches_the_reference(dtype):
    jflat, tflat = _block(dtype)
    jpay, jn = ref.encode_payload(jflat, jax_quantize_kv)
    tpay, tn = kvtier.encode_payload(tflat, engine_lib._quantize_host)
    assert tn == jn
    assert set(tpay) == set(jpay)
    for path in jpay:
        assert tpay[path][0] == jpay[path][0], path
        for a, b in zip(tpay[path][1:], jpay[path][1:]):
            assert _bits(a) == _bits(b), path
    # only f32/f16 K/V quantize; bf16 and int8 are stored as they are
    quantized = dtype in ("float32", "float16")
    assert all((p[0] == "q8") == (quantized and path.endswith(("/k", "/v")))
               for path, p in tpay.items())
    jdec, tdec = ref.decode_payload(jpay), kvtier.decode_payload(tpay)
    for path in jdec:
        assert _bits(tdec[path]) == _bits(jdec[path]), path
        if dtype == "bfloat16":
            assert tdec[path].dtype == kvtier.BF16
            assert kvtier.dtype_name(tdec[path].dtype) == "bfloat16"


@pytest.mark.parametrize("path,dtype,want", [
    ("layer_0/attn/k", np.float32, True),
    ("layer_0/attn/v", np.float16, True),
    ("layer_0/attn/k", kvtier.BF16, False),
    ("layer_0/attn/k", np.int8, False),
    ("layer_0/attn/k_scale", np.float32, False),
])
def test_kv_leaf_rule(path, dtype, want):
    assert kvtier._is_kv_leaf(path, dtype) is want
    jdtype = ml_dtypes.bfloat16 if dtype is kvtier.BF16 else dtype
    assert ref._is_kv_leaf(path, jdtype) is want


def test_spill_tier_matches_the_reference_under_random_traffic():
    rng = np.random.default_rng(3)
    budget = 1000
    ours, theirs = kvtier.SpillTier(budget), ref.SpillTier(budget)
    fps = [f"fp{i}" for i in range(12)]
    for _ in range(600):
        op = rng.integers(0, 5)
        fp = fps[rng.integers(0, len(fps))]
        if op == 0:
            n = int(rng.integers(50, 400)) if rng.random() > 0.05 \
                else budget + 1
            payload = {"layer_0/attn/k": ("raw", np.zeros(n, np.int8))}
            got = (ours.put(fp, (1, 2), payload, n),
                   theirs.put(fp, (1, 2), payload, n))
        elif op == 1:
            got = (ours.touch(fp), theirs.touch(fp))
        elif op == 2:
            a, b = ours.get(fp), theirs.get(fp)
            got = (a and a.nbytes, b and b.nbytes)
        elif op == 3:
            a, b = ours.peek(fp), theirs.peek(fp)
            got = (a and a.nbytes, b and b.nbytes)
        else:
            got = (fp in ours, fp in theirs)
        assert got[0] == got[1], (op, fp)
        assert ours.fingerprints() == theirs.fingerprints()
        assert ours.bytes_used == theirs.bytes_used <= budget
        assert len(ours) == len(theirs)
        assert (ours.spilled_blocks, ours.promoted_blocks,
                ours.spill_evictions) == (theirs.spilled_blocks,
                                          theirs.promoted_blocks,
                                          theirs.spill_evictions)
    assert ours.spill_evictions > 0 and ours.promoted_blocks > 0
    ours.clear()
    assert len(ours) == 0 and ours.bytes_used == 0


def test_spill_tier_refuses_negative_budget():
    with pytest.raises(ValueError, match="budget"):
        kvtier.SpillTier(-1)


@pytest.mark.parametrize("raw", [None, "", "0", "64", " 7 ", "-1", "abc",
                                 "1.5"])
def test_env_spill_mb(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("K8S_TPU_SERVE_SPILL_MB", raising=False)
    else:
        monkeypatch.setenv("K8S_TPU_SERVE_SPILL_MB", raw)
    try:
        want = ref.env_spill_mb()
    except ValueError as e:
        with pytest.raises(ValueError, match="K8S_TPU_SERVE_SPILL_MB"):
            kvtier.env_spill_mb()
        assert "K8S_TPU_SERVE_SPILL_MB" in str(e)
        return
    assert kvtier.env_spill_mb() == want


@pytest.mark.parametrize("name", ["bfloat16", "float32", "float16",
                                  "int8", "int32", "uint32", "uint8"])
def test_dtype_table_round_trips(name):
    assert kvtier.dtype_name(kvtier.dtype_of(name)) == name
    assert kvtier.dtype_of(name).itemsize == np.dtype(
        ml_dtypes.bfloat16 if name == "bfloat16" else name).itemsize
