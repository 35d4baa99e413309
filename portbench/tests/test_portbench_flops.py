"""The yardstick's counts against counts made by hand."""

from __future__ import annotations

import pytest

from portbench import common, flops


def _spec(name):
    return common.ModelSpec.from_config(common.load_json("configs", name))


@pytest.mark.parametrize("start,n,window", [
    (0, 1, None), (0, 7, None), (5, 9, None), (0, 10, 3), (4, 12, 5),
    (0, 4096, 2047), (100, 1, 2047)])
def test_attended_pairs_against_the_mask(start, n, window):
    want = sum(1 for q in range(start, start + n) for k in range(q + 1)
               if window is None or q - k < window)
    assert flops.attended_pairs(start, n, window) == want


def test_windowed_pairs_at_the_training_shape():
    # queries 0..2046 see q + 1 keys, the 2049 after them 2047 each
    assert flops.attended_pairs(0, 4096, 2047) == \
        2047 * 2048 // 2 + (4096 - 2047) * 2047


def test_train_step_flops_phi3_by_hand():
    s = _spec("phi3_mini")
    per_layer = 4 * 3072 * 3072 + 3 * 3072 * 8192
    n = 16 * per_layer + 32064 * 3072
    assert n == 1_910_439_936
    pairs = 2047 * 2048 // 2 + 2049 * 2047
    want = 6 * n * 8192 + 12 * 32 * 96 * 16 * 2 * pairs
    assert flops.train_step_flops(s, 2, 4096) == want


def test_moe_counts_top_k_experts_not_all():
    s = _spec("mixtral_8x7b")
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    active = attn + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert flops.layer_matmul_params(s) == active
    assert flops.layer_matmul_params(s, active=False) == \
        attn + 4096 * 8 + 8 * 3 * 4096 * 14336
    # a 10-token prompt and 4 served tokens: 13 tokens through the
    # layers, 4 through the head, causal pairs of 13 positions
    want = (2 * 16 * active * 13 + 2 * 32000 * 4096 * 4
            + 4 * 32 * 128 * 16 * (13 * 14 // 2))
    assert flops.serve_request_flops(s, 10, 4) == want


def test_moe_call_work_by_hand():
    s = _spec("mixtral_8x7b")
    f, b = flops.moe_call_work(32, s, experts_hit=8)
    assert f == 2 * 32 * 4096 * 8 + 6 * 2 * 32 * 4096 * 14336
    assert b == 8 * 3 * 4096 * 14336 * 2 + 4096 * 8 * 4 + 2 * 32 * 4096 * 2


def test_attention_work_by_hand():
    f, b = flops.attention_train_work(2, 8, 4, 2, 16, None)
    assert f == 12 * 4 * 16 * 2 * 36
    assert b == 4 * 2 * 8 * 16 * 2 * 4 + 4 * 2 * 8 * 16 * 2 * 2 \
        + 2 * 4 * 2 * 4 * 8


def test_peaks_and_roofline():
    peak = flops.peaks_for("NVIDIA H100 80GB HBM3")
    assert peak == {"flops": 989e12, "bytes_per_s": 3.35e12}
    assert flops.peaks_for("cpu") is None
    assert flops.roofline_seconds(989e12, 1.0, peak) == 1.0
    assert flops.roofline_seconds(1.0, 3.35e12, peak) == 1.0
