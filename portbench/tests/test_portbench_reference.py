"""The plain reference against the port at a tiny size of each
architecture (windowed dense, MoE with GQA), on the CPU in f32, with the
weights the benchmark makes from a seed."""

from __future__ import annotations

import pytest
import torch

from portbench import common
from portbench.drivers import port_config
from portbench.reference import model as ref
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.tests.conftest import TINY_CONFIGS


def _ref_logits(spec, seed, tokens):
    p = ref_train._leaves(spec, seed, "cpu")
    h = p["embedding"][tokens]
    pos = torch.arange(tokens.shape[1])
    for i in range(spec.layers):
        w = {n[len(f"layers.{i}."):]: t for n, t in p.items()
             if n.startswith(f"layers.{i}.")}
        h = ref.layer(h, w, spec, pos, "f32")
    return ref.head(h, p["final_norm.scale"], p["embedding"], spec, "f32")


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_reference_matches_the_port(name):
    from k8s_tpu_torch.models.transformer import Transformer

    spec = common.ModelSpec.from_config(TINY_CONFIGS[name])
    cfg = port_config(spec, remat=False)
    params = common.make_params(spec, 3, "cpu", torch.float32)
    model = Transformer(cfg, params, device="cpu")
    tokens = torch.randint(0, spec.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(tokens)
        want = _ref_logits(spec, 3, tokens)
    assert (got - want).abs().max() < 1e-4
    # the control's rounding is far outside that
    with torch.no_grad():
        p = ref_train._leaves(spec, 3, "cpu")
        low = ref_train.loss_fn(p, tokens, spec, "fp8")
        exact = ref_train.loss_fn(p, tokens, spec, "f32")
    assert abs(float(low) - float(exact)) > 1e-4


def test_served_logits_follow_the_full_forward():
    spec = common.ModelSpec.from_config(TINY_CONFIGS["tiny_moe"])
    prompt, served = list(range(5, 25)), [3, 9, 1, 4]
    lg = ref_serve.logits_at_served(spec, 3, [(prompt, served)], "cpu",
                                    torch.float32)[0]
    full = _ref_logits(spec, 3, torch.tensor([prompt + served[:-1]]))[0]
    assert torch.allclose(lg, full[len(prompt) - 1:], atol=1e-5)
    gaps = ref_serve.served_gaps([lg], [(prompt, served)])[0]
    best = lg.argmax(-1).tolist()
    assert ref_serve.served_gaps([lg], [(prompt, best)])[0] == [0.0] * 4
    assert all(g >= 0 for g in gaps)


def test_weights_are_the_seeds_and_only_the_seeds():
    spec = common.ModelSpec.from_config(TINY_CONFIGS["tiny_moe"])
    a = common.make_params(spec, 2**40 + 1, "cpu", torch.bfloat16)
    b = common.layer_params(spec, 2**40 + 1, 1, "cpu", torch.bfloat16)
    c = common.make_params(spec, 2**40 + 2, "cpu", torch.bfloat16)
    for n, t in b.items():
        assert torch.equal(a[f"layers.1.{n}"], t)
    assert not torch.equal(a["layers.1.moe_mlp.w_up"],
                           c["layers.1.moe_mlp.w_up"])
