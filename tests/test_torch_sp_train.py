"""Sequence- and tensor-parallel training of the port (``models/train.py``
over an (sp, tp) mesh, ``parallel/``) in gloo worlds against the JAX
package's ``make_sharded_train_step`` on a virtual mesh of the same
shape, and ``train_lm --sp 2`` against itself at one process and across
a resume.

Two worlds (``tests/torch_world.py`` ``sp`` worker), several cases each:

- world 2: the plain ring at sp 2 (GQA repeated before the ring,
  ``grad_accum`` 2), Ulysses at sp 2 with the flash path and the fused
  cross-entropy head, and ``train_lm --sp 2`` (eval every 2 steps) for 4
  steps, and for 2 then 4 steps resumed from its DCP checkpoint;
- world 4: the flash ring at sp 4 in the zigzag layout (GQA native: K/V
  ride the ring at 2 heads), the windowed flash ring at sp 4 (window 6
  across a chunk of 8), and the flash ring at sp 2 x tp 2 (heads split
  over tp, kv heads 2 divide over it).

The tiny Transformer (kv_heads 2) in f32, its weights carried across by
``bridge.params_from_jax``; AdamW with a clip norm low enough to clip
every step.  Losses at rtol 1e-5 / atol 1e-6, as ``test_torch_fsdp.py``
(the chunks' sums reorder the f32 arithmetic).  Final parameters at
atol 5e-6: Adam moves a weight by about ``lr * g / |g|``, so where a
gradient of ~1e-5 differs by its ~1e-8 reordering residue the move
differs by ~lr * 1e-3 a step, and the layer-0 K/V weights here (their
GQA gradients summed over repeated heads and chunks) reach 2.1e-6 after
3 steps at lr 3e-4.  Because clipping and Adam hide a gradient's scale,
the gradient at the final weights on the first batch is compared too
(summed over sp), at rtol 1e-5 / atol 2e-6 of gradients up to 0.11.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.parallel.mesh import MeshConfig, make_mesh
from k8s_tpu_torch import train_lm
from k8s_tpu_torch.models import bridge

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

RTOL, ATOL, PARAM_ATOL, GRAD_ATOL = 1e-5, 1e-6, 5e-6, 2e-6
STEPS, B, L = 3, 4, 32
OPT = dict(lr=3e-4, weight_decay=0.01, clip_norm=0.1)
BASE = dict(kv_heads=2)

# name: (world, sp, tp, config overrides, grad_accum, fused)
CASES = {
    "ring_sp2": (2, 2, 1, dict(use_ring_attention=True), 2, False),
    "ulysses_sp2": (2, 2, 1, dict(use_ring_attention=True,
                                  sp_strategy="ulysses",
                                  use_flash_attention=True), 1, True),
    "zigzag_sp4": (4, 4, 1, dict(use_ring_attention=True,
                                 use_flash_attention=True,
                                 ring_layout="zigzag"), 1, False),
    "window_sp4": (4, 4, 1, dict(use_ring_attention=True,
                                 use_flash_attention=True,
                                 window_size=6), 1, False),
    "flash_sp2_tp2": (4, 2, 2, dict(use_ring_attention=True,
                                    use_flash_attention=True), 1, False),
}
LM_FLAGS = ["--device=cpu", "--preset=tiny", "--batch_size=4",
            "--seq_len=32", "--learning_rate=3e-4", "--clip_norm=1.0",
            "--log_every=1", "--checkpoint_every=2", "--eval_every=2",
            "--eval_batches=2"]


def _config(overrides):
    return dataclasses.replace(jt.tiny_test(), **BASE, **overrides)


def _jax_run(case, params, tokens):
    world, sp, tp, overrides, grad_accum, fused = CASES[case]
    mesh = make_mesh(MeshConfig(sp=sp, tp=tp), jax.devices()[:sp * tp])
    model = jt.Transformer(_config(overrides))
    opt = jtrain.default_optimizer(OPT["lr"], OPT["weight_decay"],
                                   clip_norm=OPT["clip_norm"])
    if fused:
        apply_fn = jtrain.make_fused_lm_apply_fn(model, mesh=mesh)
        loss_fn = jtrain.fused_loss_passthrough
    else:
        def apply_fn(p, t):
            return model.apply(p, t, mesh=mesh)

        loss_fn = jtrain.lm_loss
    state, shardings = jtrain.shard_train_state(
        jtrain.init_state({"params": params}, opt), mesh)
    step = jtrain.make_sharded_train_step(apply_fn, loss_fn, opt, mesh,
                                          shardings, grad_accum=grad_accum)
    losses = []
    for t in tokens:
        state, loss = step(state, (jnp.asarray(t), jnp.asarray(t)))
        losses.append(float(loss))
    final = jax.device_get(state["params"]["params"])
    grads = jax.jit(jax.grad(lambda p: loss_fn(
        apply_fn({"params": p}, tokens[0]), tokens[0])))(final)
    return losses, final, grads


@pytest.fixture(scope="module")
def inputs():
    params = jax.device_get(jt.Transformer(_config({})).init(
        jax.random.PRNGKey(7), jnp.zeros((1, L), jnp.int32))["params"])
    tokens = np.random.default_rng(11).integers(
        0, 256, (STEPS, B, L)).astype(np.int32)
    return params, bridge.params_from_jax(params), tokens


def _spawn(tmp_path, world, sd, tokens, train_lm_flags=None):
    cases = [{"name": n, "sp": sp, "tp": tp, "config": overrides,
              "grad_accum": ga, "fused": fused}
             for n, (w, sp, tp, overrides, ga, fused) in CASES.items()
             if w == world]
    with open(tmp_path / "in.json", "w") as f:
        json.dump({"cases": [{**c, "config": {**BASE, **c["config"]}}
                             for c in cases],
                   "opt": OPT, "train_lm": train_lm_flags}, f)
    np.savez(tmp_path / "in.npz", tokens=tokens,
             **{f"param/{n}": t.numpy() for n, t in sd.items()})
    rcs, outs = torch_world.spawn(
        world, ["tests/torch_world.py", "sp", str(tmp_path)], timeout=150)
    assert rcs == [0] * world, "\n".join(o[-2000:] for o in outs)
    return ([c["name"] for c in cases], json.load(open(tmp_path / "out.json")),
            dict(np.load(tmp_path / "out.npz")))


def _check_case(name, got, port, params, tokens):
    world, sp, tp, *_ = CASES[name]
    assert got["mesh"] == {"dp": 1, "pp": 1, "fsdp": world // (sp * tp),
                           "ep": 1, "sp": sp, "tp": tp}
    assert got["tp_ranks_equal"]
    jlosses, jparams, jgrads = _jax_run(name, params, tokens)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=RTOL, atol=ATOL,
                               err_msg=f"{name} losses")
    for n, t in bridge.params_from_jax(jparams).items():
        np.testing.assert_allclose(port[f"{name}/param/{n}"], t.numpy(),
                                   rtol=RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{name} {n}")
    for n, t in bridge.params_from_jax(jgrads).items():
        np.testing.assert_allclose(port[f"{name}/grad/{n}"], t.numpy(),
                                   rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{name} gradient {n}")


def _lm_losses(recs, key):
    return [r[key] for r in recs if key in r]


def test_world_of_two_ring_ulysses_and_train_lm(tmp_path, inputs):
    params, sd, tokens = inputs
    names, got, port = _spawn(tmp_path, 2, sd, tokens,
                              [*LM_FLAGS, "--sp=2"])
    for name in names:
        _check_case(name, got[name], port, params, tokens)

    lm = got["train_lm"]
    (rc_w, whole), (rc_f, first), (rc_r, resumed) = (
        lm["whole"], lm["first"], lm["resumed"])
    assert (rc_w, rc_f, rc_r) == (0, 0, 0)
    # the resume starts at step 3 from the step-2 checkpoint and ends
    # where the uninterrupted run ends, exactly
    assert [r["step"] for r in resumed if "loss" in r] == [1, 2, 3, 4]
    assert _lm_losses(resumed, "loss")[2:] == _lm_losses(whole, "loss")[2:]
    assert _lm_losses(resumed, "eval_loss") == _lm_losses(whole, "eval_loss")
    assert {"1", "3"} <= set(lm["files"])
    # the weights and two Adam moments in f32, written once though both
    # sp ranks hold them (torch.distributed.checkpoint's dedup)
    cfg = train_lm.build_config(train_lm.parse_args(LM_FLAGS), False)
    n = sum(t.numel() for t in bridge.init_params(cfg, 0, "cpu").values())
    assert 3 * 4 * n <= lm["distcp_bytes"] < 1.5 * 3 * 4 * n

    # the same run at one process (no sp): the sp ring trains the
    # unsharded model
    one = tmp_path / "one"
    assert train_lm.main([*LM_FLAGS, f"--train_dir={one}",
                          "--train_steps=4"]) == 0
    recs = [json.loads(x) for x in open(one / "metrics.jsonl")]
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(_lm_losses(whole, key),
                                   _lm_losses(recs, key), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_world_of_four_zigzag_window_and_tp(tmp_path, inputs):
    params, sd, tokens = inputs
    names, got, port = _spawn(tmp_path, 4, sd, tokens)
    for name in names:
        _check_case(name, got[name], port, params, tokens)


def test_pp_is_refused_by_name(tmp_path):
    # --pp is ported (tests/test_torch_pp_lm.py): one process cannot hold
    # two stages, and pp still refuses the sp ring, as the reference does
    flags = [f for f in LM_FLAGS if not f.startswith("--eval")]
    with pytest.raises(SystemExit, match="multiple of 2 processes"):
        train_lm.main([*flags, f"--train_dir={tmp_path}", "--pp=2"])
    with pytest.raises(SystemExit, match="nest inside the pp"):
        train_lm.main([*flags, f"--train_dir={tmp_path}", "--pp=2",
                       "--sp=2"])
    with pytest.raises(SystemExit, match="multiple of 2 processes"):
        train_lm.main([*LM_FLAGS, f"--train_dir={tmp_path}", "--sp=2"])
    import dataclasses

    from k8s_tpu_torch.models import pp_lm
    from k8s_tpu_torch.models import transformer as tt

    with pytest.raises(ValueError, match="nest inside the pp"):
        pp_lm.make_stage_fn(dataclasses.replace(tt.tiny_test(),
                                                use_ring_attention=True))


def test_zigzag_layout_falls_back_as_the_reference_does():
    def layout(*flags, on_gpu=True):
        args = train_lm.parse_args(["--ring_layout=zigzag", *flags])
        return train_lm._effective_ring_layout(args, on_gpu)

    assert layout("--sp=4") == "zigzag"
    assert layout("--sp=3") == "contiguous"
    assert layout("--sp=4", "--sp_strategy=ulysses") == "contiguous"
    assert layout("--sp=4", on_gpu=False) == "contiguous"
    cfg = train_lm.build_config(train_lm.parse_args(
        ["--preset=tiny", "--sp=2", "--tp=2", "--sp_strategy=ulysses"]),
        False)
    assert (cfg.use_ring_attention, cfg.sp_strategy, cfg.ring_layout,
            cfg.use_flash_attention) == (True, "ulysses", "contiguous", False)
