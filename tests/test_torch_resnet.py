"""The port's ResNet (k8s_tpu_torch/models/resnet.py) against the JAX
package's flax module on the CPU.

Inputs come from numpy with a seed; flax parameters (with BatchNorm scales,
biases and running stats perturbed away from their init, so every block
does work) reach the port through ``bridge.resnet_from_jax`` and come back
through ``bridge.resnet_to_jax``.  Tolerances, f32 throughout: logits and
gradients 1e-4 relative to the largest magnitude of the reference array
(summation order of the convolutions); BatchNorm running stats 1e-5
(``rtol``, with ``atol`` 1e-6 for entries near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_tpu.models import resnet as jr
from k8s_tpu.models import train as jtrain
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import resnet as tr
from k8s_tpu_torch.models import train as ttrain
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

TOL = 1e-4
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
STEMS = ("conv", "s2d")


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max abs err {err} vs scale {scale}"


def _images(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    return x, y


def _perturbed(variables, seed):
    """BatchNorm leaves moved off their init (scale 1 or 0, bias 0, mean
    0, var 1) so the comparison reaches every branch."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.2 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, variables)


@pytest.fixture(scope="module", params=STEMS)
def pair(request):
    """(stem, flax model, perturbed variables, port model holding them)."""
    stem = request.param
    jm = jr.ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8,
                   dtype=jnp.float32, stem=stem)
    x, _ = _images()
    variables = _perturbed(
        jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               train=False)), 2)
    tm = tr.resnet18_thin(stem=stem, device="cpu")
    tm.load_state_dict(bridge.resnet_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return stem, jm, variables, tm


def _load(tm, variables):
    tm.load_state_dict(bridge.resnet_from_jax(variables["params"],
                                              variables["batch_stats"]))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_flax(pair, train):
    stem, jm, variables, tm = pair
    _load(tm, variables)
    x, _ = _images(seed=3)
    if train:
        want, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, what=f"{stem} logits")
    _, stats = bridge.resnet_to_jax(tm.state_dict())
    want_stats = mutated["batch_stats"] if train else \
        variables["batch_stats"]
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=STATS_RTOL, atol=STATS_ATOL),
        stats, jax.device_get(want_stats))


@pytest.mark.parametrize("stem", STEMS)
def test_bf16_forward_matches_flax(stem):
    """bf16 convolutions over f32 parameters, BN normalising in f32 and
    rounding once, the global mean in bf16 into an f32 head: logits in
    eval and train mode within 1e-2 relative (under three bf16 steps of
    2^-8: a conv output rounded the other way moves what follows it), BN
    running stats within 2^-7 relative (f32 statistics of bf16 conv
    outputs, each within one bf16 step of the reference's, so a variance
    within about two)."""
    jm = jr.ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8,
                   dtype=jnp.bfloat16, stem=stem)
    x, _ = _images(seed=12)
    variables = _perturbed(jax.device_get(
        jm.init(jax.random.PRNGKey(13), jnp.asarray(x), train=False)), 14)
    tm = tr.resnet18_thin(stem=stem, dtype=torch.bfloat16, device="cpu")
    _load(tm, variables)
    for train in (False, True):
        want = jm.apply(variables, jnp.asarray(x), train=train,
                        mutable=["batch_stats"] if train else False)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=train)
        assert got.dtype == torch.float32
        _close(got.numpy(), want[0] if train else want, tol=1e-2,
               what=f"bf16 {stem} train={train}")
    _, stats = bridge.resnet_to_jax(tm.state_dict())
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w),
                                                rtol=2 ** -7, atol=1e-4),
        stats, jax.device_get(want[1]["batch_stats"]))


def test_sgd_momentum_steps_match_flax_optax(pair):
    """Two steps of SGD with momentum (torch.optim.SGD(lr=0.1,
    momentum=0.9) is optax.sgd(0.1, momentum=0.9): t = g + 0.9 t, p -=
    0.1 t): the losses, the first step's gradients, and the params and
    batch_stats after both steps."""
    stem, jm, variables, tm = pair
    _load(tm, variables)
    batches = [_images(seed=10 + i) for i in range(2)]

    opt = optax.sgd(0.1, momentum=0.9)

    @jax.jit
    def jstep(params, stats, opt_state, x, y):
        def loss_fn(p):
            logits, mut = jm.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"])
            return jtrain.cross_entropy_loss(logits, y), mut["batch_stats"]
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, opt_state,
                loss, grads)

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = opt.init(params)
    topt = torch.optim.SGD(tm.parameters(), lr=0.1, momentum=0.9)
    for i, (x, y) in enumerate(batches):
        params, stats, opt_state, jloss, jgrads = jstep(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(y))
        topt.zero_grad()
        loss = ttrain.cross_entropy_loss(
            tm(torch.from_numpy(x), train=True), torch.from_numpy(y))
        loss.backward()
        if i == 0:
            grads, _ = bridge.resnet_to_jax(
                {n: p.grad for n, p in tm.named_parameters()})
            jax.tree_util.tree_map_with_path(
                lambda path, g, w: _close(g, w, what=f"grad {path}"),
                grads, jax.device_get(jgrads))
        topt.step()
        _close(loss.item(), float(jloss), what=f"loss step {i}")
    got_params, got_stats = bridge.resnet_to_jax(tm.state_dict())
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: _close(g, w, what=f"param {path}"),
        got_params, jax.device_get(params))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=STATS_RTOL, atol=STATS_ATOL),
        got_stats, jax.device_get(stats))


def test_s2d_stem_equals_conv_stem():
    """The 7x7/s2 stem's weights through stem_weights_to_s2d give the
    same function on the s2d stem: in the port, and against the
    reference's 7x7 model."""
    jm = jr.ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8,
                   dtype=jnp.float32, stem="conv")
    x, _ = _images(seed=5)
    variables = _perturbed(jax.device_get(
        jm.init(jax.random.PRNGKey(6), jnp.asarray(x), train=False)), 7)
    conv = tr.resnet18_thin(stem="conv", device="cpu")
    _load(conv, variables)
    sd = conv.state_dict()
    w7 = sd["conv_init.weight"].numpy().transpose(2, 3, 1, 0)
    sd["conv_init.weight"] = torch.from_numpy(
        tr.stem_weights_to_s2d(w7).transpose(3, 2, 0, 1).copy())
    s2d = tr.resnet18_thin(stem="s2d", device="cpu")
    s2d.load_state_dict(sd)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        a = conv(torch.from_numpy(x), train=False)
        b = s2d(torch.from_numpy(x), train=False)
    _close(b.numpy(), a.numpy(), what="s2d vs conv stem")
    _close(b.numpy(), want, what="s2d vs the reference's conv stem")


def test_space_to_depth_and_stem_weights_match_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.space_to_depth(torch.from_numpy(x), 2).numpy(),
        np.asarray(jr.space_to_depth(jnp.asarray(x), 2)))
    w7 = rng.normal(size=(7, 7, 3, 5)).astype(np.float32)
    got = tr.stem_weights_to_s2d(w7)
    assert got.shape == (4, 4, 12, 5) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jr.stem_weights_to_s2d(w7))
    with pytest.raises(ValueError, match="7x7"):
        tr.stem_weights_to_s2d(np.zeros((3, 3, 3, 5), np.float32))


def _shapes_equal(port_tree, ref_tree):
    got = jax.tree_util.tree_map(np.shape, port_tree)
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref_tree)
    assert got == want


@pytest.mark.parametrize("stem", STEMS)
def test_resnet50_parameters_match_reference(stem):
    """Every parameter and running stat of ResNet-50, shape for shape,
    against the reference's, taken with jax.eval_shape (nothing runs at
    full size on the JAX side)."""
    shapes = jax.eval_shape(
        lambda: jr.resnet50(stem=stem).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
            train=False))
    model = tr.resnet50(stem=stem, device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_params == n_ref and 25e6 < n_params < 26e6, n_params
    params, stats = bridge.resnet_to_jax(model.state_dict())
    _shapes_equal(params, shapes["params"])
    _shapes_equal(stats, shapes["batch_stats"])
    # the zero-initialised last BN of every block, as the reference's
    assert all(not b.bn3.scale.any()
               for b in model.blocks.values())
    assert model.conv_init.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_bridge_round_trips(pair):
    stem, _, variables, _ = pair
    params, stats = bridge.resnet_to_jax(bridge.resnet_from_jax(
        variables["params"], variables["batch_stats"]))
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)),
            got, want)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(jax.device_get(want))


def test_unknown_stem_and_cuda_without_cuda_are_refused():
    with pytest.raises(ValueError, match="unknown stem"):
        tr.resnet18_thin(stem="patchify", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tr.resnet18_thin()
