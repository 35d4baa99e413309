"""Keyword parameters the port takes from the reference, held against it on
the CPU: ``fit(skip_data_on_resume=)``, ``run_serve_gang(pin_cpus=)``,
``PrefetchIterator(transform=)`` and ``prefetch_to_mesh(transform=)``
(``ulysses_attention_local(scale=)`` is in ``test_torch_ring.py``, beside
the other Ulysses cases).

Each takes the reference's default and meaning: a resumed ``fit`` skips
the batches the checkpointed run consumed unless told not to, and then
reads the stream from its head; a pinned gang member runs on one core; a
transform runs on each host batch before it is staged (and sharded).
Inputs are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import data as jdata
from k8s_tpu.models import train as jtrain
from k8s_tpu.models import transformer as jt
from k8s_tpu.parallel import MeshConfig, make_mesh
from k8s_tpu_torch.models import bridge
from k8s_tpu_torch.models import data as tdata
from k8s_tpu_torch.models import mp_serve
from k8s_tpu_torch.models import train as ttrain
from k8s_tpu_torch.models import transformer as tt
from k8s_tpu_torch.parallel import mesh as tmesh
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

B, L = 2, 16


def _batches(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (B, L)).astype(np.int32) for _ in range(n)]


def _logged(batches, log, wrap):
    """The stream of ``(b, b)`` batches, noting each index it hands out."""
    for i, b in enumerate(batches):
        log.append(i)
        yield (wrap(b), wrap(b))


def _jax_fit(params, batches, steps, ckpt_dir, log, skip):
    cj = dataclasses.replace(jt.tiny_test(), max_seq_len=L)
    jm = jt.Transformer(cj)
    opt = jtrain.default_optimizer(1e-3)
    res = jtrain.fit(lambda p, x: jm.apply(p, x), jtrain.lm_loss, opt,
                     jtrain.init_state({"params": params}, opt),
                     make_mesh(MeshConfig(), jax.devices()[:1]),
                     _logged(batches, log, jnp.asarray), steps=steps,
                     checkpoint_dir=ckpt_dir, preemption_save=False,
                     skip_data_on_resume=skip)
    return res.losses


def _port_fit(params, batches, steps, ckpt_dir, log, skip):
    ct = dataclasses.replace(tt.tiny_test(), max_seq_len=L)
    model = tt.Transformer(ct, bridge.params_from_jax(params), device="cpu",
                           trainable=True)
    opt = ttrain.default_optimizer(1e-3)
    res = ttrain.fit(lambda m, x: m(x), ttrain.lm_loss, opt,
                     ttrain.init_state(model, opt),
                     _logged(batches, log, torch.from_numpy), steps=steps,
                     checkpoint_dir=ckpt_dir, preemption_save=False,
                     skip_data_on_resume=skip)
    return res.losses


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "head"])
def test_fit_resume_reads_the_stream_as_the_reference(tmp_path, skip):
    """3 steps with a checkpoint, then a run to step 5 resumed from it:
    the resumed run takes the same batches of the stream as the
    reference's (skip: the 4th and 5th; not skipping: the 1st and 2nd,
    the head of the stream) and reaches the same losses."""
    cj = dataclasses.replace(jt.tiny_test(), max_seq_len=L)
    params = jax.device_get(jt.Transformer(cj).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
    batches = _batches(5)
    got = {}
    for name, run in (("jax", _jax_fit), ("port", _port_fit)):
        d = str(tmp_path / name)
        first, resumed = [], []
        run(params, batches, 3, d, first, skip)
        losses = run(params, batches, 5, d, resumed, skip)
        got[name] = (first, resumed, losses)
    assert got["port"][0] == got["jax"][0] == [0, 1, 2]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1] == ([0, 1, 2, 3, 4] if skip else [0, 1])
    assert len(got["port"][2]) == len(got["jax"][2]) == 2
    np.testing.assert_allclose(got["port"][2], got["jax"][2], atol=5e-4,
                               rtol=5e-4)


def test_serve_gang_pins_each_member_to_one_core():
    """``pin_cpus=True`` puts member i on core i (modulo the host's
    count), one core, as the reference's ``K8S_TPU_SERVE_MP_CPU`` does;
    the default leaves the member the cores the gang was given."""
    script = mp_serve.default_script(1)
    pinned, _ = mp_serve.run_serve_gang(1, script=script, timeout=180,
                                        pin_cpus=True)
    assert pinned.success, pinned.worker_outputs
    assert pinned.chief_result["cpu_affinity"] == [0]
    free, _ = mp_serve.run_serve_gang(1, script=script, timeout=180)
    assert free.success, free.worker_outputs
    import os
    assert free.chief_result["cpu_affinity"] == sorted(
        os.sched_getaffinity(0))


def _transform(batch):
    x, y = batch
    return (x.astype(np.int32) * 3 - 1, y[:, ::-1] + 0.5)


def _host_batches(n=4, rows=8, seed=6):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 50, (rows, 6)).astype(np.int16),
             rng.standard_normal((rows, 6)).astype(np.float32))
            for _ in range(n)]


def test_prefetch_transform_gives_the_reference_batches():
    """The transform runs on each host batch before staging: the port's
    staged tensors equal the reference's device arrays, value and type."""
    want = jdata.PrefetchIterator(iter(_host_batches()), transform=_transform)
    got = tdata.PrefetchIterator(iter(_host_batches()), device="cpu",
                                 transform=_transform)
    try:
        pairs = list(zip(got, want, strict=True))
    finally:
        got.close()
        want.close()
    assert len(pairs) == 4
    for g, w in pairs:
        for gt, wt in zip(g, w, strict=True):
            assert isinstance(gt, torch.Tensor)
            np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
            assert gt.numpy().dtype == np.asarray(wt).dtype


class _FakeMesh:
    """A DeviceMesh's naming and coordinates, without a process group."""

    mesh_dim_names = tmesh.AXIS_ORDER

    def __init__(self, grid, rank):
        self.mesh = grid
        self._coord = [int(c) for c in np.argwhere(grid == rank)[0]]

    def get_coordinate(self):
        return self._coord


def test_prefetch_to_mesh_transform_shards_the_transformed_batch():
    """``prefetch_to_mesh(transform=)``: each rank of an fsdp-4 mesh
    stages the rows of the transformed batch that the reference's
    sharded array gives its device, skip included."""
    jm = make_mesh(MeshConfig(fsdp=4), jax.devices()[:4])
    grid = tmesh.mesh_grid(tmesh.MeshConfig(fsdp=4))
    want = jdata.prefetch_to_mesh(iter(_host_batches()), jm,
                                  transform=_transform)
    want.skip(1)
    ref = list(want)
    want.close()
    assert len(ref) == 3
    for rank in range(4):
        it = tdata.prefetch_to_mesh(iter(_host_batches()),
                                    _FakeMesh(grid, rank), "cpu",
                                    transform=_transform)
        it.skip(1)
        try:
            mine = list(it)
        finally:
            it.close()
        assert len(mine) == 3
        for g, w in zip(mine, ref):
            for gt, wt in zip(g, w):
                shard = [s for s in wt.addressable_shards
                         if s.device.id == rank][0]
                np.testing.assert_array_equal(gt.numpy(),
                                              np.asarray(shard.data))
