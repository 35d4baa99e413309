"""The port's mesh and sharding rules (``k8s_tpu_torch/parallel/``)
against the JAX package's on the CPU (8 virtual devices, as
``tests/test_parallel.py``): ``MeshConfig.auto`` and its refusals, the
rank grid of ``make_mesh`` and of the hybrid multi-slice mesh against
JAX's device-id grid, ``device_slice_groups``, the topology parser, the
batch rows each rank holds, and the fsdp dimension each rule picks.  All
pure functions of shapes: no process group is made here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from k8s_tpu.models import transformer as jt
from k8s_tpu.parallel import mesh as jmesh
from k8s_tpu.parallel import sharding as jsharding
from k8s_tpu_torch.parallel import mesh as tmesh
from k8s_tpu_torch.parallel import sharding as tsharding
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

AUTO = [dict(num_devices=8), dict(num_devices=8, tp=2),
        dict(num_devices=8, fsdp=2), dict(num_devices=8, tp=2, sp=2),
        dict(num_devices=8, pp=2, fsdp=2), dict(num_devices=4, ep=2),
        dict(num_devices=1)]


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("kw", AUTO, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_auto_matches_jax(kw):
    want = jmesh.MeshConfig.auto(**kw)
    got = tmesh.MeshConfig.auto(**kw)
    assert got.axis_sizes() == want.axis_sizes()
    assert got.num_devices == want.num_devices


@pytest.mark.parametrize("kw,match", [
    (dict(num_devices=6, tp=4), "not divisible by tp"),
    (dict(num_devices=8, fsdp=3), "not divisible by fsdp"),
])
def test_auto_refuses_as_jax(kw, match):
    for lib in (jmesh, tmesh):
        with pytest.raises(ValueError, match=match):
            lib.MeshConfig.auto(**kw)


def test_auto_defaults_to_the_world_size():
    # no process group in the test process: a world of one
    assert tmesh.MeshConfig.auto().axis_sizes() == tmesh.MeshConfig(
    ).axis_sizes()


@pytest.mark.parametrize("sizes", [
    dict(fsdp=8), dict(dp=2, fsdp=4), dict(dp=2, fsdp=2, tp=2),
    dict(pp=2, fsdp=2, sp=2), dict(ep=2, tp=4), dict(fsdp=2)])
def test_mesh_grid_is_jax_device_grid(sizes):
    cfg = jmesh.MeshConfig(**sizes)
    want = _ids(jmesh.make_mesh(cfg, jax.devices()[:cfg.num_devices]))
    got = tmesh.mesh_grid(tmesh.MeshConfig(**sizes))
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="mesh needs"):
        tmesh.mesh_grid(tmesh.MeshConfig(**sizes), range(cfg.num_devices + 1))


@pytest.mark.parametrize("ici,dcn", [
    (dict(fsdp=2), dict(dp=2)),
    (dict(fsdp=2, tp=2), dict(dp=2)),
    (dict(fsdp=4), dict(fsdp=2)),
    (dict(fsdp=2), dict(dp=2, pp=2)),
])
def test_hybrid_grid_is_jax_device_grid(ici, dcn):
    jici, jdcn = jmesh.MeshConfig(**ici), jmesh.DcnConfig(**dcn)
    n = jici.num_devices * jdcn.num_slices
    want = _ids(jmesh.make_hybrid_mesh(jici, jdcn, jax.devices()[:n]))
    got = tmesh.hybrid_grid(tmesh.MeshConfig(**ici), tmesh.DcnConfig(**dcn))
    np.testing.assert_array_equal(got, want)


def test_hybrid_slice_boundary_is_the_outer_stride():
    # rank r of a 2-slice, 4-process world: dp = r // 2, fsdp = r % 2
    grid = tmesh.hybrid_grid(tmesh.MeshConfig(fsdp=2), tmesh.DcnConfig(dp=2))
    for r in range(4):
        (dp, _, fsdp, *_), = np.argwhere(grid == r)
        assert (dp, fsdp) == (r // 2, r % 2)
    # the slice each process reports decides its group, not its rank
    grid = tmesh.hybrid_grid(tmesh.MeshConfig(fsdp=2), tmesh.DcnConfig(dp=2),
                             slice_index=[1, 0, 1, 0])
    assert grid.reshape(2, 2).tolist() == [[1, 3], [0, 2]]


def test_device_slice_groups_as_jax():
    want = jmesh.device_slice_groups(jax.devices(), 4)
    got = tmesh.device_slice_groups(range(8), 4)
    assert got == [[d.id for d in g] for g in want]
    for lib, devs in ((jmesh, jax.devices()), (tmesh, list(range(8)))):
        with pytest.raises(ValueError, match="not divisible"):
            lib.device_slice_groups(devs, 3)
    assert tmesh.device_slice_groups(range(4), 2, [0, 1, 0, 1]) == [
        [0, 2], [1, 3]]
    with pytest.raises(ValueError, match="uneven"):
        tmesh.device_slice_groups(range(4), 2, [0, 0, 0, 1])


@pytest.mark.parametrize("topo", ["4x4", "2x2x4", "8", "1x1"])
def test_topology_parser_as_jax(topo):
    assert tmesh.parse_topology(topo) == jmesh.parse_topology(topo)
    assert tmesh.chips_in_topology(topo) == jmesh.chips_in_topology(topo)


@pytest.mark.parametrize("bad", ["4xx", "", "0x4", "axb"])
def test_topology_parser_refuses_as_jax(bad):
    for lib in (jmesh, tmesh):
        with pytest.raises(ValueError, match="bad topology"):
            lib.parse_topology(bad)


class _FakeMesh:
    """A DeviceMesh's naming and coordinates, without a process group."""

    mesh_dim_names = tmesh.AXIS_ORDER

    def __init__(self, grid, rank):
        self.mesh = grid
        self._coord = [int(c) for c in np.argwhere(grid == rank)[0]]

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("ici,dcn", [
    (dict(fsdp=4), None), (dict(dp=2, fsdp=2), None),
    (dict(fsdp=2, tp=2), None), (dict(fsdp=2), dict(dp=2))])
def test_each_rank_holds_the_rows_jax_gives_its_device(ici, dcn):
    if dcn:
        jm = jmesh.make_hybrid_mesh(jmesh.MeshConfig(**ici),
                                    jmesh.DcnConfig(**dcn), jax.devices()[:4])
        grid = tmesh.hybrid_grid(tmesh.MeshConfig(**ici),
                                 tmesh.DcnConfig(**dcn))
    else:
        cfg = jmesh.MeshConfig(**ici)
        jm = jmesh.make_mesh(cfg, jax.devices()[:cfg.num_devices])
        grid = tmesh.mesh_grid(tmesh.MeshConfig(**ici))
    batch = np.arange(8 * 3).reshape(8, 3)
    arr = jax.device_put(batch, NamedSharding(jm, P(("dp", "fsdp"))))
    assert tmesh.batch_spec() == ("dp", "fsdp")
    for shard in arr.addressable_shards:
        rank = shard.device.id
        rows = tmesh.data_sharding(_FakeMesh(grid, rank)).local(batch)
        np.testing.assert_array_equal(rows, np.asarray(shard.data))


def test_data_sharding_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.DataSharding(0, 3).rows(8)
    assert tmesh.DataSharding(2, 4).rows(8) == slice(4, 6)


def test_logical_to_spec_as_jax():
    # tests/test_parallel.py's cases
    assert tsharding.logical_to_spec(("mlp", "embed")) == tuple(
        jsharding.logical_to_spec(("mlp", "embed"))) == ("tp", "fsdp")
    assert tsharding.logical_to_spec((None,)) == tuple(
        jsharding.logical_to_spec((None,)))
    rules = {"a": None, "b": None}
    for shape, size in (((8, 10), 4), ((6, 10), 4), (None, None),
                        ((16, 16), 8), ((3, 5), 2)):
        kw = {} if shape is None else dict(shape=shape, fsdp_size=size)
        want = tuple(jsharding.logical_to_spec(("a", "b"), rules=rules, **kw))
        got = tsharding.logical_to_spec(("a", "b"), rules=rules, **kw)
        assert got == want, (shape, size)
    assert tsharding.logical_to_spec(("a", "b"), rules=rules, shape=(8, 10),
                                     fsdp_size=4) == ("fsdp", None)


def _tiny_params():
    params = jax.device_get(jt.Transformer(jt.tiny_test()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {jax.tree_util.keystr(k): v for k, v in flat}


@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_fsdp_sharding_picks_jax_dims(fsdp):
    leaves = {"w": np.zeros((16, 64)), "b": np.zeros((64,)),
              "odd": np.zeros((3, 5)), "tie": np.zeros((32, 32)),
              "cube": np.zeros((4, 12, 12)), **_tiny_params()}
    jm = jmesh.make_mesh(jmesh.MeshConfig(fsdp=fsdp), jax.devices()[:fsdp])
    want = jsharding.fsdp_sharding(leaves, jm)
    got = tsharding.fsdp_sharding(leaves, {"fsdp": fsdp})
    for name in leaves:
        assert got[name] == tuple(want[name].spec), name
    assert got["odd"] == () and got["b"] == ()


def test_infer_logical_axes_as_jax():
    leaves = {"w": np.zeros((16, 64)), "b": np.zeros((64,)),
              "cube": np.zeros((4, 12, 3))}
    want = jsharding.infer_logical_axes(leaves)
    assert tsharding.infer_logical_axes(leaves) == {k: tuple(v)
                                                   for k, v in want.items()}


def test_placement_fn_maps_the_fsdp_dim():
    import torch
    from torch.distributed.tensor import Shard

    a, b, c = (torch.nn.Parameter(torch.zeros(s))
               for s in ((4, 8), (8,), (2, 3)))
    fn = tsharding.placement_fn({a: (None, "fsdp"), b: (), c: ("fsdp", None)})
    assert fn(a) == Shard(1) and fn(b) is None and fn(c) == Shard(0)
