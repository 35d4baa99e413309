"""Device-mesh construction over the processes of a ``torch.distributed``
world: the port of ``k8s_tpu/parallel/mesh.py``.

A ``MeshConfig`` names the reference's six axes, outermost first
(``AXIS_ORDER``):

- ``dp``   pure data parallelism (parameters replicated)
- ``pp``   pipeline stages
- ``fsdp`` data parallelism with sharded parameters and optimizer state
- ``ep``   experts
- ``sp``   sequence
- ``tp``   tensor, innermost

Size-1 axes are always present, so a spec may name every axis.  One
process drives one device, so a mesh position is a process rank; the
layout is the reference's device-id layout with ranks in place of
devices.  The grids are pure functions (:func:`mesh_grid`,
:func:`hybrid_grid`); :func:`make_mesh` and :func:`make_hybrid_mesh` wrap
them in a ``DeviceMesh`` over the initialized default process group.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "sp", "tp")

# Axes that tolerate the slow links between slices (gradient reductions
# and pipeline hops); tp/sp/ep collectives stay inside a slice.
DCN_AXES = ("dp", "fsdp", "pp")


@dataclass
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.fsdp * self.ep * self.sp * self.tp

    def axis_sizes(self) -> dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "fsdp": self.fsdp,
                "ep": self.ep, "sp": self.sp, "tp": self.tp}

    @classmethod
    def auto(cls, num_devices: Optional[int] = None, tp: int = 1,
             sp: int = 1, fsdp: Optional[int] = None, *, ep: int = 1,
             pp: int = 1) -> "MeshConfig":
        """Fill the data axes from the device count: the model axes
        (tp/sp/ep/pp) are fixed, the rest goes to fsdp (default) with dp
        taking what fsdp leaves — the reference's fsdp-first default.
        ``num_devices`` defaults to the world size."""
        n = num_devices if num_devices is not None else _world_size()
        fixed = tp * sp * ep * pp
        if n % fixed != 0:
            raise ValueError(
                f"{n} devices not divisible by tp*sp*ep*pp={fixed}")
        rest = n // fixed
        if fsdp is None:
            fsdp = rest
        if rest % fsdp != 0:
            raise ValueError(
                f"{rest} remaining devices not divisible by fsdp={fsdp}")
        return cls(dp=rest // fsdp, pp=pp, fsdp=fsdp, ep=ep, sp=sp, tp=tp)


@dataclass
class DcnConfig:
    """Cross-slice factors of the hybrid mesh.  Each multiplies the
    same-named in-slice axis; only the axes of ``DCN_AXES`` may span
    slices."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1

    @property
    def num_slices(self) -> int:
        return self.dp * self.fsdp * self.pp

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a, 1) if a in DCN_AXES else 1
                for a in AXIS_ORDER}


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_grid(config: MeshConfig,
              ranks: Optional[Sequence[int]] = None) -> np.ndarray:
    """The ranks laid out over ``AXIS_ORDER`` (dp outermost, tp
    innermost), shaped ``[dp, pp, fsdp, ep, sp, tp]``."""
    ranks = list(ranks if ranks is not None else range(config.num_devices))
    if len(ranks) != config.num_devices:
        raise ValueError(
            f"mesh needs {config.num_devices} devices "
            f"(dp×pp×fsdp×ep×sp×tp), got {len(ranks)}")
    return np.array(ranks).reshape(
        [config.axis_sizes()[a] for a in AXIS_ORDER])


def device_slice_groups(ranks: Sequence[int], num_slices: int,
                        slice_index: Optional[Sequence[int]] = None
                        ) -> list[list[int]]:
    """Group ranks by slice: by ``slice_index[i]`` (the slice of
    ``ranks[i]``, each process's ``MEGASCALE_SLICE_ID``) when it names
    ``num_slices`` slices, else ``num_slices`` equal contiguous chunks of
    the given order — the reference's rule with the reported slice in
    place of ``device.slice_index``."""
    ranks = list(ranks)
    if len(ranks) % num_slices != 0:
        raise ValueError(
            f"{len(ranks)} devices not divisible by {num_slices} slices")
    if slice_index is not None and len(set(slice_index)) == num_slices:
        groups: dict = {i: [] for i in sorted(set(slice_index))}
        for r, s in zip(ranks, slice_index):
            groups[s].append(r)
        sizes = {len(g) for g in groups.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"uneven slice sizes: { {k: len(v) for k, v in groups.items()} }")
        return [groups[i] for i in sorted(groups)]
    per = len(ranks) // num_slices
    return [ranks[i * per:(i + 1) * per] for i in range(num_slices)]


def hybrid_grid(ici: MeshConfig, dcn: DcnConfig,
                ranks: Optional[Sequence[int]] = None,
                slice_index: Optional[Sequence[int]] = None) -> np.ndarray:
    """The two-level layout: each axis has size ``dcn[a] * ici[a]`` and
    the slice boundary is the outer stride of each combined axis, so a
    reduction over ``fsdp`` splits into one inside each slice and one
    across slices.  Rank r of a 2-slice, 4-process world with fsdp 2 in
    each slice sits at ``dp = r // 2``, ``fsdp = r % 2``."""
    per_slice = ici.num_devices
    total = per_slice * dcn.num_slices
    ranks = list(ranks if ranks is not None else range(total))
    if len(ranks) != total:
        raise ValueError(
            f"hybrid mesh needs {dcn.num_slices} slices x {per_slice} "
            f"devices = {total}, got {len(ranks)}")
    groups = device_slice_groups(ranks, dcn.num_slices, slice_index)
    dcn_sizes, ici_sizes = dcn.axis_sizes(), ici.axis_sizes()
    # [slice, within-slice] -> [d0..d5, i0..i5] -> interleave -> combined
    arr = np.array(groups).reshape(
        [dcn_sizes[a] for a in AXIS_ORDER] + [ici_sizes[a] for a in AXIS_ORDER])
    n = len(AXIS_ORDER)
    perm = [k for i in range(n) for k in (i, n + i)]
    return arr.transpose(perm).reshape(
        [dcn_sizes[a] * ici_sizes[a] for a in AXIS_ORDER])


def _device_mesh(grid: np.ndarray, device_type: str):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.as_tensor(grid),
                      mesh_dim_names=AXIS_ORDER)


def make_mesh(config: MeshConfig, ranks: Optional[Sequence[int]] = None,
              *, device_type: str = "cuda"):
    """A ``DeviceMesh`` over :func:`mesh_grid` (needs the default process
    group; every rank calls it)."""
    return _device_mesh(mesh_grid(config, ranks), device_type)


def make_hybrid_mesh(ici: MeshConfig, dcn: DcnConfig,
                     ranks: Optional[Sequence[int]] = None, *,
                     slice_index: Optional[Sequence[int]] = None,
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` over :func:`hybrid_grid`."""
    return _device_mesh(hybrid_grid(ici, dcn, ranks, slice_index),
                        device_type)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh, every axis of ``AXIS_ORDER``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class DataSharding:
    """Which part of a global batch a rank holds: the batch dim is split
    into ``count`` equal blocks over the (dp, fsdp) data axes, dp major,
    and this rank holds block ``index`` — what ``P(("dp", "fsdp"))``
    gives each device in the reference.  With ``seq_count`` > 1 the
    sequence dim (dim 1) is split too, over sp, and the rank holds chunk
    ``seq_index`` of each of its rows: ``P(("dp", "fsdp"), "sp")``.  The
    tp ranks of a position hold the same part."""

    index: int
    count: int
    seq_index: int = 0
    seq_count: int = 1

    def rows(self, batch: int) -> slice:
        if batch % self.count:
            raise ValueError(
                f"global batch {batch} not divisible over {self.count} "
                "data shards (dp x fsdp)")
        per = batch // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def local(self, x):
        """This rank's rows (and sequence chunk) of a global array or
        tensor."""
        x = x[self.rows(len(x))]
        if self.seq_count == 1:
            return x
        L = x.shape[1]
        if L % self.seq_count:
            raise ValueError(f"sequence length {L} not divisible over "
                             f"{self.seq_count} sequence shards (sp)")
        per = L // self.seq_count
        return x[:, self.seq_index * per:(self.seq_index + 1) * per]


def batch_spec() -> tuple[str, ...]:
    """The axes the batch dim is split over: (dp, fsdp)."""
    return ("dp", "fsdp")


def data_sharding(mesh, axes: Sequence[str] = ("dp", "fsdp"),
                  seq_axis: Optional[str] = "sp") -> DataSharding:
    """This rank's block of the batch over ``axes`` of ``mesh``, and its
    chunk of the sequence over ``seq_axis``."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in axes:
        index = index * shape[a] + coord[a]
    seq = (coord[seq_axis], shape[seq_axis]) if seq_axis else (0, 1)
    return DataSharding(index, math.prod(shape[a] for a in axes), *seq)


def parse_topology(topology: str) -> tuple[int, ...]:
    """Parse a Cloud TPU topology string like '4x4' or '2x2x4'."""
    try:
        dims = tuple(int(d) for d in topology.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad topology string {topology!r}") from None
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"bad topology string {topology!r}")
    return dims


def chips_in_topology(topology: str) -> int:
    return math.prod(parse_topology(topology))
