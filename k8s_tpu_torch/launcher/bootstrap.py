"""In-pod bootstrap: the operator-injected env contract, then
``torch.distributed``, then the device mesh.

Port of ``k8s_tpu/launcher/bootstrap.py``.  The operator is not rewritten,
so the env names stay those it injects (``k8s_tpu.controller_v2.tpu_config``):

    JAX_COORDINATOR_ADDRESS  host:port of process 0 (the rendezvous store)
    JAX_NUM_PROCESSES        world size
    JAX_PROCESS_ID           this pod's rank
    TPU_ACCELERATOR_TYPE / TPU_TOPOLOGY        slice topology
    MEGASCALE_NUM_SLICES / MEGASCALE_SLICE_ID  multi-slice
    CHECKPOINT_DIR           the resume directory
    K8S_TPU_PLATFORM         ``cpu`` or ``gpu``/``cuda``: the device asked for

``initialize_distributed`` is idempotent and a no-op for one process.
For more, it joins ``torch.distributed`` at the coordinator address:
NCCL when the process runs on CUDA, gloo on the CPU.  One process drives
one device (rank ``r`` takes GPU ``r % device_count``).
``make_training_mesh`` lays the world out as the reference's mesh; at one
process it first makes a one-rank group, so a mesh always exists.
``setup_observability`` / ``stop_observability`` read the reference's
profiler hooks (``JAX_PROFILE_DIR``: a ``torch.profiler`` trace;
``JAX_PROFILER_PORT`` and ``XLA_DUMP_TO`` have no counterpart and are
named in a warning).
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Optional

from k8s_tpu_torch.parallel.mesh import (
    DcnConfig, MeshConfig, make_hybrid_mesh, make_mesh, mesh_shape,
)

log = logging.getLogger(__name__)

# A collective that waits longer than this fails: a survivor of a dead
# peer exits instead of hanging.
TIMEOUT_S = 300

_device = None       # this process's device, fixed at bring-up
_host_group = None   # the gloo group for host-side coordination


@dataclass
class LauncherConfig:
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    accelerator_type: str = ""
    topology: str = ""
    num_slices: int = 1
    slice_id: int = 0
    checkpoint_dir: str = ""

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "LauncherConfig":
        e = env if env is not None else os.environ
        return cls(
            coordinator_address=e.get("JAX_COORDINATOR_ADDRESS", ""),
            num_processes=int(e.get("JAX_NUM_PROCESSES", "1") or 1),
            process_id=int(e.get("JAX_PROCESS_ID", "0") or 0),
            accelerator_type=e.get("TPU_ACCELERATOR_TYPE", ""),
            topology=e.get("TPU_TOPOLOGY", ""),
            num_slices=int(e.get("MEGASCALE_NUM_SLICES", "1") or 1),
            slice_id=int(e.get("MEGASCALE_SLICE_ID", "0") or 0),
            checkpoint_dir=e.get("CHECKPOINT_DIR", ""),
        )

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_chief(self) -> bool:
        """Chief is process 0."""
        return self.process_id == 0


def apply_platform_env(env: Optional[dict] = None) -> Optional[str]:
    """The device the pod env's ``K8S_TPU_PLATFORM`` names: ``cpu`` for
    ``cpu``, ``cuda`` for ``gpu`` or ``cuda``, None when it is unset or
    empty.  Any other value raises."""
    e = env if env is not None else os.environ
    platform = e.get("K8S_TPU_PLATFORM", "").strip().lower()
    if not platform:
        return None
    if platform == "cpu":
        return "cpu"
    if platform in ("gpu", "cuda"):
        return "cuda"
    raise ValueError(
        f"K8S_TPU_PLATFORM={platform!r}: the port runs on 'cpu' or "
        "'gpu'/'cuda'")


def default_device(flag: Optional[str] = None,
                   env: Optional[dict] = None) -> str:
    """An entry point's device: its ``--device`` flag if given, else the
    pod env's ``K8S_TPU_PLATFORM``, else ``cuda``."""
    return flag or apply_platform_env(env) or "cuda"


def process_device(env: Optional[dict] = None):
    """The device this process drives (set at bring-up; the pod env's
    choice before it)."""
    import torch

    from k8s_tpu_torch.ops._common import resolve_device

    return _device if _device is not None else resolve_device(
        torch.device(default_device(env=env)))


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _bind_device(device, process_id: int):
    """Resolve ``device`` (None: the pod env's, else cuda) and, on CUDA,
    pin this process to GPU ``process_id % device_count``."""
    global _device
    import torch

    from k8s_tpu_torch.ops._common import resolve_device

    dev = resolve_device(default_device(device))
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _device = dev
    return dev


def _join(dev, **kw) -> None:
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)


def initialize_distributed(config: Optional[LauncherConfig] = None, *,
                           device=None) -> LauncherConfig:
    """Idempotent ``torch.distributed`` bring-up from the operator env
    contract; a no-op (beyond fixing the device) for one process.
    ``device``: None takes ``K8S_TPU_PLATFORM``, else cuda."""
    import torch.distributed as dist

    global _device
    cfg = config or LauncherConfig.from_env()
    if dist.is_initialized():
        return cfg
    if not cfg.is_distributed:
        # each one-process bring-up fixes the device anew (an earlier
        # run in this process may have asked for another)
        _device = None
        if device is not None:
            _bind_device(device, cfg.process_id)
        else:
            apply_platform_env()  # a bad value fails here, at start-up
        log.info("single-process job; skipping torch.distributed")
        return cfg
    dev = _bind_device(device, cfg.process_id)
    if not cfg.coordinator_address:
        raise RuntimeError(
            "JAX_NUM_PROCESSES > 1 but JAX_COORDINATOR_ADDRESS is not set - "
            "was this pod created by the tpu-job operator?")
    log.info("torch.distributed.init_process_group(%s, tcp://%s, "
             "world_size=%d, rank=%d)", "nccl" if dev.type == "cuda"
             else "gloo", cfg.coordinator_address, cfg.num_processes,
             cfg.process_id)
    _join(dev, init_method=f"tcp://{cfg.coordinator_address}",
          rank=cfg.process_id, world_size=cfg.num_processes)
    return cfg


def _gather_ints(value: int) -> list[int]:
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], device=_device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [int(x.item()) for x in out]


def make_training_mesh(tp: int = 1, sp: int = 1, fsdp: Optional[int] = None,
                       config: Optional[LauncherConfig] = None, *,
                       pp: int = 1):
    """The global training mesh over every process of the job; returns
    ``(mesh, config)``.  Multi-slice (``MEGASCALE_NUM_SLICES > 1``): dp
    spans the slices through the hybrid layout (each process's
    ``MEGASCALE_SLICE_ID`` names its slice); every other axis stays inside
    a slice.  At one process a one-rank group is made first (NCCL on
    CUDA)."""
    import torch.distributed as dist

    cfg = config or LauncherConfig.from_env()
    if not dist.is_initialized():
        if cfg.is_distributed:
            initialize_distributed(cfg)
        else:
            dev = _device if _device is not None else _bind_device(
                None, cfg.process_id)
            _join(dev, store=dist.HashStore(), rank=0, world_size=1)
    device_type = process_device().type
    n = dist.get_world_size()
    if cfg.num_slices > 1:
        if n % cfg.num_slices != 0:
            raise ValueError(
                f"{n} devices not divisible by {cfg.num_slices} slices")
        ici = MeshConfig.auto(n // cfg.num_slices, tp=tp, sp=sp, fsdp=fsdp,
                              pp=pp)
        mesh = make_hybrid_mesh(ici, DcnConfig(dp=cfg.num_slices),
                                slice_index=_gather_ints(cfg.slice_id),
                                device_type=device_type)
    else:
        mesh = make_mesh(MeshConfig.auto(n, tp=tp, sp=sp, fsdp=fsdp, pp=pp),
                         device_type=device_type)
    log.info("mesh: %s over %d devices (%d slice(s))", mesh_shape(mesh), n,
             cfg.num_slices)
    return mesh, cfg


def host_group():
    """A gloo group over the world of its own, for host-side coordination
    beside training's collectives (``torch.distributed.checkpoint.
    async_save`` coordinates on it from its writer thread, so it must not
    share a communicator with the step's).  Made on the first call, which
    every rank must make."""
    global _host_group
    import torch.distributed as dist

    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


# The reference's hooks that PyTorch has no counterpart for: each is named
# in a warning when the pod env sets it, and left out of what
# setup_observability returns.
_NO_COUNTERPART = {
    "JAX_PROFILER_PORT": "torch has no profiler server to start",
    "XLA_DUMP_TO": "eager PyTorch compiles no XLA programs to dump "
                   "(XLA_FLAGS is left as it is)",
}
_profiler = None     # the torch.profiler session JAX_PROFILE_DIR started
_profile_dir = None


def setup_observability(env: Optional[dict] = None) -> dict:
    """The reference's profiler hooks from the operator-injected pod env
    (``k8s_tpu/launcher/bootstrap.py``), for torch:

      JAX_PROFILE_DIR    start a ``torch.profiler`` session now, tracing
                         the CPU and, on a CUDA process, the card;
                         ``stop_observability`` at job teardown writes the
                         whole run's trace into that directory under a
                         per-host, per-pid name (``tensorboard_trace_
                         handler``'s), so a gang's ranks never overwrite
                         each other
      JAX_PROFILER_PORT  no counterpart (a warning names it)
      XLA_DUMP_TO        no counterpart (a warning names it)

    The process's device is the one bring-up bound, else the env's
    ``K8S_TPU_PLATFORM`` (CUDA when unset; asking for CUDA without one
    raises).  Returns {hook: value} for what was enabled: ``{}`` or
    ``{"profile_dir": dir}``.  A second call with another directory warns
    and keeps the first session.
    """
    global _profiler, _profile_dir
    e = env if env is not None else os.environ
    for name, why in _NO_COUNTERPART.items():
        if e.get(name, ""):
            log.warning("%s=%s ignored: %s", name, e[name], why)
    enabled: dict = {}
    profile_dir = e.get("JAX_PROFILE_DIR", "")
    if profile_dir:
        if _profiler is None:
            _profiler = _start_profiler(profile_dir, process_device(e))
            _profile_dir = profile_dir
        elif _profile_dir != profile_dir:
            log.warning(
                "JAX_PROFILE_DIR=%s ignored: trace already writing to %s",
                profile_dir, _profile_dir)
        enabled["profile_dir"] = _profile_dir
    return enabled


def _start_profiler(profile_dir: str, device):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    log.info("profiling %s into %s", [a.name for a in activities],
             profile_dir)
    return prof


def stop_observability(env: Optional[dict] = None) -> None:
    """Stop the JAX_PROFILE_DIR session and write its trace (call at job
    teardown, chief included).  No-op when no session was started, and a
    failure to write the trace is logged, never raised: teardown must not
    mask the job's real exit status."""
    global _profiler, _profile_dir
    del env  # kept for call-site symmetry with setup_observability
    prof, trace_dir = _profiler, _profile_dir
    _profiler = _profile_dir = None
    if prof is None:
        return
    try:
        prof.stop()
    except Exception:  # noqa: BLE001 - teardown keeps the exit status
        log.exception("profiler trace into %s failed", trace_dir)


def barrier(name: str = "launcher") -> None:
    """Cross-process sync point (before checkpoint writes and teardown):
    an all-reduce of ones on this process's device, waited for."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        t = torch.ones(1, device=process_device())
        dist.all_reduce(t)
        if t.item() != dist.get_world_size():
            raise RuntimeError(f"barrier {name!r}: {t.item()} of "
                               f"{dist.get_world_size()} processes")
