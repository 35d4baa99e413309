"""In-pod bootstrap: the operator-injected env contract.

Port of ``k8s_tpu/launcher/bootstrap.py``'s ``LauncherConfig`` and
``initialize_distributed``.  The operator is not rewritten, so the env
names stay those it injects (``k8s_tpu.controller_v2.tpu_config``):

    JAX_COORDINATOR_ADDRESS  host:port of process 0
    JAX_NUM_PROCESSES        world size
    JAX_PROCESS_ID           this pod's process id
    TPU_ACCELERATOR_TYPE / TPU_TOPOLOGY        slice topology
    MEGASCALE_NUM_SLICES / MEGASCALE_SLICE_ID  multi-slice
    CHECKPOINT_DIR           the resume directory

A single-process job needs no bring-up.  More than one process (or slice)
raises: ``torch.distributed`` over NCCL, the device mesh and the sharded
train step come with the parallel slice of the port.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger(__name__)


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


def initialize_distributed(config: Optional[LauncherConfig] = None
                           ) -> LauncherConfig:
    """The bring-up from the operator env contract: a no-op for a
    single-process job; multi-process and multi-slice jobs raise until the
    parallel slice brings torch.distributed."""
    cfg = config or LauncherConfig.from_env()
    if cfg.is_distributed or cfg.num_slices > 1:
        raise NotImplementedError(
            f"{cfg.num_processes} processes / {cfg.num_slices} slices: "
            "multi-process training (torch.distributed over NCCL) comes "
            "with the parallel slice of the port")
    log.info("single-process job; no distributed bring-up")
    return cfg
