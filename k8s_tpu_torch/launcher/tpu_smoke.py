"""Distributed smoke workload, on the port: the twin of
``k8s_tpu/launcher/tpu_smoke.py`` (the operator's analogue of the
reference's tf_smoke.py).

Every process joins ``torch.distributed`` from the operator env and
builds the training mesh; each computes ``x @ x.T`` for its rows of a
1024x1024 bf16 matrix of ones (its block over the mesh's (dp, fsdp)
axes), sums it, and an all-reduce adds the blocks over the world.  The
checksum must be 1024**3 within 1%.  Exit code 0 on success, 1 on any
failure (the operator's chief exit-code contract).

Run inside a pod:  python -m k8s_tpu_torch.launcher.tpu_smoke
"""

from __future__ import annotations

import logging
import sys

log = logging.getLogger(__name__)


def run_smoke(size: int = 1024, iters: int = 3) -> float:
    import torch
    import torch.distributed as dist

    from k8s_tpu_torch.launcher.bootstrap import (
        initialize_distributed, make_training_mesh, process_device,
    )
    from k8s_tpu_torch.parallel.mesh import data_sharding

    cfg = initialize_distributed()
    mesh, _ = make_training_mesh(config=cfg)
    device = process_device()
    x = torch.ones((size, size), dtype=torch.bfloat16, device=device)
    rows = data_sharding(mesh).local(x)
    checksum = 0.0
    for i in range(iters):
        total = (rows @ x.T).float().sum()
        dist.all_reduce(total)  # every block of the product, summed
        checksum = float(total.item())
        log.info("iter %d checksum %.1f", i, checksum)

    expected = float(size) * size * size
    if abs(checksum - expected) / expected > 1e-2:
        raise RuntimeError(f"smoke checksum {checksum} != expected {expected}")
    if cfg.is_chief:
        log.info("smoke OK on %d devices", dist.get_world_size())
    dist.destroy_process_group()
    return checksum


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    try:
        run_smoke()
    except Exception:  # noqa: BLE001 - the exit code is the contract
        log.exception("smoke failed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
