"""In-pod payload of the multi-process rendezvous end-to-end run, on the
port: the twin of ``k8s_tpu/e2e/rendezvous_worker.py``.

    python -m k8s_tpu_torch.e2e.rendezvous_worker

It runs unchanged under the reference's gang harness,
``k8s_tpu.e2e.multiprocess.run_gang(n, module=
"k8s_tpu_torch.e2e.rendezvous_worker")``.  Every process:

1. reads the operator-injected env contract verbatim through
   ``launcher.bootstrap.LauncherConfig.from_env`` and joins
   ``torch.distributed`` at the coordinator (gloo under
   ``K8S_TPU_PLATFORM=cpu``, NCCL on a GPU);
2. cross-checks the legacy-shaped ``TPU_CONFIG`` JSON and
   ``TPU_WORKER_HOSTNAMES`` against its own identity;
3. runs a membership all-reduce in which process ``pid`` contributes
   ``pid + 1``: the sum is ``N(N+1)/2`` only if all N joined one world;
4. trains the repo Transformer through ``models.train.fit`` with the
   FSDP-sharded state and step over the mesh
   ``launcher.bootstrap.make_training_mesh`` builds (the hybrid dp-over-
   slices mesh when ``MEGASCALE_*`` is set), feeding each process's own
   rows (``default_rng(1234 + pid*1000 + i)``) straight in; with
   ``K8S_TPU_E2E_CKPT_EVERY`` it checkpoints to ``CHECKPOINT_DIR`` and a
   restarted gang resumes there;
5. prints one ``RDZV_OK {json}`` line with the reference's keys; the
   chief's is the gang's result.

Failure injection: ``K8S_TPU_E2E_FAIL=pid:rc:phase`` makes process
``pid`` exit ``rc`` at ``phase`` (``startup`` before the rendezvous,
``post_init`` after it, ``step_<i>`` when batch i is asked for, that is
after step i-1's checkpoint).  ``K8S_TPU_E2E_STEPS`` sets the step count
(1).  The tiny model runs no hand-written kernel, as the reference's runs
its plain attention; the launch counts go to the log for the record.
"""

from __future__ import annotations

import json
import logging
import os
import sys

log = logging.getLogger(__name__)

SEQ = 16


def _maybe_fail(phase: str, process_id: int) -> None:
    spec = os.environ.get("K8S_TPU_E2E_FAIL", "")
    if not spec:
        return
    pid_s, rc_s, fail_phase = spec.split(":")
    if int(pid_s) == process_id and fail_phase == phase:
        print(f"rendezvous_worker: injected failure at {phase} "
              f"rc={rc_s}", flush=True)
        # os._exit, so a signal-style death (137/143) is not turned into a
        # Python exception by any cleanup on the way out
        os._exit(int(rc_s))


def _check(ok: bool, what) -> None:
    """A contract check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"rendezvous_worker: {what}")


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    from k8s_tpu_torch.launcher import bootstrap

    cfg = bootstrap.LauncherConfig.from_env()
    _maybe_fail("startup", cfg.process_id)
    cfg = bootstrap.initialize_distributed(cfg)

    import numpy as np
    import torch
    import torch.distributed as dist

    # contract consistency: the legacy-shaped TPU_CONFIG must describe the
    # world the distributed env does
    tpu_config = json.loads(os.environ["TPU_CONFIG"])
    cluster_size = sum(len(v) for v in tpu_config["cluster"].values())
    _check(cluster_size >= cfg.num_processes, (tpu_config, cfg))
    task = tpu_config["task"]
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",")
    _check(len(hostnames) == len(tpu_config["cluster"][task["type"]]),
           (hostnames, tpu_config))

    _maybe_fail("post_init", cfg.process_id)

    mesh, cfg = bootstrap.make_training_mesh(config=cfg)
    _check(dist.get_world_size() == cfg.num_processes,
           (dist.get_world_size(), cfg.num_processes))
    _check(dist.get_rank() == cfg.process_id,
           (dist.get_rank(), cfg.process_id))
    device = bootstrap.process_device()

    # membership: N single-process worlds cannot fake this sum
    x = torch.full((1,), float(cfg.process_id + 1), device=device)
    dist.all_reduce(x)
    total = float(x.item())
    expect = float(sum(pid + 1 for pid in range(cfg.num_processes)))
    _check(total == expect, f"membership all_reduce {total} != {expect}")

    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer, TransformerConfig
    from k8s_tpu_torch.ops import _common
    from k8s_tpu_torch.parallel.mesh import mesh_shape

    tcfg = TransformerConfig(
        vocab_size=64, hidden=32, ffn_hidden=64, layers=1, heads=2,
        kv_heads=2, max_seq_len=SEQ, use_flash_attention=False,
        dtype=torch.float32)
    model = Transformer(tcfg, bridge.init_params(tcfg, 0, device,
                                                 dtype=torch.float32),
                        device=device, trainable=True)
    optimizer = train_lib.default_optimizer(1e-2)
    state = train_lib.init_state(model, optimizer)
    state, shardings = train_lib.shard_train_state(state, mesh)
    step = train_lib.make_sharded_train_step(
        lambda m, t: m(t), train_lib.lm_loss, optimizer, mesh, shardings)

    total_steps = int(os.environ.get("K8S_TPU_E2E_STEPS", "1"))
    ckpt_every = int(os.environ.get("K8S_TPU_E2E_CKPT_EVERY", "0"))
    process_id = cfg.process_id

    class _Batches:
        """This process's rows, deterministic per (process, step), with
        fit's skip() resume contract.  Serving batch i means i steps ran
        and step i-1's checkpoint committed: the boundary the preemption
        scenarios aim at."""

        def __init__(self):
            self.i = 0

        def skip(self, n: int) -> None:
            self.i += n

        def __iter__(self):
            return self

        def __next__(self):
            _maybe_fail(f"step_{self.i}", process_id)
            rng = np.random.default_rng(1234 + process_id * 1000 + self.i)
            local = torch.from_numpy(rng.integers(
                0, tcfg.vocab_size, (1, SEQ)).astype(np.int64)).to(device)
            self.i += 1
            return (local, local)

    _common.reset_launches()
    result = train_lib.fit(
        lambda m, t: m(t), train_lib.lm_loss, optimizer, state, _Batches(),
        steps=total_steps,
        checkpoint_dir=cfg.checkpoint_dir if ckpt_every else "",
        checkpoint_every=ckpt_every or 1, log_every=0, step_fn=step,
        state_shardings=shardings)
    _maybe_fail(f"step_{total_steps}", process_id)
    log.info("kernel launches %s", json.dumps(_common.launches()))

    loss = float(result.losses[-1]) if result.losses else None
    _check(loss is None or np.isfinite(loss), f"loss {loss}")
    step_no = int(result.state["step"])
    _check(step_no == total_steps, (step_no, total_steps))

    out = {
        "process_id": cfg.process_id,
        "num_processes": cfg.num_processes,
        "is_chief": cfg.is_chief,
        "global_devices": dist.get_world_size(),
        "mesh": mesh_shape(mesh),
        "num_slices": cfg.num_slices,
        "membership_sum": total,
        "loss": loss,
        "step": step_no,
        "start_step": result.start_step,
    }
    print("RDZV_OK " + json.dumps(out, sort_keys=True), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
