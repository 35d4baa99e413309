#!/usr/bin/env python3
"""MNIST training on GPUs: the port of
``examples/dist_mnist/dist_mnist.py`` (the operator's e2e workload).

    python -m k8s_tpu_torch.dist_mnist --train_steps 200      # on the card
    python -m k8s_tpu_torch.dist_mnist --device cpu \\
        --data_dir tests/fixtures/mnist --eval_holdout 256 --train_dir D

The reference's flags, defaults and log lines (``step N loss X``,
``held out N examples for evaluation``, ``held-out accuracy A over N
examples``, ``training complete at step N``), plus ``--device`` (the pod
env's ``K8S_TPU_PLATFORM`` by default, else ``cuda``; ``cpu`` for
tests).  The model is ``models.mnist.MnistCNN``,
trained by ``models.train``'s step (Adam, ``cross_entropy_loss``) on
batches from ``models.data.array_batches`` staged through
``prefetch_to_device``: the IDX files under ``--data_dir``
(``models.mnist_data``), or the reference's synthetic draw
(``np.random.default_rng(0)``, so both packages train on the same
batches).

Checkpoints: ``<train_dir>/mnist_state.pt`` holds the model, the
optimizer and the step, written atomically (a temporary file, then
``os.replace``) every ``--checkpoint_every`` steps and at the end; a
second run resumes from it.  As in the reference, a resumed run draws
its batches from a stream reseeded with the resume step
(``array_batches(..., seed=start_step)``), so a resumed run trains on
the batches a resumed reference run trains on.

A job of more processes or slices (the operator's env) trains
data-parallel: ``torch.distributed`` from the env, the FSDP-sharded state
and step over ``make_training_mesh``'s mesh, each process staging its
rows of the same global batches.  Before each save every process enters
a barrier and the gather of the full state (a collective); process 0
alone writes ``mnist_state.pt``, in the one-process format, which a job
of any size resumes from.  ``--eval_holdout`` is skipped with a warning
there, as in the reference.  A non-finite final loss exits 1.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
from typing import Optional

log = logging.getLogger("dist_mnist")

CKPT_NAME = "mnist_state.pt"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=64,
                   help="global batch size")
    p.add_argument("--data_dir", default="",
                   help="MNIST-layout directory (gzipped IDX files); empty "
                   "uses synthetic data")
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--eval_holdout", type=int, default=0, metavar="N",
                   help="reserve the LAST N examples as a held-out eval "
                   "split (excluded from training); final held-out "
                   "accuracy is logged")
    p.add_argument("--train_dir", default=os.environ.get("CHECKPOINT_DIR", ""),
                   help="checkpoint dir; empty disables checkpointing")
    p.add_argument("--checkpoint_every", type=int, default=50)
    p.add_argument("--sync_replicas", action="store_true", default=True,
                   help="kept for flag compatibility; training is always "
                   "synchronous")
    p.add_argument("--device", default=None,
                   help="cuda, or cpu (for tests); default: "
                   "K8S_TPU_PLATFORM, else cuda")
    return p.parse_args(argv)


def _full_payload(state: dict, step: int) -> Optional[dict]:
    """The one-process checkpoint payload of a sharded state: the full
    model and optimizer state dicts gathered to process 0 (a collective
    every process enters; the others get None), the optimizer's keyed by
    parameter index as ``torch.optim`` keys them."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict, get_optimizer_state_dict,
    )

    model, opt = state["model"], state["optimizer"]
    options = StateDictOptions(full_state_dict=True, cpu_offload=True)
    full_model = get_model_state_dict(model, options=options)
    full_opt = get_optimizer_state_dict(model, opt, options=options)
    if dist.get_rank() != 0:
        return None
    index = {n: i for i, (n, _) in enumerate(model.named_parameters())}
    full_opt = {
        "state": {index[n]: v for n, v in full_opt["state"].items()},
        "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                         for g in full_opt["param_groups"]]}
    return {"model": full_model, "optimizer": full_opt, "step": step}


def save_checkpoint(train_dir: str, state: dict, step: int,
                    sharded: bool = False) -> None:
    """Write ``mnist_state.pt``.  ``sharded``: every process calls this
    (the gather is a collective) and process 0 writes."""
    import torch

    if sharded:
        payload = _full_payload(state, step)
        if payload is None:
            return
    else:
        payload = {"model": state["model"].state_dict(),
                   "optimizer": state["optimizer"].state_dict(),
                   "step": step}
    os.makedirs(train_dir, exist_ok=True)
    tmp = os.path.join(train_dir, CKPT_NAME + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(train_dir, CKPT_NAME))
    log.info("saved checkpoint at step %d", step)


def restore_checkpoint(train_dir: str, state: dict, device) -> int:
    """Load ``mnist_state.pt`` into ``state`` in place; returns the step
    to start from (0 without a checkpoint)."""
    import torch

    path = os.path.join(train_dir, CKPT_NAME)
    if not train_dir or not os.path.exists(path):
        return 0
    saved = torch.load(path, map_location=device, weights_only=True)
    state["model"].load_state_dict(saved["model"])
    state["optimizer"].load_state_dict(saved["optimizer"])
    state["step"] = int(saved["step"])
    log.info("restored checkpoint at step %d", state["step"])
    return state["step"]


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from k8s_tpu_torch.launcher import bootstrap

    launch = bootstrap.initialize_distributed(device=args.device)
    sharded = launch.is_distributed or launch.num_slices > 1

    import numpy as np
    import torch

    from k8s_tpu_torch.models import data as data_lib
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.mnist import MnistCNN

    device = bootstrap.process_device()
    model = MnistCNN(device=device, seed=0)
    optimizer = train_lib.default_optimizer(args.learning_rate)
    state = train_lib.init_state(model, optimizer)
    start_step = restore_checkpoint(args.train_dir, state, device)
    apply_fn = lambda m, x: m(x)  # noqa: E731
    if sharded:
        mesh, _ = bootstrap.make_training_mesh(config=launch)
        state, shardings = train_lib.shard_train_state(state, mesh)
        model = state["model"]
        step_fn = train_lib.make_sharded_train_step(
            apply_fn, train_lib.cross_entropy_loss, optimizer, mesh,
            shardings)
    else:
        step_fn = train_lib.make_train_step(
            apply_fn, train_lib.cross_entropy_loss, optimizer)

    if args.data_dir:
        from k8s_tpu_torch.models.mnist_data import load_dataset

        ds_x, ds_y = load_dataset(args.data_dir)
        log.info("loaded %d real images from %s", len(ds_x), args.data_dir)
    else:
        rng = np.random.default_rng(0)
        ds_x = rng.normal(size=(64 * args.batch_size, 28, 28, 1)).astype(
            np.float32)
        ds_y = rng.integers(0, 10, size=(64 * args.batch_size,)).astype(
            np.int32)
    eval_x = eval_y = None
    if args.eval_holdout > 0 and sharded:
        log.warning("--eval_holdout skipped: multi-process runs hold "
                    "sharded params this single-process eval does not "
                    "gather")
    elif args.eval_holdout > 0:
        if args.eval_holdout > len(ds_x) - args.batch_size:
            raise SystemExit(
                f"--eval_holdout {args.eval_holdout} leaves fewer than "
                f"one training batch of {len(ds_x)} examples")
        eval_x, eval_y = ds_x[-args.eval_holdout:], ds_y[-args.eval_holdout:]
        ds_x, ds_y = ds_x[:-args.eval_holdout], ds_y[:-args.eval_holdout]
        log.info("held out %d examples for evaluation", len(eval_x))
        if start_step > 0:
            # the holdout is positional (the last N): an earlier run with
            # another --eval_holdout may have trained on these examples
            log.warning(
                "resuming at step %d: held-out accuracy is only a clean "
                "eval if every prior run used the same --eval_holdout",
                start_step)
    batches = data_lib.array_batches((ds_x, ds_y), args.batch_size,
                                     seed=start_step)
    data_iter = data_lib.prefetch_to_mesh(batches, mesh, device) if sharded \
        else data_lib.prefetch_to_device(batches, device)

    loss = None
    try:
        for step in range(start_step, args.train_steps):
            state, loss = step_fn(state, next(data_iter))
            if step % 10 == 0 or step == args.train_steps - 1:
                log.info("step %d loss %.4f", step, float(loss))
            if args.train_dir and (step + 1) % args.checkpoint_every == 0:
                # every process enters the barrier and the gather
                bootstrap.barrier("pre-checkpoint")
                save_checkpoint(args.train_dir, state, step + 1, sharded)
    finally:
        data_iter.close()
    if args.train_dir:
        bootstrap.barrier("final-checkpoint")
        save_checkpoint(args.train_dir, state, args.train_steps, sharded)
    if loss is not None and not math.isfinite(float(loss)):
        log.error("non-finite loss %s", float(loss))
        return 1
    if eval_x is not None:
        with torch.no_grad():
            logits = model(torch.from_numpy(eval_x).to(device))
        acc = float((logits.argmax(-1).cpu() == torch.from_numpy(eval_y))
                    .float().mean())
        log.info("held-out accuracy %.4f over %d examples",
                 acc, len(eval_x))
    log.info("training complete at step %d", args.train_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
