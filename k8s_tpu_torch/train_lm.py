#!/usr/bin/env python3
"""Causal-LM training on GPUs: the port of
``examples/train_lm/train_lm.py``.

    python -m k8s_tpu_torch.train_lm --train_steps 20     # on the card
    python -m k8s_tpu_torch.train_lm --device cpu --preset tiny

Same presets, flags, defaults, log lines and exit codes as the reference:
a Transformer (GPT-2-small by default) trained under the operator's env
contract (``launcher.bootstrap``) on a token-shard corpus (``--data_dir``,
``models.dataset.TokenDataset``: a stable ``--eval_fraction`` holdout for
``--eval_every``, and a resume that continues at the next unread window)
or a synthetic one, staged through ``models.data``, by ``models.train.fit`` with checkpoint/resume and
cooperative SIGTERM (exit 143 = retryable; exit 1 on a non-finite loss).
On the card the flash-attention kernels (forward and backward) are on, as
the reference turns its Pallas kernels on for a TPU.  After training the
trained weights are exported as a serving artifact under ``--train_dir``
(``models.serving``) and, with ``--generate N``, greedily decode N tokens.

The device is ``--device``, else the pod env's ``K8S_TPU_PLATFORM``, else
cuda.  A job of more processes or slices (the operator's env) trains
data-parallel: ``torch.distributed`` from the env, the mesh of
``launcher.bootstrap.make_training_mesh``, and ``fit(mesh=...)`` with the
FSDP-sharded state, each process staging its rows of the same seeded
global batches (``models.data.prefetch_to_mesh``) and checkpointing its
shards under ``<train_dir>/<step>/``.  The serving export and
``--generate`` stay with one process, as in the reference.  One process
keeps the unsharded step.

``--sp N`` (N processes or more) turns on sequence parallelism with the
reference's semantics: each rank trains its chunk of every sequence, and
attention runs over the sp ring: the flash ring on the card (contiguous,
or ``--ring_layout zigzag`` on an even ring), the plain ring on the CPU,
or ``--sp_strategy ulysses``.  ``--tp N`` splits the heads of that
attention over N ranks; the rest of the model is replicated over tp, as
the reference's fsdp-only parameter rule leaves it.

``--pp N`` (a multiple of N processes) trains pipeline-parallel with the
reference's 1F1B schedule (``--pp_virtual V > 1``: interleaved, V chunks a
rank) over ``--num_microbatches`` (default 2N): each rank builds its
stage of the same seeded weights (``models.pp_lm.LmStage``), the data
axes average the loss and gradients, ``--clip_norm`` clips by the norm
over every stage, and checkpoints hold each rank's blocks under their
global layer names.  It refuses what the reference refuses with it
(``--sp``, ``--tp``, ``--fused_ce on``, ``--grad_accum``,
``--eval_every``) and skips ``--generate``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import sys

log = logging.getLogger("train_lm")

PRESETS = ("tiny", "gpt2-small", "bert-base", "llama-8b")

# What --fused_ce auto resolves to (the reference's measured choice).
_FUSED_CE_AUTO = False


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=PRESETS, default="gpt2-small")
    p.add_argument("--train_steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8, help="global batch")
    p.add_argument("--seq_len", type=int, default=1024)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_schedule", choices=["constant", "cosine", "linear"],
                   default="constant")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup before the schedule")
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="global gradient-norm clip; 0 disables")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer update: activation "
                   "memory of batch_size/grad_accum with full-batch "
                   "update semantics (batch_size must divide evenly)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel size (>1 enables ring attention)")
    p.add_argument("--sp_strategy", choices=["ring", "ulysses"],
                   default="ring")
    p.add_argument("--ring_layout", choices=["contiguous", "zigzag"],
                   default="contiguous")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages")
    p.add_argument("--pp_virtual", type=int, default=1,
                   help="virtual chunks per pp stage")
    p.add_argument("--num_microbatches", type=int, default=0,
                   help="pp microbatches per step (0: auto = 2*pp)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each layer (HBM for FLOPs)")
    p.add_argument("--fused_ce", choices=["auto", "on", "off"],
                   default="auto",
                   help="fused linear+cross-entropy head: the [B, L, vocab] "
                   "logits never materialize (ops.fused_ce)")
    p.add_argument("--data_dir", default="",
                   help="token-shard directory; empty uses a synthetic "
                   "corpus")
    p.add_argument("--train_dir", default=os.environ.get("CHECKPOINT_DIR", ""),
                   help="checkpoint dir; empty disables checkpointing")
    p.add_argument("--checkpoint_every", type=int, default=100)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--metrics_path", default="",
                   help="append train/eval scalars as JSONL; defaults to "
                   "<train_dir>/metrics.jsonl when --train_dir is set")
    p.add_argument("--eval_every", type=int, default=0, metavar="N",
                   help="evaluate held-out loss every N steps (plus a "
                   "final eval); 0 disables. With --data_dir the holdout "
                   "is a stable --eval_fraction tail of the corpus "
                   "(excluded from training); without, a fixed synthetic "
                   "eval corpus")
    p.add_argument("--eval_fraction", type=float, default=0.05)
    p.add_argument("--eval_batches", type=int, default=8,
                   help="batches averaged per evaluation")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, greedily generate N tokens from a "
                   "held-out prompt with the trained weights")
    p.add_argument("--device", default=None,
                   help="cuda (the kernels) or cpu (their plain versions, "
                   "for tests); default: K8S_TPU_PLATFORM, else cuda")
    return p.parse_args(argv)


def _effective_ring_layout(args, on_gpu: bool) -> str:
    """zigzag only reaches the flash-ring path; warn when the flag would
    be inert (an A/B run measuring nothing is worse than a message)."""
    if args.ring_layout != "zigzag":
        return args.ring_layout
    if args.sp_strategy != "ring":
        log.warning("--ring_layout zigzag is ignored with --sp_strategy "
                    "ulysses (no ring to balance); using contiguous")
        return "contiguous"
    if args.sp < 2 or args.sp % 2:
        log.warning("--ring_layout zigzag needs an even --sp >= 2 to pair "
                    "early/late blocks (got --sp %d); using contiguous",
                    args.sp)
        return "contiguous"
    if not on_gpu:
        log.warning("--ring_layout zigzag needs the flash ring, which runs "
                    "on the card; this host runs plain ring attention "
                    "with contiguous layout")
        return "contiguous"
    return "zigzag"


def build_config(args, on_gpu: bool):
    import torch

    from k8s_tpu_torch.models.transformer import (
        TransformerConfig, bert_base, llama_8b, tiny_test,
    )

    if args.pp > 1 and args.sp > 1:
        raise SystemExit("--pp composes with flash attention, not the sp "
                         "ring (collectives can't nest inside the pp "
                         "shard_map); use --sp 1 with --pp")
    if args.pp > 1 and args.tp > 1:
        raise SystemExit("--tp does nothing under --pp yet (stage compute "
                         "is replicated over tp inside the pp shard_map, "
                         "wasting those devices); use --tp 1 with --pp")
    if args.pp > 1 and args.fused_ce == "on":
        raise SystemExit("--fused_ce on does not reach the pipeline step "
                         "(pp uses its own fused-loss step_fn); use "
                         "--fused_ce off with --pp")
    if args.pp > 1 and args.grad_accum > 1:
        raise SystemExit("--grad_accum does not reach the pipeline step "
                         "(pp already microbatches via "
                         "--num_microbatches); use --grad_accum 1 with "
                         "--pp")
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise SystemExit(
            f"--batch_size {args.batch_size} is not divisible into "
            f"--grad_accum {args.grad_accum} microbatches")
    if args.pp > 1 and args.eval_every > 0:
        raise SystemExit("--eval_every does not reach the pipeline step "
                         "(eval drives the plain apply_fn, which --pp "
                         "bypasses); use --eval_every 0 with --pp")
    if args.preset == "tiny":
        cfg = tiny_test()
    elif args.preset == "bert-base":
        cfg = bert_base()
    elif args.preset == "llama-8b":
        cfg = llama_8b()
    else:  # gpt2-small: the reference's benchmarked config (bench.py)
        cfg = TransformerConfig(
            vocab_size=32000, hidden=768, ffn_hidden=3072, layers=12,
            heads=12, kv_heads=12, max_seq_len=args.seq_len,
            dtype=torch.bfloat16)
    return dataclasses.replace(
        cfg,
        max_seq_len=max(cfg.max_seq_len, args.seq_len),
        remat=args.remat,
        use_ring_attention=args.sp > 1,
        sp_strategy=args.sp_strategy,
        ring_layout=_effective_ring_layout(args, on_gpu),
        # the hand-written kernels run on the card, as the reference turns
        # its Pallas kernels on for a TPU; with sp > 1 they run inside the
        # ring (parallel.ring_flash)
        use_flash_attention=on_gpu,
    )


def synthetic_corpus(vocab_size: int, tokens_total: int, seq_len: int,
                     seed: int):
    """Host-side synthetic token stream shaped like a packed corpus."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_seqs = max(tokens_total // seq_len, 1)
    return rng.integers(0, vocab_size, size=(n_seqs, seq_len), dtype=np.int32)


def pipeline_stage(args, cfg, params, mesh, device, optimizer):
    """This rank's ``LmStage`` of ``params`` and the pp train step, after
    the reference's checks; logs the schedule and its bubble."""
    from k8s_tpu_torch.models import pp_lm
    from k8s_tpu_torch.parallel.collectives import mesh_rings
    from k8s_tpu_torch.parallel.pipeline import bubble_fraction

    vp = args.pp_virtual
    if cfg.layers % (args.pp * vp):
        raise SystemExit(
            f"{cfg.layers} layers not divisible into {args.pp * vp} pp "
            f"chunks ({args.pp} stages x {vp} virtual)")
    micro = args.num_microbatches or 2 * args.pp
    if args.batch_size % micro:
        raise SystemExit(
            f"--batch_size {args.batch_size} not divisible into "
            f"{micro} microbatches (--num_microbatches)")
    if vp > 1 and micro % args.pp:
        raise SystemExit(
            f"interleaved schedule ingests microbatches in groups of "
            f"{args.pp} (=pp); --num_microbatches {micro} is not a "
            f"multiple")
    rank = mesh_rings(mesh).pp.rank
    stage = pp_lm.LmStage(cfg, params, rank=rank, num_stages=args.pp,
                          num_virtual=vp, device=device)
    step_fn = pp_lm.make_pp_train_step(
        cfg, optimizer, mesh, num_microbatches=micro, num_virtual=vp)
    schedule = "interleaved" if vp > 1 else "1f1b"
    log.info("pipeline: %d stages x %d virtual, %d microbatches, %s "
             "(bubble %.1f%%)", args.pp, vp, micro, schedule,
             100 * bubble_fraction(schedule, micro, args.pp, vp))
    return stage, step_fn


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from k8s_tpu_torch.launcher import bootstrap

    cfg_launch = bootstrap.initialize_distributed(device=args.device)
    sharded = (cfg_launch.is_distributed or cfg_launch.num_slices > 1
               or args.sp > 1 or args.tp > 1 or args.pp > 1)

    import torch

    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models import data as data_lib
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer

    device = bootstrap.process_device()
    cfg = build_config(args, device.type == "cuda")
    mesh = None
    model_ranks = args.sp * args.tp * args.pp
    if cfg_launch.num_processes % model_ranks:
        raise SystemExit(
            f"--sp {args.sp} --tp {args.tp} --pp {args.pp}: each sequence "
            f"chunk, head group and pipeline stage runs on its own "
            f"process, so the job needs a multiple of {model_ranks} "
            f"processes (got {cfg_launch.num_processes})")
    if sharded:
        mesh, _ = bootstrap.make_training_mesh(tp=args.tp, sp=args.sp,
                                               pp=args.pp, config=cfg_launch)
    log.info("preset %s: layers=%d hidden=%d seq=%d flash=%s ring=%s",
             args.preset, cfg.layers, cfg.hidden, args.seq_len,
             cfg.use_flash_attention, cfg.use_ring_attention)

    tokens0 = synthetic_corpus(cfg.vocab_size, args.batch_size * args.seq_len,
                               args.seq_len, seed=0)
    optimizer = train_lib.default_optimizer(
        args.learning_rate, weight_decay=args.weight_decay,
        clip_norm=args.clip_norm, schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        # decay spans whatever budget this run has; a resumed run restores
        # the schedule's update count from the checkpoint
        decay_steps=max(1, args.train_steps - args.warmup_steps))
    params = bridge.init_params(cfg, 0, device, dtype=torch.float32)
    n_params = sum(t.numel() for t in params.values())
    log.info("%.1fM params", n_params / 1e6)
    step_fn = None
    if args.pp > 1:
        model, step_fn = pipeline_stage(args, cfg, params, mesh, device,
                                        optimizer)
    else:
        model = Transformer(cfg, params, device=device, trainable=True)
    del params

    # eval under sp stages each rank's chunk and reduces over the mesh;
    # otherwise every rank scores the whole eval batch
    eval_mesh = mesh if args.sp > 1 else None

    def stage_eval(stream):
        if eval_mesh is not None:
            return data_lib.prefetch_to_mesh(stream, eval_mesh, device)
        return data_lib.prefetch_to_device(stream, device)

    if args.data_dir:
        from k8s_tpu_torch.models.dataset import TokenDataset

        ds = TokenDataset(args.data_dir)
        if not ds.vocab_size or ds.vocab_size > cfg.vocab_size:
            # a missing/zero vocab_size must not pass the guard: ids beyond
            # the model vocab would fail the embedding gather
            raise SystemExit(
                f"dataset vocab {ds.vocab_size or 'unknown'} missing or "
                f"exceeds model vocab {cfg.vocab_size}")
        log.info("token dataset: %d tokens, %d windows of %d",
                 ds.total_tokens, ds.num_sequences(args.seq_len),
                 args.seq_len)
        if args.eval_every > 0:
            # training excludes the stable eval tail; every evaluation
            # re-reads the same held-out windows
            batches = ds.batches(args.batch_size, args.seq_len, seed=0,
                                 split="train",
                                 eval_fraction=args.eval_fraction)

            def eval_stream():
                return ds.batches(args.batch_size, args.seq_len,
                                  shuffle=False, seed=0, split="eval",
                                  eval_fraction=args.eval_fraction)
            # probe now: an eval split smaller than the batch fails at
            # startup, not at the first eval mid-run (the stream's
            # constructor guard reads no data)
            try:
                eval_stream()
            except ValueError as e:
                raise SystemExit(
                    f"{e}\n  (raise --eval_fraction or lower "
                    "--batch_size so the holdout covers one batch)")

            def eval_iter_factory():
                return stage_eval(eval_stream())
        else:
            batches = ds.batches(args.batch_size, args.seq_len, seed=0)
    else:
        corpus = synthetic_corpus(
            cfg.vocab_size, 64 * args.batch_size * args.seq_len,
            args.seq_len, seed=1)
        batches = ((b, b) for (b,) in data_lib.array_batches(
            (corpus,), args.batch_size, seed=0))
        if args.eval_every > 0:
            eval_corpus = synthetic_corpus(
                cfg.vocab_size, 8 * args.batch_size * args.seq_len,
                args.seq_len, seed=2)  # disjoint fixed eval draw

            def eval_iter_factory():
                return stage_eval(
                    (b, b) for (b,) in data_lib.array_batches(
                        (eval_corpus,), args.batch_size, seed=0))
    data_iter = data_lib.prefetch_to_mesh(batches, mesh, device) if sharded \
        else data_lib.prefetch_to_device(batches, device)

    state = train_lib.init_state(model, optimizer)
    # pp runs its own step (apply_fn unused): auto demotes the fused head
    fused = args.pp == 1 and (args.fused_ce == "on" or (
        args.fused_ce == "auto" and _FUSED_CE_AUTO))
    if fused:
        apply_fn = train_lib.make_fused_lm_apply_fn(model, mesh=mesh)
        loss_fn = train_lib.fused_loss_passthrough
        log.info("fused linear+cross-entropy head (logits never materialize)")
    else:
        def apply_fn(m, tokens):
            return m(tokens, mesh=mesh)

        loss_fn = train_lib.make_lm_loss(mesh)
    eval_fn = None
    if args.eval_every > 0:
        eval_fn = train_lib.make_eval_fn(apply_fn, loss_fn, eval_iter_factory,
                                         batches=args.eval_batches,
                                         mesh=eval_mesh)
    try:
        result = train_lib.fit(
            apply_fn, loss_fn, optimizer, state, data_iter,
            steps=args.train_steps,
            checkpoint_dir=args.train_dir,
            checkpoint_every=args.checkpoint_every,
            log_every=args.log_every,
            eval_fn=eval_fn,
            eval_every=args.eval_every,
            grad_accum=args.grad_accum,
            metrics_path=args.metrics_path or (
                os.path.join(args.train_dir, "metrics.jsonl")
                if args.train_dir else ""),
            mesh=mesh,
            step_fn=step_fn,
        )
    finally:
        data_iter.close()

    def maybe_export_serving():
        # chief-only and single-process (the sharded weights live on every
        # process), causal configs only (decode-mode attention is causal
        # by construction); best-effort: a failed export must not flip the
        # exit code of a finished training run
        if not (args.train_dir and cfg.causal and not sharded
                and cfg_launch.is_chief):
            return
        try:
            from k8s_tpu_torch.models import serving

            d = serving.export_serving(args.train_dir, cfg,
                                       result.state["model"].state_dict())
            log.info("serving artifact exported to %s", d)
        except Exception:  # noqa: BLE001 - never fail a finished job
            log.exception("serving export failed (training itself "
                          "succeeded; exit code unaffected)")

    if result.preempted:
        # retryable contract: the operator's exit-code policy gang-restarts
        # and the next run resumes from the checkpoint
        log.warning("preempted at step %d; exiting 143",
                    result.start_step + len(result.losses))
        return 143
    if not result.losses:
        # a restart landing after the run already finished: success
        log.info("already complete at step %d (>= %d); nothing to do",
                 result.start_step, args.train_steps)
        maybe_export_serving()
        return 0
    final = float(result.losses[-1])
    if not math.isfinite(final):
        log.error("non-finite final loss %s", final)
        return 1
    log.info("training complete: %d steps, final loss %.4f",
             args.train_steps, final)
    maybe_export_serving()
    if args.generate > 0:
        if args.sp > 1 or args.pp > 1 or not cfg.causal or sharded:
            # decode cannot serve the sp ring, bidirectional presets or a
            # gang's sharded weights; a finished run's exit code stays 0
            log.warning("--generate skipped: KV-cached decode serves "
                        "causal single-process configs (no sp/pp)")
        else:
            from k8s_tpu_torch.models import decode as decode_lib

            prompt_len = max(1, min(64, args.seq_len // 2))
            gen_cfg = dataclasses.replace(
                cfg, remat=False,
                max_seq_len=max(cfg.max_seq_len, prompt_len + args.generate))
            toks = decode_lib.generate(
                gen_cfg, result.state["model"].state_dict(),
                tokens0[:2, :prompt_len], args.generate, device=device)
            for b, row in enumerate(toks.tolist()):
                log.info("generated[%d] (greedy, %d tokens): %s",
                         b, args.generate, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
