#!/usr/bin/env python3
"""Causal-LM training on one GPU: the port of
``examples/train_lm/train_lm.py``.

    python -m k8s_tpu_torch.train_lm --train_steps 20     # on the card
    python -m k8s_tpu_torch.train_lm --device cpu --preset tiny

Same presets, flags, defaults, log lines and exit codes as the reference:
a Transformer (GPT-2-small by default) trained under the operator's env
contract (``launcher.bootstrap``) on a synthetic corpus staged through
``models.data``, by ``models.train.fit`` with checkpoint/resume and
cooperative SIGTERM (exit 143 = retryable; exit 1 on a non-finite loss).
On the card the flash-attention kernels (forward and backward) are on, as
the reference turns its Pallas kernels on for a TPU.  After training the
trained weights are exported as a serving artifact under ``--train_dir``
(``models.serving``) and, with ``--generate N``, greedily decode N tokens.

Flags whose machinery a later slice of the port brings exit non-zero with
a message saying so: ``--tp``, ``--sp`` and ``--pp`` above 1 (the
parallel slice) and ``--data_dir`` (the token-shard dataset).
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
                   "final eval) on a fixed synthetic eval corpus; 0 "
                   "disables")
    p.add_argument("--eval_fraction", type=float, default=0.05)
    p.add_argument("--eval_batches", type=int, default=8,
                   help="batches averaged per evaluation")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, greedily generate N tokens from a "
                   "held-out prompt with the trained weights")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions, "
                   "for tests)")
    return p.parse_args(argv)


def build_config(args, on_gpu: bool):
    import torch

    from k8s_tpu_torch.models.transformer import (
        TransformerConfig, bert_base, llama_8b, tiny_test,
    )

    if args.tp > 1 or args.sp > 1 or args.pp > 1:
        raise SystemExit(
            f"--tp {args.tp} --sp {args.sp} --pp {args.pp}: tensor, "
            "sequence and pipeline parallelism come with the parallel "
            "slice of the port; use --tp 1 --sp 1 --pp 1")
    if args.data_dir:
        raise SystemExit(
            "--data_dir: the token-shard dataset (TokenDataset, mmap "
            "shards) comes with a later slice of the port; leave it empty "
            "for the synthetic corpus")
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise SystemExit(
            f"--batch_size {args.batch_size} is not divisible into "
            f"--grad_accum {args.grad_accum} microbatches")
    if args.ring_layout == "zigzag":
        log.warning("--ring_layout zigzag needs --sp >= 2 to pair "
                    "early/late blocks; using contiguous")
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
        # the hand-written kernels run on the card, as the reference turns
        # its Pallas kernels on for a TPU
        use_flash_attention=on_gpu,
    )


def synthetic_corpus(vocab_size: int, tokens_total: int, seq_len: int,
                     seed: int):
    """Host-side synthetic token stream shaped like a packed corpus."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_seqs = max(tokens_total // seq_len, 1)
    return rng.integers(0, vocab_size, size=(n_seqs, seq_len), dtype=np.int32)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from k8s_tpu_torch.launcher import bootstrap

    cfg_launch = bootstrap.initialize_distributed()

    import torch

    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models import data as data_lib
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer
    from k8s_tpu_torch.ops._common import resolve_device

    device = resolve_device(args.device)
    cfg = build_config(args, device.type == "cuda")
    log.info("preset %s: layers=%d hidden=%d seq=%d flash=%s ring=%s",
             args.preset, cfg.layers, cfg.hidden, args.seq_len,
             cfg.use_flash_attention, cfg.use_ring_attention)

    tokens0 = synthetic_corpus(cfg.vocab_size, args.batch_size * args.seq_len,
                               args.seq_len, seed=0)
    model = Transformer(cfg, bridge.init_params(cfg, 0, device,
                                                dtype=torch.float32),
                        device=device, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    log.info("%.1fM params", n_params / 1e6)

    optimizer = train_lib.default_optimizer(
        args.learning_rate, weight_decay=args.weight_decay,
        clip_norm=args.clip_norm, schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps,
        # decay spans whatever budget this run has; a resumed run restores
        # the schedule's update count from the checkpoint
        decay_steps=max(1, args.train_steps - args.warmup_steps))

    corpus = synthetic_corpus(
        cfg.vocab_size, 64 * args.batch_size * args.seq_len, args.seq_len,
        seed=1)
    batches = ((b, b) for (b,) in data_lib.array_batches(
        (corpus,), args.batch_size, seed=0))
    if args.eval_every > 0:
        eval_corpus = synthetic_corpus(
            cfg.vocab_size, 8 * args.batch_size * args.seq_len,
            args.seq_len, seed=2)  # disjoint fixed eval draw

        def eval_iter_factory():
            return data_lib.prefetch_to_device(
                ((b, b) for (b,) in data_lib.array_batches(
                    (eval_corpus,), args.batch_size, seed=0)), device)
    data_iter = data_lib.prefetch_to_device(batches, device)

    state = train_lib.init_state(model, optimizer)
    fused = args.fused_ce == "on" or (args.fused_ce == "auto"
                                      and _FUSED_CE_AUTO)
    if fused:
        apply_fn = train_lib.make_fused_lm_apply_fn(model)
        loss_fn = train_lib.fused_loss_passthrough
        log.info("fused linear+cross-entropy head (logits never materialize)")
    else:
        def apply_fn(m, tokens):
            return m(tokens)

        loss_fn = train_lib.lm_loss
    eval_fn = None
    if args.eval_every > 0:
        eval_fn = train_lib.make_eval_fn(apply_fn, loss_fn, eval_iter_factory,
                                         batches=args.eval_batches)
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
        )
    finally:
        data_iter.close()

    def maybe_export_serving():
        # causal configs only (decode-mode attention is causal by
        # construction); best-effort: a failed export must not flip the
        # exit code of a finished training run
        if not (args.train_dir and cfg.causal and cfg_launch.is_chief):
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
        if not cfg.causal:
            log.warning("--generate skipped: KV-cached decode serves "
                        "causal configs")
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
