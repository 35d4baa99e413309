"""Generate from a serving artifact: the inference half of the train ->
checkpoint -> serve loop.  Port of ``examples/train_lm/serve_lm.py``.

    python -m k8s_tpu_torch.serve_lm --train_dir DIR --text "once upon a "
    python -m k8s_tpu_torch.serve_lm --train_dir DIR --tokens 5,12,99 --beam 4

Loads ``<train_dir>/serving/`` (written by ``k8s_tpu_torch.train_lm`` on
successful completion: ``model_config.json`` + ``params.pt``), rebuilds
the model on ``--device`` (``cuda`` unless asked for ``cpu``), and
decodes with the KV-cached generator (models/decode.py) — greedy by
default, temperature/top-k sampling, beam search with ``--beam``,
chunked prefill with ``--chunked_prefill``, or prompt-lookup speculative
decoding with ``--speculative K``.  ``--text`` byte-tokenizes the prompt
(dataset.encode_bytes) and prints decoded text back; ``--tokens`` takes
raw comma-separated ids and prints ids.
"""

from __future__ import annotations

import argparse
import logging
import sys

log = logging.getLogger("serve_lm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--text", default="",
                   help="byte-tokenized prompt (vocab must cover bytes)")
    p.add_argument("--tokens", default="",
                   help="comma-separated raw token ids")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--beam", type=int, default=0,
                   help="beam width; >0 selects beam search (greedy "
                   "scoring, ignores --temperature)")
    p.add_argument("--eos", type=int, default=-1, help="eos token id")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunked_prefill", action="store_true",
                   help="stream the prompt through the cache in "
                   "config.prefill_chunk-token chunks")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative decoding with prompt-lookup "
                   "drafting: verify K-1 drafted tokens per model call. "
                   "Greedy output is identical to plain greedy; with "
                   "--temperature > 0 tokens are rejection-sampled to "
                   "the exact sampling distribution. Fewer model calls "
                   "on repetitive text either way")
    p.add_argument("--kv_cache", choices=["model", "int8"], default="model",
                   help="int8 stores the KV cache as per-vector-scaled "
                   "int8 — half the per-token cache reads, ~quantization-"
                   "noise output differences")
    p.add_argument("--param_dtype", choices=["model", "bfloat16"],
                   default="model",
                   help="bfloat16 casts f32 params for serving (halves "
                   "the dominant decode HBM term)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions, "
                   "for tests)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if bool(args.text) == bool(args.tokens):
        raise SystemExit("give exactly one of --text or --tokens")
    if args.beam > 0 and args.chunked_prefill:
        raise SystemExit("--chunked_prefill is not plumbed through beam "
                         "search yet; drop one of the two flags")
    if args.top_k < 0:
        raise SystemExit(f"--top_k must be >= 0, got {args.top_k}")
    if args.speculative > 0 and (args.beam > 0 or args.chunked_prefill):
        raise SystemExit(
            "--speculative does its own prefill and replaces beam "
            "scoring; drop --beam/--chunked_prefill (temperature/top_k "
            "compose via rejection sampling)")
    if args.speculative == 1:
        raise SystemExit("--speculative must be >= 2 (K-1 drafted tokens "
                         "+ 1 bonus per call); 0 disables")

    import numpy as np
    import torch

    from k8s_tpu_torch.models import decode as decode_lib
    from k8s_tpu_torch.models import serving
    from k8s_tpu_torch.models.dataset import decode_bytes, encode_bytes
    from k8s_tpu_torch.models.transformer import Transformer
    from k8s_tpu_torch.ops._common import resolve_device

    device = resolve_device(args.device)
    config, params = serving.load_for_serving(
        args.train_dir, kv_cache=args.kv_cache, param_dtype=args.param_dtype,
        device=device)
    log.info("loaded %s: %d layers, hidden %d, vocab %d",
             args.train_dir, config.layers, config.hidden,
             config.vocab_size)

    if args.text:
        ids = encode_bytes(args.text).astype(np.int64)
        if ids.max(initial=0) >= config.vocab_size:
            raise SystemExit(
                f"--text byte ids exceed model vocab {config.vocab_size}; "
                "use --tokens for non-byte-tokenized models")
    else:
        try:
            ids = np.asarray([int(t) for t in args.tokens.split(",")],
                             np.int64)
        except ValueError:
            raise SystemExit(f"bad --tokens {args.tokens!r}")
        if ids.min(initial=0) < 0 or ids.max(initial=0) >= config.vocab_size:
            raise SystemExit(f"token ids outside [0, {config.vocab_size})")
    model = Transformer(config, params, device=device)
    del params
    prompt = torch.as_tensor(ids, device=device)[None, :]
    gen = torch.Generator(device=device).manual_seed(args.seed)

    eos = args.eos if args.eos >= 0 else None
    if args.speculative > 0:
        if args.top_k > 0 and args.temperature == 0.0:
            log.warning("--top_k %d has no effect at --temperature 0 "
                        "(greedy argmax); pass --temperature > 0 to "
                        "sample", args.top_k)
        fn = decode_lib.make_speculative_generate_fn(
            config, args.max_new_tokens, draft_k=args.speculative,
            eos_id=eos, temperature=args.temperature,
            top_k=(args.top_k or None) if args.temperature > 0 else None,
            return_stats=True)
        out, stats = fn(model, prompt, gen)
        log.info("speculative: %.2f tokens/model-call over %d calls",
                 float(stats["tokens_per_call"]),
                 int(stats["model_calls"]))
    elif args.beam > 0:
        if args.top_k > 0:
            log.warning("--top_k %d has no effect with --beam (beam search "
                        "scores greedily)", args.top_k)
        fn = decode_lib.make_beam_generate_fn(
            config, args.max_new_tokens, beam_size=args.beam, eos_id=eos)
        out, scores = fn(model, prompt)
        log.info("beam score %.4f", float(scores[0]))
    else:
        if args.top_k > 0 and args.temperature == 0.0:
            log.warning("--top_k %d has no effect at --temperature 0 "
                        "(greedy argmax); pass --temperature > 0 to sample",
                        args.top_k)
        fn = decode_lib.make_generate_fn(
            config, args.max_new_tokens, temperature=args.temperature,
            top_k=args.top_k or None, eos_id=eos,
            chunked_prefill=args.chunked_prefill)
        out = fn(model, prompt, gen)
    toks = serving.strip_after_eos(out[0].cpu().numpy(), eos)
    if args.text:
        print(args.text + decode_bytes(np.asarray(toks)), flush=True)
    else:
        print(",".join(str(int(t)) for t in toks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
