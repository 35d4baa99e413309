"""Autoregressive generation: prefill plus a KV-cached token loop.

Port of the one-shot path of ``k8s_tpu/models/decode.py``
(``make_generate_fn`` without chunked prefill, ``generate``), plus what
the serving engine takes from it: the prefill bucket set
(``prefill_buckets_for``, ``split_prefill``) and the row-wise sampler
(``sample_logits_rows``).  The reference's ``lax.scan`` becomes a Python
loop over eager decode steps; the loop stays shape-static like the scan:
rows that emit ``eos_id`` are frozen to ``pad_id`` for the remaining
steps instead of exiting early.

Sampling: temperature 0 is the argmax; otherwise a Gumbel-max draw over
the temperature/top-k-processed logits with an explicit
``torch.Generator``.  ``jax.random`` (threefry) and torch's generators
give different numbers, so sampled tokens are the same under one seed
within the port, never across the two.

Not in this slice: speculative decoding, beam search and chunked
prefill in ``make_generate_fn``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from k8s_tpu_torch.models.transformer import Transformer, TransformerConfig
from k8s_tpu_torch.ops._common import resolve_device


def _process_logits(logits, temperature: float, top_k: Optional[int]):
    """Temperature/top-k-processed f32 logits: the softmax of this is the
    sampling distribution."""
    logits = logits.float() / temperature
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        # top_k >= vocab is a no-op filter, not an error
        kk = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, kk, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    return logits


def sample_logits(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: Optional[int] = None):
    """Next tokens from ``[B, V]`` logits: the argmax at temperature 0
    (``generator`` unused), else a Gumbel-max draw from the processed
    logits, optionally truncated to the top_k (a mask, shape-static)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    if generator is None:
        raise ValueError("temperature > 0 needs a torch.Generator")
    logits = _process_logits(logits, temperature, top_k)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1)


def sample_logits_rows(logits, generators, temperature, top_k):
    """Row-wise sampling for the engine's batched decode step: each row
    of ``[B, V]`` ``logits`` draws from its own distribution with its own
    generator.  ``generators``, ``temperature`` and ``top_k`` are
    per-row lists (temperature 0 = greedy; top_k None or 0 = off).
    Returns ``[B]`` tokens.

    Exactness contract: every row computes what the exclusive lane's
    :func:`make_generate_fn` computes for a batch-1 request.  A greedy
    row takes the raw argmax and draws nothing; a sampled row runs
    :func:`sample_logits` on its own ``[1, V]`` row, so it draws
    ``torch.rand((1, V))`` once from its generator per emitted token and
    its top-k threshold is the kth value, as in ``_process_logits``.  A
    fixed-seed sampled request therefore emits the same tokens on either
    lane."""
    out = logits.argmax(dim=-1)
    for b, t in enumerate(temperature):
        if t > 0:
            out[b] = sample_logits(logits[b:b + 1], generators[b], t,
                                   top_k[b] or None)[0]
    return out


def _check_cache_capacity(config: TransformerConfig, prompt_len: int,
                          max_new_tokens: int) -> None:
    """The full-cache bound: the LAST sampled token is returned, never fed
    back, so the highest position written is prompt_len + max_new_tokens
    - 2."""
    if config.window_size is None and \
            prompt_len + max_new_tokens - 1 > config.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_seq_len ({config.max_seq_len}) and no "
            "window_size is set (the full KV cache is max_seq_len "
            "long; sliding-window configs decode indefinitely)")


def prefill_buckets_for(config: TransformerConfig) -> tuple[int, ...]:
    """The default prefill chunk-size bucket set for a serving engine:
    powers of two up to ``max_seq_len`` (capped at ``prefill_chunk`` for
    sliding-window configs, whose ring cache only has window +
    prefill_chunk - 1 slots per chunk write).  Any prompt length
    decomposes into bucket-sized chunks (1 is always a bucket)."""
    cap = config.max_seq_len
    if config.window_size:
        cap = min(cap, max(1, config.prefill_chunk))
    out, b = [], 1
    while b <= cap:
        out.append(b)
        b *= 2
    return tuple(out)


def split_prefill(length: int, buckets: tuple[int, ...]) -> list[int]:
    """Greedy largest-first decomposition of a prompt length into
    bucket-sized chunks (e.g. 13 over {1,2,4,8} -> [8, 4, 1]).  Each
    chunk is one decode-mode cache call at exact absolute positions — no
    padding, so there is no left-pad RoPE corruption to work around."""
    if length < 1:
        raise ValueError(f"length must be >= 1, got {length}")
    bs = sorted(buckets, reverse=True)
    if not bs or bs[-1] != 1:
        raise ValueError(f"buckets must include 1, got {buckets}")
    out: list[int] = []
    rem = length
    for b in bs:
        while rem >= b:
            out.append(b)
            rem -= b
    return out


def make_generate_fn(config: TransformerConfig, max_new_tokens: int,
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     eos_id: Optional[int] = None, pad_id: int = 0):
    """Build ``generate(model, prompt, generator) -> [B, max_new_tokens]``.

    One prefill call consumes the prompt and fills the cache, then
    ``max_new_tokens - 1`` single-token decode calls follow.  Rows that
    emit ``eos_id`` are frozen to ``pad_id`` from the next step on (EOS
    itself is emitted)."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")

    @torch.inference_mode()
    def generate(model: Transformer, prompt, generator=None):
        if model.config != config:
            raise ValueError("model was built for another config")
        B, Lp = prompt.shape
        _check_cache_capacity(config, Lp, max_new_tokens)
        cache = model.new_cache()
        logits = model(prompt, mode="prefill", cache=cache)
        tok = sample_logits(logits[:, -1], generator, temperature, top_k)
        if max_new_tokens == 1:
            return tok[:, None]
        done = (tok == eos_id) if eos_id is not None \
            else torch.zeros(B, dtype=torch.bool, device=prompt.device)
        out = [tok]
        pos = torch.full((B, 1), Lp, dtype=torch.long, device=prompt.device)
        for _ in range(max_new_tokens - 1):
            logits = model(tok[:, None], positions=pos, mode="decode",
                           cache=cache)
            nxt = sample_logits(logits[:, -1], generator, temperature, top_k)
            nxt = torch.where(done, pad_id, nxt)
            if eos_id is not None:
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok, pos = nxt, pos + 1
        return torch.stack(out, dim=1)

    return generate


@functools.lru_cache(maxsize=8)
def _cached_generate_fn(config, max_new_tokens, temperature, top_k, eos_id,
                        pad_id):
    return make_generate_fn(config, max_new_tokens, temperature=temperature,
                            top_k=top_k, eos_id=eos_id, pad_id=pad_id)


def generate(config: TransformerConfig, params: dict, prompt,
             max_new_tokens: int, seed: int = 0, temperature: float = 0.0,
             top_k: Optional[int] = None, eos_id: Optional[int] = None,
             pad_id: int = 0, device="cuda"):
    """One-shot convenience wrapper around :func:`make_generate_fn`:
    builds the model from the state dict ``params`` on ``device`` (sharing
    tensors that are already there in the served dtype) and generates.
    ``seed`` seeds the sampling generator; like the reference's default
    key, a fixed seed makes sampled calls reproducible by design."""
    dev = resolve_device(device)
    model = Transformer(config, params, device=dev)
    fn = _cached_generate_fn(config, max_new_tokens, temperature, top_k,
                             eos_id, pad_id)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return fn(model, torch.as_tensor(prompt, dtype=torch.long).to(dev), gen)
