"""Autoregressive generation: prefill plus a KV-cached token loop.

Port of ``k8s_tpu/models/decode.py``: one-shot generation
(``make_generate_fn``, with chunked prefill, and ``generate``),
speculative decoding with prompt-lookup drafting
(``make_speculative_generate_fn``), beam search
(``make_beam_generate_fn``), and what the serving engine takes from
them: the prefill bucket set (``prefill_buckets_for``,
``split_prefill``), the row-wise sampler (``sample_logits_rows``) and the
batched speculative verify (``lookup_draft_host``, ``spec_verify_rows``).
The reference's ``lax.scan`` becomes a Python loop over eager decode
steps; the loop stays shape-static like the scan: rows that emit
``eos_id`` are frozen to ``pad_id`` for the remaining steps instead of
exiting early.  Its ``lax.while_loop`` (speculative decoding) becomes a
Python loop with one host read per verify call, which both decides the
loop condition and feeds the host-side drafting: the drafts are
``lookup_draft_host`` on each row's host context, token for token the
reference's device-side ``lookup_draft``.

Sampling: temperature 0 is the argmax; otherwise a Gumbel-max draw over
the temperature/top-k-processed logits with an explicit
``torch.Generator``.  ``jax.random`` (threefry) and torch's generators
give different numbers, so sampled tokens are the same under one seed
within the port, never across the two.  The draw schedule a seed fixes:

- every sampled token of ``make_generate_fn`` (the first included) is one
  ``torch.rand((B, V))`` (:func:`sample_logits`);
- a sampled speculative request draws its first token the same way, then
  per verify call ``torch.rand((B, K-1))`` (the acceptance uniforms) and
  ``torch.rand((B, V))`` (the Gumbel draw of the residual or bonus
  token), in that order (:func:`spec_accept_sampled`).  The engine's
  batched lane draws each row's with the row's own generator at ``B =
  1``, so a fixed-seed request emits the same tokens on either lane.

The residual is the processed logits with the rejected draft masked to
``-1e30``, so every emitted token is distributed exactly as vanilla
temperature/top-k sampling.
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
    return _gumbel_argmax(_process_logits(logits, temperature, top_k),
                          generator)


def _gumbel_argmax(x, generator: torch.Generator):
    """A categorical draw from ``softmax(x)`` along the last axis: one
    ``torch.rand(x.shape)`` from ``generator``, Gumbel-max."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (x + gumbel).argmax(dim=-1)


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


def _spec_draft_padded(draft, pad_id: int = 0):
    """Pad one column onto ``[B, K-1]`` drafts so acceptance-count
    gathers stay in bounds; the pad value is never selected (masked by
    the acceptance count everywhere it could surface)."""
    return torch.cat([draft, draft.new_full((draft.shape[0], 1), pad_id)],
                     dim=1)


def spec_accept_greedy(logits, draft):
    """Greedy speculative acceptance: ``logits`` ``[B, K, V]`` are the
    verify chunk's raw logits, ``draft`` ``[B, K-1]`` the proposals.
    draft[i] is accepted iff it equals the model's own argmax after
    consuming the (accepted) chunk prefix 0..i; the bonus token is the
    argmax at the first mismatch (or the chunk's last position when all
    drafts survive).  Returns ``(acc [B], bonus [B])``: output is
    argmax-exact with vanilla greedy by construction.

    The one definition shared by the exclusive lane
    (:func:`make_speculative_generate_fn`) and the engine's batched
    variable-width step (:func:`spec_verify_rows`)."""
    greedy = logits.argmax(dim=-1)
    match = (draft == greedy[:, :-1]).long()
    acc = match.cumprod(dim=1).sum(dim=1)  # [B] in 0..K-1
    bonus = greedy.gather(1, acc[:, None])[:, 0]
    return acc, bonus


def spec_accept_sampled(x, draft, generator: torch.Generator,
                        pad_id: int = 0):
    """Rejection sampling against the point-mass draft proposal
    (Leviathan et al.): ``x`` ``[B, K, V]`` are the verify chunk's
    temperature/top-k processed logits (the softmax of ``x`` is the
    sampling distribution), ``draft`` ``[B, K-1]`` the proposals.
    draft[i] is accepted w.p. ``p_i(draft[i])``; on the first rejection
    the emitted token is drawn from the renormalized residual (``x``
    with the draft masked to -1e30: the proposal's mass sits only at the
    draft, so the residual is renormalized ``p`` without it); when every
    draft survives, a bonus token is drawn from the unmasked final
    distribution.  Each emitted token is therefore distributed exactly
    as vanilla temperature/top-k sampling.  Returns ``(acc [B], bonus
    [B])``.

    Draws, in this order, from ``generator``: ``torch.rand((B, K-1))``
    (the acceptance uniforms), then ``torch.rand((B, V))`` (the Gumbel
    draw of the residual or bonus token)."""
    logp = torch.log_softmax(x, dim=-1)
    pd = logp[:, :-1].gather(2, draft[..., None])[..., 0].exp()  # [B, K-1]
    u = torch.rand(pd.shape, generator=generator, device=x.device)
    acc = (u < pd).long().cumprod(dim=1).sum(dim=1)
    x_acc = x.gather(1, acc[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]
    d_acc = _spec_draft_padded(draft, pad_id).gather(1, acc[:, None])[:, 0]
    rejected = acc < draft.shape[1]
    vocab = torch.arange(x.shape[-1], device=x.device)[None, :]
    x_res = x_acc.masked_fill(
        rejected[:, None] & (vocab == d_acc[:, None]), -1e30)
    return acc, _gumbel_argmax(x_res, generator)


def lookup_draft_host(ctx, draft_k: int) -> list[int]:
    """Host-side prompt-lookup drafting for the engine's batched
    speculative lane: propose ``draft_k - 1`` continuations of ``ctx``
    (the row's full context: prompt plus every emitted token) by copying
    what followed the most recent earlier occurrence of the trailing
    2-gram; fallback is repeating the last token.

    EXACTNESS CONTRACT: token-for-token what
    :func:`make_speculative_generate_fn`'s device-side ``lookup_draft``
    proposes for the same context — latest occurrence wins, matches are
    only sought strictly before the trailing 2-gram itself, and
    continuations past the written length fall back to the last token —
    so the batched lane verifies the same chunks the exclusive lane
    would and fixed-seed output stays identical.

    The backward scan is O(len(ctx)) per verify step on the engine's
    dispatch thread; contexts are bounded by max_seq_len, but an
    incremental per-slot 2-gram -> latest-index map (updated as tokens
    append) is the upgrade path if host drafting ever shows up in step
    latency — it must preserve the latest-occurrence/j < n-2 contract
    above bit-for-bit."""
    n = len(ctx)
    if n < 2:
        raise ValueError("prompt-lookup drafting needs context >= 2")
    a, last = ctx[-2], ctx[-1]
    j = -1
    for i in range(n - 3, -1, -1):  # j < n - 2, latest occurrence wins
        if ctx[i] == a and ctx[i + 1] == last:
            j = i
            break
    out = []
    for d in range(draft_k - 1):
        off = j + 2 + d
        out.append(int(ctx[off]) if j >= 0 and off < n else int(last))
    return out


def spec_verify_rows(logits, chunk, generators, temperature, top_k,
                     widths):
    """Row-wise accept/reject for the engine's batched variable-width
    decode step: each slot advances a per-slot number of tokens from one
    shared ``[B, W]``-chunk model call.

    ``logits`` is ``[B, W, V]`` (the verify chunk's logits); ``chunk``
    ``[B, W]`` is what each row fed (its last token, then its drafts;
    width-1 rows pad); ``generators``, ``temperature`` and ``top_k``
    (None or 0 = off) are per-row lists; ``widths`` the per-row host list
    — 1 for plain greedy/sampled rows, the row's ``draft_k`` for
    speculative rows (all speculative rows in one call share draft_k ==
    W; the engine groups by draft_k).  Returns ``(emit [B, W], n_emit
    [B])`` — row ``b`` emitted ``emit[b, :n_emit[b]]``.

    EXACTNESS CONTRACT:

    - width-1 rows compute exactly :func:`sample_logits_rows`'s per-row
      math on position 0 — the raw argmax for temperature-0 rows, one
      :func:`sample_logits` draw from the row's generator otherwise;
    - speculative rows follow the exclusive lane's per-verify schedule:
      :func:`_process_logits` over the row's whole chunk, then the shared
      :func:`spec_accept_sampled` (one ``torch.rand((1, W-1))`` and one
      ``torch.rand((1, V))`` from the row's generator) or
      :func:`spec_accept_greedy` (no draw) — for every row this emits
      token-for-token what :func:`make_speculative_generate_fn` emits
      for a batch-1 request with the same seed."""
    W = logits.shape[1]
    draft = chunk[:, 1:]
    acc, bonus = spec_accept_greedy(logits, draft)
    tok1 = logits[:, 0].argmax(dim=-1)
    for b, t in enumerate(temperature):
        if t <= 0:
            continue
        tk = top_k[b] or None
        if widths[b] > 1:
            a, bo = spec_accept_sampled(
                _process_logits(logits[b:b + 1], t, tk), draft[b:b + 1],
                generators[b])
            acc[b], bonus[b] = a[0], bo[0]
        else:
            tok1[b] = sample_logits(logits[b:b + 1, 0], generators[b], t,
                                    tk)[0]
    is_spec = torch.tensor(widths, device=logits.device) > 1
    ar = torch.arange(W, device=logits.device)[None, :]
    emit_spec = torch.where(ar < acc[:, None],
                            _spec_draft_padded(draft), bonus[:, None])
    emit_one = torch.where(ar == 0, tok1[:, None], 0)
    emit = torch.where(is_spec[:, None], emit_spec, emit_one)
    n_emit = torch.where(is_spec, acc + 1, 1)
    return emit, n_emit


def check_speculative_capacity(config: TransformerConfig, prompt_len: int,
                               max_new_tokens: int, draft_k: int) -> None:
    """The full-cache headroom bound for speculative decoding: the final
    verify writes draft positions up to prompt_len + max_new_tokens +
    draft_k - 3, which must stay within the cache — the one definition
    shared by the exclusive lane's guard and the engine's batched-lane
    admission check."""
    if config.window_size is None and \
            prompt_len + max_new_tokens - 2 + draft_k > config.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) + "
            f"draft_k ({draft_k}) headroom exceeds max_seq_len "
            f"({config.max_seq_len})")


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
                     eos_id: Optional[int] = None, pad_id: int = 0,
                     chunked_prefill: bool = False):
    """Build ``generate(model, prompt, generator) -> [B, max_new_tokens]``.

    One prefill call consumes the prompt and fills the cache, then
    ``max_new_tokens - 1`` single-token decode calls follow.  Rows that
    emit ``eos_id`` are frozen to ``pad_id`` from the next step on (EOS
    itself is emitted).

    ``chunked_prefill``: instead of one full-length prefill pass, stream
    the prompt through the cache in ``config.prefill_chunk``-token
    decode-mode chunks (a leading remainder chunk, then full ones),
    keeping only the last chunk's logits.  Prefill activation memory
    becomes O(chunk * cache), and with a sliding window the cache itself
    is O(window + chunk): rolling prefill for arbitrarily long prompts."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if chunked_prefill and config.prefill_chunk < 1:
        raise ValueError("chunked_prefill needs config.prefill_chunk >= 1")

    @torch.inference_mode()
    def generate(model: Transformer, prompt, generator=None):
        if model.config != config:
            raise ValueError("model was built for another config")
        B, Lp = prompt.shape
        _check_cache_capacity(config, Lp, max_new_tokens)
        cache = model.new_cache()
        if chunked_prefill:
            last = _chunked_prefill(model, prompt, cache)
        else:
            last = model(prompt, mode="prefill", cache=cache)[:, -1]
        tok = sample_logits(last, generator, temperature, top_k)
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


def _chunked_prefill(model: Transformer, prompt, cache):
    """Stream ``prompt`` through decode-mode cache calls of
    ``config.prefill_chunk`` tokens (a leading remainder chunk, or one
    chunk when the prompt divides); returns the last position's
    logits."""
    B, Lp = prompt.shape
    C = model.config.prefill_chunk
    first = Lp % C or min(C, Lp)  # <= C
    ar = torch.arange(C, device=prompt.device)
    last = model(prompt[:, :first], positions=ar[:first].expand(B, first),
                 mode="decode", cache=cache)[:, -1]
    for base in range(first, Lp, C):
        last = model(prompt[:, base:base + C],
                     positions=(base + ar[:C]).expand(B, C), mode="decode",
                     cache=cache)[:, -1]
    return last


def make_speculative_generate_fn(config: TransformerConfig,
                                 max_new_tokens: int, draft_k: int = 4,
                                 eos_id: Optional[int] = None,
                                 pad_id: int = 0,
                                 temperature: float = 0.0,
                                 top_k: Optional[int] = None,
                                 return_stats: bool = False):
    """Speculative decoding with prompt-lookup drafting:
    ``generate(model, prompt[, generator]) -> [B, max_new_tokens]`` (plus
    a per-call stats dict when ``return_stats``).

    Each iteration proposes ``draft_k - 1`` continuation tokens by copying
    what followed the most recent earlier occurrence of the current
    2-gram in the row's own context (prompt-lookup decoding, model-free
    drafting, strongest on repetitive/structured text), then verifies
    the whole proposal in one ``draft_k``-token cached decode call:
    position ``i``'s logits depend only on the (correct) chunk prefix.

    - ``temperature == 0`` (default): the longest draft prefix matching
      the model's own argmax is accepted, plus the model's bonus token.
      Output is argmax-exact with vanilla greedy by construction.
    - ``temperature > 0``: rejection sampling (Leviathan et al.,
      :func:`spec_accept_sampled`); each emitted token is distributed
      exactly as vanilla temperature/top-k sampling, only the number of
      model calls changes.  Pass ``generator``.

    Rejected-draft cache writes need no rollback: their slots carry
    positions the causal mask hides from every later query, and the next
    chunk (which starts at the first rejected position) overwrites them
    before attending.  Composes with GQA, the int8 KV cache, and
    sliding-window ring caches (requiring ``config.prefill_chunk >=
    draft_k`` so draft writes never evict still-attended ring slots).

    The loop reads each verify call's acceptance counts and bonus tokens
    back to the host once: that read decides the loop condition and
    feeds :func:`lookup_draft_host`, which drafts from each row's host
    context exactly as the reference's device-side lookup does."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if draft_k < 2:
        raise ValueError("draft_k must be >= 2 (k-1 drafts + 1 bonus)")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and temperature == 0.0:
        raise ValueError("top_k needs temperature > 0 (greedy ignores it)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if config.window_size is not None and config.prefill_chunk < draft_k:
        # a draft chunk writes up to draft_k slots ahead, evicting
        # position p - (window + prefill_chunk - 1) when it writes p;
        # with prefill_chunk >= draft_k that position is outside every
        # remaining query's window
        raise ValueError(
            f"speculative decoding over a sliding-window ring needs "
            f"config.prefill_chunk >= draft_k ({config.prefill_chunk} < "
            f"{draft_k}): the ring is sized window + prefill_chunk - 1")
    sampling = temperature > 0.0
    K = draft_k

    @torch.inference_mode()
    def generate(model: Transformer, prompt, generator=None):
        if model.config != config:
            raise ValueError("model was built for another config")
        B, Lp = prompt.shape
        if Lp < 2:
            raise ValueError("prompt-lookup drafting needs prompt_len >= 2")
        if sampling and generator is None:
            raise ValueError("temperature > 0 needs an rng "
                             "(a torch.Generator)")
        # full caches only: the final iteration writes draft positions up
        # to Lp + max_new_tokens + draft_k - 3; windowed rings wrap by
        # design and decode indefinitely
        check_speculative_capacity(config, Lp, max_new_tokens, draft_k)
        dev = prompt.device
        cache = model.new_cache()
        logits = model(prompt, mode="prefill", cache=cache)
        first = sample_logits(logits[:, -1], generator, temperature,
                              top_k).tolist()
        ctx = [row + [f] for row, f in zip(prompt.tolist(), first)]
        n = [1] * B
        last = list(first)
        done = [eos_id is not None and f == eos_id for f in first]
        ar = torch.arange(K, device=dev)
        iters = 0
        while any(not d and m < max_new_tokens for d, m in zip(done, n)):
            drafts = [lookup_draft_host(c, K) for c in ctx]
            chunk = torch.tensor([[t] + d for t, d in zip(last, drafts)],
                                 device=dev)
            base = torch.tensor([Lp + m - 1 for m in n], device=dev)
            logits = model(chunk, positions=base[:, None] + ar,
                           mode="decode", cache=cache)
            if sampling:
                acc, bonus = spec_accept_sampled(
                    _process_logits(logits, temperature, top_k),
                    chunk[:, 1:], generator, pad_id)
            else:
                acc, bonus = spec_accept_greedy(logits, chunk[:, 1:])
            # the one host read of the verify call
            acc, bonus = torch.stack([acc, bonus]).tolist()
            iters += 1
            for b in range(B):
                emit = drafts[b][:acc[b]] + [bonus[b]]
                n_new, done_next = len(emit), done[b]
                if eos_id is not None and eos_id in emit:
                    # truncate at the first emitted EOS (inclusive)
                    n_new, done_next = emit.index(eos_id) + 1, True
                n_new = min(n_new, max_new_tokens - n[b])
                if done[b] or n[b] >= max_new_tokens:
                    n_new = 0
                if n_new > 0:
                    ctx[b].extend(emit[:n_new])
                    last[b] = emit[n_new - 1]
                n[b] += n_new
                done[b] = done_next
        out = torch.full((B, max_new_tokens), pad_id, dtype=torch.long)
        for b in range(B):
            out[b, :n[b]] = torch.tensor(ctx[b][Lp:])
        out = out.to(dev)
        if return_stats:
            return out, {
                "model_calls": iters + 1,  # +1 for the prefill call
                # mean tokens landed per batched verify call per row
                # (1.0 = vanilla decode pace; up to draft_k when drafts hit)
                "tokens_per_call": (sum(n) - B) / (max(iters, 1) * B),
            }
        return out

    return generate


@functools.lru_cache(maxsize=32)
def cached_speculative_fn(config: TransformerConfig, max_new_tokens: int,
                          draft_k: int = 4, eos_id: Optional[int] = None,
                          pad_id: int = 0, temperature: float = 0.0,
                          top_k: Optional[int] = None):
    """Memoized :func:`make_speculative_generate_fn` (config is a frozen
    dataclass, so the whole generation config is hashable): a resident
    server's repeated settings reuse the built function."""
    return make_speculative_generate_fn(config, max_new_tokens,
                                        draft_k=draft_k, eos_id=eos_id,
                                        pad_id=pad_id,
                                        temperature=temperature,
                                        top_k=top_k)


def make_beam_generate_fn(config: TransformerConfig, max_new_tokens: int,
                          beam_size: int, eos_id: Optional[int] = None,
                          pad_id: int = 0, length_penalty: float = 0.0):
    """Beam search over the KV cache: ``beam(model, prompt) -> (tokens
    [B, max_new_tokens], scores [B])``.

    Prefill once per batch row, repeat every cache leaf to B*beam rows,
    then one decode call per step: expand ``[B, K, V]`` candidates, take
    the global top-K, and reorder every cache leaf (K/V, int8 scales,
    slot positions) by the parent-beam indices.  Beams that emit
    ``eos_id`` freeze: their only continuation is ``pad_id`` at log-prob
    0, so their score stops accumulating.

    ``length_penalty`` is GNMT-style alpha: final scores divide by
    ((5 + len) / 6) ** alpha where len counts tokens through EOS (0.0 =
    pure log-prob).  Returned scores are the penalized ones the winner
    was chosen by."""
    if beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    K, T = beam_size, max_new_tokens

    def penalize(scores, lengths):
        if length_penalty == 0.0:
            return scores
        return scores / (((5.0 + lengths) / 6.0) ** length_penalty)

    @torch.inference_mode()
    def beam(model: Transformer, prompt):
        if model.config != config:
            raise ValueError("model was built for another config")
        B, Lp = prompt.shape
        dev = prompt.device
        _check_cache_capacity(config, Lp, T)
        cache = model.new_cache()
        logits = model(prompt, mode="prefill", cache=cache)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        V = logp0.shape[-1]
        kk = min(K, V)
        scores, tok = torch.topk(logp0, kk, dim=-1)  # [B, kk]
        if kk < K:  # beam wider than vocab: pad with dead beams
            scores = torch.cat([scores, scores.new_full((B, K - kk), -1e30)],
                               dim=1)
            tok = torch.cat([tok, tok.new_zeros((B, K - kk))], dim=1)
        # beam row layout: flat index b*K + k
        for node in cache:
            for name, leaf in node.items():
                node[name] = leaf.repeat_interleave(K, dim=0)
        finished = (tok == eos_id) if eos_id is not None \
            else torch.zeros((B, K), dtype=torch.bool, device=dev)
        lengths = torch.ones((B, K), dtype=torch.long, device=dev)
        seqs = torch.full((B, K, T), pad_id, dtype=torch.long, device=dev)
        seqs[:, :, 0] = tok
        # a frozen beam may only continue with pad_id, at zero cost
        pad_only = torch.full((V,), -1e30, device=dev)
        pad_only[pad_id] = 0.0
        rows = torch.arange(B, device=dev)[:, None] * K
        for t in range(1, T):
            logits = model(tok.reshape(B * K, 1),
                           positions=torch.full((B * K, 1), Lp + t - 1,
                                                device=dev),
                           mode="decode", cache=cache)
            logp = torch.log_softmax(logits[:, -1].float(),
                                     dim=-1).reshape(B, K, V)
            logp = torch.where(finished[..., None], pad_only, logp)
            cand = (scores[..., None] + logp).reshape(B, K * V)
            scores, idx = torch.topk(cand, K, dim=-1)  # [B, K]
            parent, tok = idx // V, idx % V
            flat_parent = (rows + parent).reshape(-1)
            for node in cache:
                for name, leaf in node.items():
                    node[name] = leaf[flat_parent]
            finished = finished.gather(1, parent)
            lengths = lengths.gather(1, parent) + (~finished).long()
            seqs = seqs.gather(1, parent[..., None].expand(-1, -1, T))
            seqs[:, :, t] = tok
            if eos_id is not None:
                finished = finished | (tok == eos_id)
        final = penalize(scores, lengths.float())
        best = final.argmax(dim=1)  # [B]
        b = torch.arange(B, device=dev)
        return seqs[b, best], final[b, best]

    return beam


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
