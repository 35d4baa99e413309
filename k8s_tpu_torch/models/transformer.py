"""Transformer family: port of ``k8s_tpu/models/transformer.py``.

One decoder/encoder implementation (RMSNorm + SwiGLU + rotary embeddings,
tied embeddings) with the reference's three modes:

- ``"train"``: the full teacher-forced pass, differentiable;
- ``"prefill"``: the same pass plus writing the prompt's K/V into the cache;
- ``"decode"``: cached steps over a dense KV cache (a windowed ring buffer
  when ``window_size`` is set, optionally int8), or over the serving
  engine's paged block pool when the cache dicts carry ``table`` and
  ``len`` (``models/paged.py``).

Numerics follow the reference: projections run in ``config.dtype``; norm
scales keep their own dtype, so a bf16 activation times an f32 scale gives
f32, as ``result_type`` does; RoPE angles and softmax are f32; the tied
head multiplies ``config.dtype``-rounded operands with f32 accumulation and
returns f32 logits.  Two constructions hold the weights:

- served (the default): every projection is cast to ``config.dtype`` once,
  at load (the values every forward uses anyway), and all weights are
  frozen; the embedding is held in f32 with its values rounded through
  ``config.dtype``, so the gather and the head see exactly the reference's
  bf16 operands and the head's f32 product accumulates as
  ``preferred_element_type=float32`` does;
- trainable (``trainable=True``): f32 master weights as ``nn.Parameter``s,
  as the reference's ``param_dtype=float32``, cast inside each forward where
  the reference casts: the gather ``emb[tokens].astype(dtype)``, each
  projection, and the head's ``config.dtype``-rounded embedding.  With
  ``config.remat`` each block is recomputed in the backward
  (``torch.utils.checkpoint``), as the reference's ``nn.remat``.

The casts are no-ops on the served weights, so the served path's device
work is the same in both.

The KV cache is a list of per-layer dicts of tensors (``new_cache()``),
updated in place — PyTorch's idiom for state the reference threads through
flax's ``cache`` collection.

Not in this port yet (each raises ``NotImplementedError``): the sp ring
and ulysses (``parallel/``), MoE.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from k8s_tpu_torch.models import paged
from k8s_tpu_torch.models.paged import quantize_kv
from k8s_tpu_torch.ops._common import resolve_device
from k8s_tpu_torch.ops.flash_attention import flash_attention
from k8s_tpu_torch.ops.fused_norm import rms_norm, rms_norm_plain

MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field (so the same
    ``model_config.json`` loads), with ``dtype`` a torch dtype."""

    vocab_size: int = 32000
    hidden: int = 4096
    ffn_hidden: int = 11008
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    causal: bool = True
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    use_ring_attention: bool = False
    sp_strategy: str = "ring"
    ring_layout: str = "contiguous"
    use_flash_attention: bool = False  # hand-written Hopper kernel (ops/)
    # the reference's Pallas tile sizes; the CUDA kernel tiles itself and
    # reads neither (kept so the reference's config files load)
    flash_block_q: Optional[int] = None
    flash_block_k: Optional[int] = None
    use_fused_norm: bool = False  # Triton RMSNorm kernel (ops/)
    # sliding-window attention: each query attends the window most recent
    # positions (0 <= q - k < window, causal only); decode keeps an
    # O(window) ring-buffer cache
    window_size: Optional[int] = None
    # the largest multi-token chunk a decode-mode call must serve; windowed
    # rings hold window + prefill_chunk - 1 slots
    prefill_chunk: int = 1
    # KV-cache storage for decode: None stores dtype; "int8" stores
    # per-(slot, head) absmax-scaled int8
    kv_cache_dtype: Optional[str] = None
    remat: bool = True  # recompute each block in the backward
    num_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden // self.heads


def llama_8b() -> TransformerConfig:
    """Llama-3-8B-shaped."""
    return TransformerConfig(
        vocab_size=128256, hidden=4096, ffn_hidden=14336, layers=32,
        heads=32, kv_heads=8, max_seq_len=8192, rope_theta=500000.0,
    )


def bert_base() -> TransformerConfig:
    """BERT-base-shaped bidirectional encoder."""
    return TransformerConfig(
        vocab_size=30522, hidden=768, ffn_hidden=3072, layers=12,
        heads=12, kv_heads=12, max_seq_len=512, causal=False,
    )


def tiny_test() -> TransformerConfig:
    """CPU-testable config."""
    return TransformerConfig(
        vocab_size=256, hidden=64, ffn_hidden=128, layers=2, heads=4,
        kv_heads=4, max_seq_len=128, dtype=torch.float32, remat=False,
    )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, fused: bool = False):
        super().__init__()
        self.eps = eps
        self.fused = fused  # the Triton kernel instead of the plain chain
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        if self.fused:
            return rms_norm(x, self.scale, eps=self.eps)
        return rms_norm_plain(x, self.scale, eps=self.eps)


def rotary_embedding(x, positions, theta: float):
    """Apply RoPE (split-half, f32 angles) to ``[B, L, H, D]`` given
    ``[B, L]`` positions."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs  # [B, L, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _linear(x, layer: nn.Linear, dtype):
    """``layer`` applied in ``dtype``: its weight is cast per call, as the
    reference's ``Dense(dtype=...)`` casts its f32 kernel (a no-op for the
    served weights, which are ``dtype`` already)."""
    return F.linear(x, layer.weight.to(dtype))


def _plain_attention(q, k, v, causal: bool, window: int | None = None):
    """Attention with an f32 softmax over the full O(L^2) score matrix:
    the reference's XLA path.  ``window`` masks ``0 <= q_pos - k_pos <
    window``, the flash kernel's convention; it is causal-only and must be
    >= 1."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (matching "
                             "ops.flash_attention's contract)")
        if window < 1:
            raise ValueError("window must be >= 1")
    B, L, H, D = q.shape
    kv_heads = k.shape[2]
    if kv_heads != H:  # grouped-query: repeat kv heads
        rep = H // kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (D ** -0.5)
    if causal or window is not None:
        qpos = torch.arange(L, device=q.device)[:, None]
        kpos = torch.arange(L, device=q.device)[None, :]
        mask = torch.ones((L, L), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= qpos - kpos < window
        scores = scores.masked_fill(~mask, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        D = cfg.dims_per_head
        lin = lambda i, o: nn.Linear(i, o, bias=False)  # noqa: E731
        self.q_proj = lin(cfg.hidden, cfg.heads * D)
        self.k_proj = lin(cfg.hidden, cfg.kv_heads * D)
        self.v_proj = lin(cfg.hidden, cfg.kv_heads * D)
        self.o_proj = lin(cfg.heads * D, cfg.hidden)

    def _cache_vars(self, cache: dict, batch: int, device) -> int:
        """Allocate this layer's cache on first use; returns its length S.

        The cache is window-sized when sliding-window attention is set: a
        ring buffer (slot = position % S) of ``window + prefill_chunk - 1``
        slots, so a chunk's first query still finds its full window after
        the chunk's own writes.  Keys are stored post-rotary, and per-slot
        absolute positions (-1 = empty) make the mask exact."""
        cfg = self.config
        if cache:
            return cache["pos"].shape[1]
        if cfg.window_size:
            S = cfg.window_size + max(1, cfg.prefill_chunk) - 1
        else:
            S = cfg.max_seq_len
        shape = (batch, S, cfg.kv_heads, cfg.dims_per_head)
        if cfg.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', "
                             f"got {cfg.kv_cache_dtype!r}")
        if cfg.kv_cache_dtype == "int8":
            for name in ("k", "v"):
                cache[name] = torch.zeros(shape, dtype=torch.int8,
                                          device=device)
                # per-(slot, head) absmax scales, kept in f32
                cache[name + "_scale"] = torch.zeros(
                    shape[:3], dtype=torch.float32, device=device)
        else:
            for name in ("k", "v"):
                cache[name] = torch.zeros(shape, dtype=cfg.dtype,
                                          device=device)
        cache["pos"] = torch.full((batch, S), -1, dtype=torch.long,
                                  device=device)
        return S

    def _kv_cache_write(self, cache, name, b, slots, x):
        """Store ``[B, L, H, D]`` vectors at cache slots, quantizing when
        the cache is int8 (``quantize_kv``, the one shared definition)."""
        if self.config.kv_cache_dtype == "int8":
            q, scale = quantize_kv(x)
            cache[name][b, slots] = q
            cache[name + "_scale"][b, slots] = scale
        else:
            cache[name][b, slots] = x.to(self.config.dtype)

    def _kv_cache_read(self, cache, name):
        """The whole cache as ``config.dtype`` vectors: int8 is dequantized
        in f32 (int8 * f32 scale) and the product cast once."""
        if self.config.kv_cache_dtype == "int8":
            return (cache[name].float()
                    * cache[name + "_scale"][..., None]).to(self.config.dtype)
        return cache[name]

    def _paged_decode_step(self, q, k, v, positions, cache):
        """Decode over the serving engine's block-pool cache: new K/V are
        stored straight into pool blocks through the per-row block table
        (write-masked slots at position -1 are dropped, never clipped
        into a live block) and attention runs behind the
        ``paged_attention`` seam (models/paged.py).  The engine provides
        the cache dict: pool-shaped ``k``/``v`` (+ int8 scales) tensors,
        updated in place, plus ``table`` [B, blocks] and ``len`` [B]
        (each row's written length before this chunk, the validity
        bound)."""
        cfg = self.config
        if cfg.window_size:
            raise ValueError(
                "paged decode needs a full cache: a windowed ring wraps "
                "positions per row and does not decompose into "
                "absolute-position pool blocks")
        int8 = cfg.kv_cache_dtype == "int8"
        tables, lengths = cache["table"], cache["len"]
        for name, x in (("k", k), ("v", v)):
            paged.paged_kv_write(
                cache[name], tables, positions, x,
                scale_leaf=cache.get(name + "_scale"), quantize=int8)
        return paged.paged_attention(
            q, cache["k"], cache["v"], tables, lengths, positions,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            dtype=cfg.dtype)

    def _decode_step(self, q, k, v, positions, cache):
        """One cached decode call: write this chunk's K/V, then attend the
        whole cache.  The mask does all the work: slot validity (kpos >=
        0), causality (kpos <= qpos, which also hides the chunk's own later
        tokens) and the window (qpos - kpos < window).  A cache dict
        carrying a block ``table`` takes the paged path instead."""
        cfg = self.config
        if "table" in cache:
            return self._paged_decode_step(q, k, v, positions, cache)
        B, Lc = q.shape[0], q.shape[1]
        if cfg.window_size and Lc > max(1, cfg.prefill_chunk):
            raise ValueError(
                f"decode chunk of {Lc} tokens exceeds prefill_chunk "
                f"({cfg.prefill_chunk}): the windowed ring cache only has "
                "window + prefill_chunk - 1 slots, so a larger chunk "
                "would evict keys its own earliest query still needs")
        S = self._cache_vars(cache, B, q.device)
        b = torch.arange(B, device=q.device)[:, None]
        slot = positions % S  # [B, Lc]
        self._kv_cache_write(cache, "k", b, slot, k)
        self._kv_cache_write(cache, "v", b, slot, v)
        cache["pos"][b, slot] = positions
        keys = self._kv_cache_read(cache, "k")
        values = self._kv_cache_read(cache, "v")
        kpos = cache["pos"]
        # grouped-query via a grouped einsum: query head j attends kv head
        # j // rep without materializing a repeated copy of the cache
        rep = cfg.heads // cfg.kv_heads
        qg = q.reshape(B, Lc, cfg.kv_heads, rep, cfg.dims_per_head)
        scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, keys).float()
        scores = scores * (cfg.dims_per_head ** -0.5)
        mask = (kpos >= 0)[:, None, :] & \
            (kpos[:, None, :] <= positions[:, :, None])  # [B, Lc, S]
        if cfg.window_size:
            mask &= positions[:, :, None] - kpos[:, None, :] \
                < cfg.window_size
        scores = scores.masked_fill(~mask[:, None, None], MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(values.dtype),
                           values)
        return out.reshape(B, Lc, cfg.heads, cfg.dims_per_head)

    def _prefill_write(self, k, v, positions, cache):
        """Scatter the prompt's last min(L, S) K/V into the cache."""
        B, L = k.shape[:2]
        S = self._cache_vars(cache, B, k.device)
        keep = min(L, S)
        b = torch.arange(B, device=k.device)[:, None]
        last_pos = positions[:, L - keep:]
        slots = last_pos % S
        self._kv_cache_write(cache, "k", b, slots, k[:, L - keep:])
        self._kv_cache_write(cache, "v", b, slots, v[:, L - keep:])
        cache["pos"][b, slots] = last_pos

    def forward(self, x, positions, mode: str = "train", cache=None):
        cfg = self.config
        B, L = x.shape[:2]
        D = cfg.dims_per_head
        x = x.to(cfg.dtype)
        q = _linear(x, self.q_proj, cfg.dtype).view(B, L, cfg.heads, D)
        k = _linear(x, self.k_proj, cfg.dtype).view(B, L, cfg.kv_heads, D)
        v = _linear(x, self.v_proj, cfg.dtype).view(B, L, cfg.kv_heads, D)
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)

        if mode == "decode":
            out = self._decode_step(q, k, v, positions, cache)
        else:
            if mode == "prefill":
                # prompt attention is the ordinary causal (+window) pass
                # plus the K/V write for the token loop that follows
                self._prefill_write(k, v, positions, cache)
                causal = True
            else:
                causal = cfg.causal
            if cfg.use_flash_attention:
                out = flash_attention(q, k, v, causal=causal,
                                      window=cfg.window_size)
            else:
                out = _plain_attention(q, k, v, causal,
                                       window=cfg.window_size)
        return _linear(out.reshape(B, L, cfg.heads * D).to(cfg.dtype),
                       self.o_proj, cfg.dtype)


class MLP(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.gate_proj = nn.Linear(config.hidden, config.ffn_hidden,
                                   bias=False)
        self.up_proj = nn.Linear(config.hidden, config.ffn_hidden, bias=False)
        self.down_proj = nn.Linear(config.ffn_hidden, config.hidden,
                                   bias=False)

    def forward(self, x):
        dt = self.config.dtype
        x = x.to(dt)
        gate = _linear(x, self.gate_proj, dt)
        return _linear(F.silu(gate) * _linear(x, self.up_proj, dt),
                       self.down_proj, dt)


class Block(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        fused = config.use_fused_norm
        self.attn_norm = RMSNorm(config.hidden, fused=fused)
        self.attn = Attention(config)
        self.mlp_norm = RMSNorm(config.hidden, fused=fused)
        self.mlp = MLP(config)

    def forward(self, x, positions, mode: str = "train", cache=None):
        x = x + self.attn(self.attn_norm(x), positions, mode, cache)
        return x + self.mlp(self.mlp_norm(x))


def _served_tensor(config: TransformerConfig, name: str, t: torch.Tensor,
                   device) -> torch.Tensor:
    """A state-dict tensor in the dtype the forward uses: norm scales keep
    theirs, the embedding is f32 holding ``config.dtype``-rounded values,
    every projection is ``config.dtype``.  No copy when it already is."""
    t = torch.as_tensor(t)
    if name.endswith(".scale"):
        return t.to(device=device)
    if name == "embedding":
        return t.to(device=device, dtype=config.dtype).to(torch.float32)
    return t.to(device=device, dtype=config.dtype)


class Transformer(nn.Module):
    """Token-in, logits-out decoder (or encoder when ``causal=False``).

    ``params`` is a state dict in this module's layout
    (``models/bridge.py`` maps the reference's flax tree to it, or draws a
    random one).  Served (default): weights are placed on ``device`` in the
    dtype the forward uses, sharing the given tensors where they already
    match, and frozen.  ``trainable=True``: f32 copies as trainable
    parameters, cast inside each forward."""

    def __init__(self, config: TransformerConfig, params: dict, *,
                 device="cuda", trainable: bool = False):
        super().__init__()
        if config.num_experts > 0:
            raise NotImplementedError(
                "MoE (num_experts > 0) comes with a later slice of the port")
        self.config = config
        self.trainable = trainable
        with torch.device("meta"):
            self.embedding = nn.Parameter(
                torch.empty(config.vocab_size, config.hidden))
            self.layers = nn.ModuleList(
                Block(config) for _ in range(config.layers))
            self.final_norm = RMSNorm(config.hidden,
                                      fused=config.use_fused_norm)
        dev = resolve_device(device)
        if trainable:
            sd = {n: torch.as_tensor(t).to(device=dev, dtype=torch.float32,
                                          copy=True)
                  for n, t in params.items()}
        else:
            sd = {n: _served_tensor(config, n, t, dev)
                  for n, t in params.items()}
        self.load_state_dict(sd, assign=True)
        self.requires_grad_(trainable)

    def new_cache(self) -> list[dict]:
        """An empty KV cache (one dict per layer, filled at first write)."""
        return [{} for _ in self.layers]

    def forward(self, tokens, positions=None, mode: str = "train",
                cache: Optional[list] = None, return_hidden: bool = False):
        """``mode``: "train" (the full teacher-forced pass), "prefill" (the
        same pass plus K/V-cache population) or "decode" (cached steps;
        ``positions`` carries absolute positions).  Prefill and decode
        update ``cache`` (from :meth:`new_cache`) in place.  Returns f32
        logits ``[B, L, V]``, or with ``return_hidden`` the final normed
        hidden states ``[B, L, hidden]`` in ``config.dtype`` (the fused
        cross-entropy head's input)."""
        cfg = self.config
        B, L = tokens.shape
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "train":
            if not cfg.causal:
                raise ValueError("decode modes require causal=True")
            if cfg.use_ring_attention:
                raise ValueError(
                    "decode modes do not compose with the sp ring "
                    "(use_ring_attention); decode on the unsharded mesh")
            if cache is None:
                raise ValueError(f"mode {mode!r} needs cache=model.new_cache()")
        elif cfg.use_ring_attention:
            raise NotImplementedError(
                "sequence parallelism (ring / ulysses) comes with the "
                "parallel/ slice of the port")
        if positions is None:
            positions = torch.arange(L, device=tokens.device).expand(B, L)
        x = F.embedding(tokens, self.embedding).to(cfg.dtype)
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            if remat:
                # recompute the block in the backward: HBM for FLOPs
                x = torch.utils.checkpoint.checkpoint(
                    block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions, mode,
                          None if cache is None else cache[i])
        x = self.final_norm(x).to(cfg.dtype)
        if return_hidden:
            return x
        # tied head: config.dtype-rounded operands, f32 accumulation and
        # f32 logits (a bf16 product rounded to bf16 could flip an argmax);
        # the served embedding holds rounded values already
        emb = self.embedding
        if self.trainable:
            emb = emb.to(cfg.dtype).float()
        return torch.matmul(x.float(), emb.T)
