"""One module for each kind of cell (``train``, ``serve``), each with
``run(ctx) -> record``; ``run.py`` picks the one a workload file names.
These are the only modules of the benchmark that import the port."""

from __future__ import annotations

import gc

import torch


def port_config(spec, **overrides):
    """The port's ``TransformerConfig`` for a model spec, in the type the
    file states (bf16 for the published models), with the
    hand-written kernels on (K1 the RMSNorm, K2-K4 flash attention)."""
    from k8s_tpu_torch.models.transformer import TransformerConfig

    kw = dict(vocab_size=spec.vocab, hidden=spec.hidden,
              ffn_hidden=spec.ffn, layers=spec.layers, heads=spec.heads,
              kv_heads=spec.kv_heads, head_dim=spec.head_dim,
              max_seq_len=spec.max_seq_len, rope_theta=spec.rope_theta,
              window_size=spec.window, dtype=spec.torch_dtype,
              use_flash_attention=True, use_fused_norm=True,
              num_experts=spec.experts, expert_top_k=spec.top_k or 2,
              expert_capacity_factor=spec.capacity_factor or 1.25)
    kw.update(overrides)
    cfg = TransformerConfig(**kw)
    if spec.eps != 1e-6:
        raise ValueError(f"the port's RMSNorm eps is 1e-6, the file states "
                         f"{spec.eps}")
    return cfg


def sync(dev) -> None:
    """Wait for the card's queued work (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    """The process's peak of allocated device memory so far."""
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def allocated_bytes(dev) -> int:
    return int(torch.cuda.memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def release(dev) -> None:
    """Collect what the run dropped and hand cached blocks back, before
    the reference runs."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
