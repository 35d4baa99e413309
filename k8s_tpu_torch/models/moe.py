"""Mixture-of-Experts FFN: port of ``k8s_tpu/models/moe.py``.

GShard-style, step for step as the reference:

- router: a dense ``[d -> E]`` product in f32, softmax, top-k gating
  with the chosen gates renormalized (``max(sum, 1e-9)``); ties between
  equal probabilities go to the lowest expert index, as
  ``jax.lax.top_k`` breaks them;
- capacity-bounded dispatch: each expert takes at most ``C = max(1,
  ceil(k*T/E * capacity_factor))`` (token, choice) pairs of a call; a
  pair's slot in its expert's buffer is its position in priority order
  (every token's first choice before any second choice), and pairs past
  ``C`` are dropped (the residual connection carries them);
- dispatch and combine are einsums against a ``[T, E, C]`` one-hot
  tensor; the experts (SwiGLU MLPs, stacked ``[E, ...]``) run in
  ``dtype`` as batched products, the combine in f32, and the output
  takes the input's dtype;
- the Switch auxiliary load-balance loss ``E * sum_e f_e * p_e`` over
  the primary choice is returned to the caller with the output (the
  reference sows it into a "losses" collection; here
  ``Transformer.forward(aux_losses=[...])`` gathers one per layer and
  ``train.make_moe_apply_fn`` adds them).

Capacity is per call: every row of a batched call competes for it, so
batched rows are not independent (models/engine.py).  The reference's
einsums are plain XLA, not Pallas kernels, and so are these.

Not in this port yet: expert parallelism (the reference's ``mesh`` and
:func:`expert_sharding_rule`), which comes with the parallel slice
(ROADMAP.md Queue 1 item 8b) and is refused by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_PARALLEL = ("comes with the parallel slice of the port "
             "(ROADMAP.md Queue 1 item 8b)")


def top_k_lowest_index(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by ascending index (a stable
    descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(tokens: torch.Tensor, router: torch.Tensor, top_k: int,
          capacity_factor: float):
    """The routing of ``[T, d]`` tokens: returns ``(probs [T, E],
    gate_vals [T, k], gate_idx [T, k], slot [T, k], keep [T, k], C)``."""
    T, E = tokens.shape[0], router.shape[-1]
    k = min(top_k, E)
    logits = tokens.float() @ router.float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lowest_index(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # GShard scales capacity by k: k*T (token, choice) pairs share E*C
    # slots
    C = max(1, math.ceil(k * T / E * capacity_factor))
    onehot = F.one_hot(gate_idx, E)  # [T, k, E]
    # each pair's position in its expert's buffer, primary choices first
    flat = onehot.transpose(0, 1).reshape(k * T, E)
    pos = (flat.cumsum(0) - flat).reshape(k, T, E).transpose(0, 1)
    slot = (pos * onehot).sum(-1)  # [T, k]
    keep = slot < C
    return probs, gate_vals, gate_idx, slot, keep, C


class MoeMLP(nn.Module):
    """Drop-in MLP replacement: top-k routed experts, each a SwiGLU MLP.

    Parameters in the reference's layout: ``router [d, E]`` (f32),
    ``w_gate`` and ``w_up [E, d, f]``, ``w_down [E, f, d]``.  Input
    ``[B, L, d]``; returns ``(output [B, L, d], aux_loss)``."""

    def __init__(self, num_experts: int, hidden: int, ffn_hidden: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, mesh=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                f"expert parallelism over a mesh {_PARALLEL}")
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        E, d, f = num_experts, hidden, ffn_hidden
        self.router = nn.Parameter(torch.empty(d, E))
        self.w_gate = nn.Parameter(torch.empty(E, d, f))
        self.w_up = nn.Parameter(torch.empty(E, d, f))
        self.w_down = nn.Parameter(torch.empty(E, f, d))

    def forward(self, x):
        B, L, d = x.shape
        E, dt = self.num_experts, self.dtype
        tokens = x.reshape(B * L, d)
        probs, gate_vals, gate_idx, slot, keep, C = route(
            tokens, self.router, self.top_k, self.capacity_factor)
        onehot = F.one_hot(gate_idx, E).float()  # [T, k, E]
        # an overflowing slot is an all-zero row, as jax.nn.one_hot gives
        slot_onehot = F.one_hot(torch.where(keep, slot, 0), C).float() \
            * keep[..., None].float()  # [T, k, C]
        dispatch = torch.einsum("tke,tkc->tec", onehot, slot_onehot)
        combine = torch.einsum("tk,tke,tkc->tec", gate_vals, onehot,
                               slot_onehot)
        expert_in = torch.einsum("tec,td->ecd", dispatch,
                                 tokens.float()).to(dt)  # [E, C, d]
        h = torch.bmm(expert_in, self.w_gate.to(dt))
        u = torch.bmm(expert_in, self.w_up.to(dt))
        out = torch.bmm(F.silu(h) * u, self.w_down.to(dt))  # [E, C, d]
        y = torch.einsum("tec,ecd->td", combine, out.float())
        # Switch aux loss: E * sum_e (fraction routed) * (mean prob)
        f = onehot[:, 0, :].mean(0)
        p = probs.mean(0)
        aux = E * (f * p).sum()
        return y.reshape(B, L, d).to(x.dtype), aux


def expert_sharding_rule(path: tuple, mesh):
    """The reference's param-path rule that shards the stacked experts
    over the ``ep`` mesh axis."""
    raise NotImplementedError(f"expert sharding (expert_sharding_rule) "
                              f"{_PARALLEL}")
