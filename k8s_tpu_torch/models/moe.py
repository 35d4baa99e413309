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

Expert parallelism over the ``ep`` ring (``MoeMLP(mesh=...)``, or
``place_`` on a whole layer): ep rank r holds experts ``[r*E/ep,
(r+1)*E/ep)``.  The reference shards the batch over (dp, fsdp), not ep,
so an ep group holds the same tokens; every rank routes them alike (the
capacity from the group's whole T, the drops the reference's), runs its
experts on its slice of ``expert_in`` and the partial outputs are summed
over ep.  The tokens and the gate weights enter that sum through
``parallel.collectives.ep_enter`` (identity forward, sum backward) and
leave it through ``ep_exit`` (sum forward, identity backward), while the
router and the aux loss stay outside it: so the router's gradient arrives
whole through the gates, and no replicated parameter's gradient is ever
summed over ep.  Over data axes (dp, fsdp) each rank holds a block of the
global batch, which the reference routes as one: the capacity, the
priority order of the slots and the aux loss's means are the global
batch's (``route(data=...)``; the means enter through a ``psum``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from k8s_tpu_torch.parallel.collectives import (
    MeshRings, Ring, ep_enter, ep_exit, mesh_rings, psum,
)

EXPERT_PARAMS = ("w_gate", "w_up", "w_down")


def top_k_lowest_index(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by ascending index (a stable
    descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _data_index(data) -> int:
    """This rank's block of the global batch over the data rings (dp
    major), as ``parallel.mesh.data_sharding`` hands out rows."""
    index = 0
    for ring in data:
        index = index * ring.size + ring.rank
    return index


def _gather_data(x, data):
    """``[n, *x.shape]``: every data rank's ``x`` in batch-block order."""
    for ring in reversed(data):
        x = ring.all_gather(x)
    return x.reshape(-1, *x.shape[len(data):])


def route(tokens: torch.Tensor, router: torch.Tensor, top_k: int,
          capacity_factor: float, data=()):
    """The routing of ``[T, d]`` tokens: returns ``(probs [T, E],
    gate_vals [T, k], gate_idx [T, k], slot [T, k], keep [T, k], C)``.

    ``data``: the data rings (dp, fsdp) when the tokens are this rank's
    block of a global batch: the capacity is then the global batch's and
    a pair's slot its position in the global priority order (every rank's
    first choices, in batch order, before any second choice), as the
    reference routes the global batch its data axes shard."""
    T, E = tokens.shape[0], router.shape[-1]
    k = min(top_k, E)
    logits = tokens.float() @ router.float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lowest_index(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    n = math.prod(r.size for r in data)
    # GShard scales capacity by k: k*T (token, choice) pairs share E*C
    # slots
    C = max(1, math.ceil(k * T * n / E * capacity_factor))
    onehot = F.one_hot(gate_idx, E)  # [T, k, E]
    # each pair's position in its expert's buffer, primary choices first
    flat = onehot.transpose(0, 1).reshape(k * T, E)
    pos = (flat.cumsum(0) - flat).reshape(k, T, E)
    if n > 1:
        counts = onehot.sum(0)  # [k, E] pairs by choice level
        every = _gather_data(counts, data)  # [n, k, E]
        total = every.sum(0)
        # all ranks' pairs of earlier levels and the earlier ranks' pairs
        # of this level go first; the local count covered this rank's own
        # earlier levels
        pos = pos + (total.cumsum(0) - total
                     + every[:_data_index(data)].sum(0)
                     - (counts.cumsum(0) - counts))[:, None, :]
    slot = (pos.transpose(0, 1) * onehot).sum(-1)  # [T, k]
    keep = slot < C
    return probs, gate_vals, gate_idx, slot, keep, C


class MoeMLP(nn.Module):
    """Drop-in MLP replacement: top-k routed experts, each a SwiGLU MLP.

    Parameters in the reference's layout: ``router [d, E]`` (f32),
    ``w_gate`` and ``w_up [E, d, f]``, ``w_down [E, f, d]``; over a mesh
    with ep > 1 the expert stacks hold this rank's ``E/ep`` experts, and
    over data axes (dp, fsdp) the routing and the aux loss are the global
    batch's (``route``).  Input ``[B, L, d]``; returns ``(output [B, L,
    d], aux_loss)``."""

    def __init__(self, num_experts: int, hidden: int, ffn_hidden: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, mesh=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.ep, self.data = _rings_of(mesh)
        E, d, f = num_experts, hidden, ffn_hidden
        El = _experts_per_rank(E, self.ep)
        self.router = nn.Parameter(torch.empty(d, E))
        self.w_gate = nn.Parameter(torch.empty(El, d, f))
        self.w_up = nn.Parameter(torch.empty(El, d, f))
        self.w_down = nn.Parameter(torch.empty(El, f, d))

    def place_(self, mesh) -> Ring:
        """Put a whole layer on ``mesh``, in place: keep only this ep
        rank's experts (new parameters, copies of the slices) and route
        over the data ranks' global batch; returns the ep ring."""
        if self.ep.size > 1:
            raise ValueError("the experts are sharded over ep already")
        ring, self.data = _rings_of(mesh)
        for name in EXPERT_PARAMS:
            p = getattr(self, name)
            setattr(self, name, nn.Parameter(
                expert_slice(name, ring)(p.detach()).clone(),
                requires_grad=p.requires_grad))
        self.ep = ring
        return ring

    def forward(self, x):
        B, L, d = x.shape
        E, dt, ring = self.num_experts, self.dtype, self.ep
        tokens = x.reshape(B * L, d)
        probs, gate_vals, gate_idx, slot, keep, C = route(
            tokens, self.router, self.top_k, self.capacity_factor,
            self.data)
        onehot = F.one_hot(gate_idx, E).float()  # [T, k, E]
        # an overflowing slot is an all-zero row, as jax.nn.one_hot gives
        slot_onehot = F.one_hot(torch.where(keep, slot, 0), C).float() \
            * keep[..., None].float()  # [T, k, C]
        # this rank's experts: the whole ep group routed alike
        El = self.w_gate.shape[0]
        mine = onehot[..., ring.rank * El:(ring.rank + 1) * El]
        dispatch = torch.einsum("tke,tkc->tec", mine, slot_onehot)
        combine = torch.einsum("tk,tke,tkc->tec", ep_enter(gate_vals, ring),
                               mine, slot_onehot)
        expert_in = torch.einsum("tec,td->ecd", dispatch,
                                 ep_enter(tokens, ring).float()).to(dt)
        h = torch.bmm(expert_in, self.w_gate.to(dt))
        u = torch.bmm(expert_in, self.w_up.to(dt))
        out = torch.bmm(F.silu(h) * u, self.w_down.to(dt))  # [El, C, d]
        y = ep_exit(torch.einsum("tec,ecd->td", combine, out.float()), ring)
        # Switch aux loss: E * sum_e (fraction routed) * (mean prob), over
        # the global batch (a data rank's probs enter the sum whole)
        if self.data:
            n = B * L * math.prod(r.size for r in self.data)
            f = psum(onehot[:, 0, :].sum(0), self.data).detach() / n
            p = psum(probs.sum(0), self.data) / n
        else:
            f = onehot[:, 0, :].mean(0)
            p = probs.mean(0)
        aux = E * (f * p).sum()
        return y.reshape(B, L, d).to(x.dtype), aux


def _rings_of(mesh) -> tuple[Ring, tuple]:
    """The ep ring and the data rings (dp, fsdp; those of more than one
    rank) of a mesh: a DeviceMesh or MeshRings, None for one rank."""
    rings = mesh_rings(mesh) if mesh is not None else MeshRings()
    return rings.ep, tuple(r for r in (rings.dp, rings.fsdp) if r.size > 1)


def _experts_per_rank(E: int, ring: Ring) -> int:
    if E % ring.size:
        raise ValueError(f"{E} experts do not divide over ep {ring.size}")
    return E // ring.size


def is_expert_param(name: str) -> bool:
    """Whether a state-dict name is a stacked expert weight."""
    return name.rsplit(".", 1)[-1] in EXPERT_PARAMS


def expert_slice(name: str, ring: Ring):
    """``fn(t)``: the ep rank's experts of a tensor shaped like the
    whole expert stack ``name`` (the identity for every other name, or
    one rank)."""
    if ring is None or ring.size == 1 or not is_expert_param(name):
        return lambda t: t

    def fn(t):
        El = _experts_per_rank(t.shape[0], ring)
        return t[ring.rank * El:(ring.rank + 1) * El]

    return fn


def expert_sharding_rule(path, mesh):
    """Param-path sharding rule: stacked expert weights shard their
    leading expert dim over ``ep`` (``("ep",)``; None for any other
    path).  ``path`` is a state-dict name or a tuple of its parts.
    ``parallel.sharding.fsdp_sharding(rules=...)`` composes it with the
    fsdp rule on the remaining dims."""
    del mesh  # the rule names the axis; its size is the mesh's
    parts = path.split(".") if isinstance(path, str) else \
        [getattr(p, "key", str(p)) for p in path]
    if any(n in EXPERT_PARAMS for n in parts):
        return ("ep",)
    return None
