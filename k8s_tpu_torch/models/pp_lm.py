"""Pipeline-parallel causal LM: the port of ``k8s_tpu/models/pp_lm.py``.

The Transformer decomposed into (pre = embedding, homogeneous block
stages, post = final norm + tied LM head + loss) for
``parallel.pipeline``'s schedules, reusing the model's own ``Block`` and
``RMSNorm`` and its tied head (``config.dtype``-rounded operands, f32
logits), so a pipelined step is the unpipelined step re-scheduled.

Each pp rank holds its own part, an :class:`LmStage`: the blocks of its
chunks under their global names (``layers.7...``, so the ranks' state
dicts and DCP checkpoints never collide and their union is the whole
model's), the tied embedding on the first rank (lookup) and the last
(head), and the final norm on the last.  The reference stores the
embedding once and replicates it over pp; here the two end ranks hold
bit-equal copies: each step sums the lookup gradient (rank 0) and the
head gradient (the last rank) in one order on both (the reference's
``psum`` over pp plus its add), and the clip and Adam then move both
copies alike.  Under pp the data axes (dp, fsdp) hold replicas: the loss
and gradients are averaged over them and parameters are not
FSDP-sharded, as the reference's ``pp_state_shardings`` shards only the
stage axis.

With ``num_virtual > 1`` (interleaved 1F1B) rank d holds chunks d, S+d,
..., (v-1)S+d, as :func:`split_lm_params` stores them device-major
(``interleave_chunks``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from k8s_tpu_torch.models.transformer import Block, RMSNorm, TransformerConfig
from k8s_tpu_torch.ops._common import resolve_device
from k8s_tpu_torch.ops.fused_norm import rms_norm, rms_norm_plain
from k8s_tpu_torch.parallel import pipeline
from k8s_tpu_torch.parallel.collectives import MeshRings, Ring, mesh_rings

_LAYER_RE = re.compile(r"^layers\.(\d+)\.(.+)$")
_BLOCK_RE = re.compile(r"^block_(\d+)\.(.+)$")


def _by_layer(params: dict) -> dict[int, dict]:
    layers: dict = {}
    for name, t in params.items():
        m = _LAYER_RE.match(name)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = t
    return layers


def split_lm_params(params: dict, num_stages: int,
                    num_virtual: int = 1) -> dict:
    """Re-layout a Transformer state dict for the pp schedules.

    Returns ``{"embedding", "final_norm.scale", "stages"}`` where
    ``stages`` lists ``num_stages * num_virtual`` chunks, each a dict of
    ``layers/(num_stages*num_virtual)`` blocks renamed ``block_{j}.*``
    locally (every chunk has the same names, as the reference's stacked
    layout requires).  With ``num_virtual > 1`` the list is in
    device-major round-robin order (chunk c on pp rank c mod S), so rank
    d's chunks are ``stages[d*v:(d+1)*v]``."""
    layers = _by_layer(params)
    idxs = sorted(layers)
    n_layers = len(idxs)
    if idxs != list(range(n_layers)):
        raise ValueError(f"non-contiguous layer keys: {idxs}")
    n_chunks = num_stages * num_virtual
    if n_layers % n_chunks:
        raise ValueError(
            f"{n_layers} layers not divisible into {n_chunks} pp chunks "
            f"({num_stages} stages x {num_virtual} virtual)")
    per = n_layers // n_chunks
    stages = [{f"block_{j}.{k}": t for j in range(per)
               for k, t in layers[ci * per + j].items()}
              for ci in range(n_chunks)]
    if num_virtual > 1:
        stages = pipeline.interleave_chunks(stages, num_stages, num_virtual)
    return {"embedding": params["embedding"],
            "final_norm.scale": params["final_norm.scale"],
            "stages": stages}


def merge_lm_params(pp_params: dict, num_stages: int,
                    num_virtual: int = 1) -> dict:
    """Inverse of :func:`split_lm_params`: back to the plain
    ``Transformer`` state dict, e.g. for export or eval without pp."""
    stages = pp_params["stages"]
    if num_virtual > 1:
        stages = pipeline.interleave_chunks(stages, num_stages, num_virtual,
                                            inverse=True)
    flat = {"embedding": pp_params["embedding"]}
    per = len({_BLOCK_RE.match(k).group(1) for k in stages[0]})
    for ci, chunk in enumerate(stages):
        for k, t in chunk.items():
            m = _BLOCK_RE.match(k)
            flat[f"layers.{ci * per + int(m.group(1))}.{m.group(2)}"] = t
    flat["final_norm.scale"] = pp_params["final_norm.scale"]
    return flat


def stage_layers(n_layers: int, rank: int, num_stages: int,
                 num_virtual: int = 1) -> list[list[int]]:
    """The global layer indices of pp rank ``rank``'s chunks, in its
    chunk order (q = 0..v-1: global chunk ``q*S + rank``)."""
    S, v = num_stages, num_virtual
    if n_layers % (S * v):
        raise ValueError(
            f"{n_layers} layers not divisible into {S * v} pp chunks "
            f"({S} stages x {v} virtual)")
    per = n_layers // (S * v)
    return [[(q * S + rank) * per + j for j in range(per)] for q in range(v)]


def pp_state_shardings(config: TransformerConfig, num_stages: int,
                       num_virtual: int = 1) -> dict[str, tuple[int, ...]]:
    """The counterpart of the reference's ``pp_state_shardings``: for each
    state-dict name, the pp ranks that hold it (a block on its stage's
    rank, the tied embedding on the two end ranks, the final norm on the
    last).  The optimizer moments follow their parameter."""
    with torch.device("meta"):
        names = [n for n, _ in Block(config).named_parameters()]
    out: dict = {}
    for r in range(num_stages):
        for chunk in stage_layers(config.layers, r, num_stages, num_virtual):
            for i in chunk:
                out.update({f"layers.{i}.{n}": (r,) for n in names})
    out["embedding"] = tuple(sorted({0, num_stages - 1}))
    out["final_norm.scale"] = (num_stages - 1,)
    return out


class _Chunk(nn.Module):
    """Consecutive blocks of one pp chunk, under their global names
    (``layers.{i}``); ``forward(x)`` runs them at positions 0..L-1."""

    def __init__(self, config: TransformerConfig, blocks: dict):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleDict(blocks)

    def forward(self, x):
        B, L = x.shape[:2]
        positions = torch.arange(L, device=x.device).expand(B, L)
        remat = self.config.remat and torch.is_grad_enabled()
        for block in self.layers.values():
            if remat:
                x, _ = torch.utils.checkpoint.checkpoint(
                    block, x, positions, use_reentrant=False)
            else:
                x, _ = block(x, positions)
        return x


class LmStage(nn.Module):
    """pp rank ``rank``'s part of a trainable Transformer (f32 masters, as
    ``Transformer(trainable=True)``): ``layers`` (a ``ModuleDict`` keyed
    by global index), ``embedding`` on the first and last rank,
    ``final_norm`` on the last.  ``params`` is a state dict holding (at
    least) these names, e.g. the whole model's; ``chunks[q]`` runs chunk
    q's blocks."""

    pipeline_stage = True

    def __init__(self, config: TransformerConfig, params: dict, *,
                 rank: int, num_stages: int, num_virtual: int = 1,
                 device="cuda"):
        super().__init__()
        self.config = config
        self.rank, self.num_stages = rank, num_stages
        self.num_virtual = num_virtual
        chunks = stage_layers(config.layers, rank, num_stages, num_virtual)
        with torch.device("meta"):
            blocks = {str(i): Block(config) for c in chunks for i in c}
            self.layers = nn.ModuleDict(blocks)
            if self.first or self.last:
                self.embedding = nn.Parameter(
                    torch.empty(config.vocab_size, config.hidden))
            if self.last:
                self.final_norm = RMSNorm(config.hidden,
                                          fused=config.use_fused_norm)
        dev = resolve_device(device)
        self.load_state_dict(
            {n: torch.as_tensor(params[n]).to(device=dev,
                                              dtype=torch.float32, copy=True)
             for n in self.state_dict()}, assign=True)
        self.requires_grad_(True)
        # a plain list: the chunks share the blocks registered above
        self.chunks = [_Chunk(config, {str(i): self.layers[str(i)]
                                       for i in c}) for c in chunks]

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.num_stages - 1


def make_stage_fn(config: TransformerConfig) -> Callable:
    """One homogeneous pp chunk: ``stage_fn(chunk, x)`` runs an
    :class:`LmStage` chunk's blocks (each under
    ``torch.utils.checkpoint`` with ``config.remat``).

    Ring attention is a collective over ``sp`` and cannot run inside a
    pp stage; pp + long context composes via the flash kernel instead."""
    if config.use_ring_attention:
        raise ValueError(
            "use_ring_attention composes with pp via flash attention, not "
            "the sp ring (collectives can't nest inside the pp shard_map)")
    return lambda chunk, x: chunk(x)


def make_pre_fn(config: TransformerConfig) -> Callable:
    """Stage-0 ingest: token ids -> embedded activations (the model's
    ``F.embedding(tokens, emb).to(dtype)``, on the first pp rank only)."""

    def pre_fn(pre_params, tokens):
        return F.embedding(tokens, pre_params["embedding"]).to(config.dtype)

    return pre_fn


def _head_logits(config: TransformerConfig, post_params, x):
    norm = rms_norm if config.use_fused_norm else rms_norm_plain
    x = norm(x, post_params["final_norm.scale"], eps=1e-6).to(config.dtype)
    # the tied head of Transformer.forward (trainable): dtype-rounded
    # operands, f32 accumulation and logits
    emb = post_params["embedding"].to(config.dtype).float()
    return torch.matmul(x.float(), emb.T)


def make_post_logits_fn(config: TransformerConfig) -> Callable:
    """Last-stage output map for pipeline_apply: activations -> logits."""
    return lambda post_params, x: _head_logits(config, post_params, x)


def make_post_loss_fn(config: TransformerConfig) -> Callable:
    """Last-stage loss head for 1F1B: activations + target tokens ->
    the microbatch's next-token loss (``train.lm_loss``).  Equal-sized
    microbatches make the mean over microbatches the global loss."""
    from k8s_tpu_torch.models.train import lm_loss

    def post_fn(post_params, x, target_tokens):
        return lm_loss(_head_logits(config, post_params, x), target_tokens)

    return post_fn


def _ends(config: TransformerConfig, stage: LmStage, tokens,
          num_microbatches: int, batch_rings) -> dict:
    pre = {"embedding": stage.embedding} if stage.first else None
    post = {"final_norm.scale": stage.final_norm.scale,
            "embedding": stage.embedding} if stage.last else None
    rows = tokens.shape[0] // max(num_microbatches, 1)
    act = torch.empty((rows, tokens.shape[1], config.hidden),
                      dtype=config.dtype, device=tokens.device)
    return dict(pre_fn=make_pre_fn(config), pre_params=pre,
                post_params=post, act=act,
                batch_rings=batch_rings)


def _rings(mesh) -> MeshRings:
    return mesh_rings(mesh) or MeshRings()


def pp_apply(mesh, config: TransformerConfig, stage: LmStage, tokens, *,
             num_microbatches: int):
    """Pipelined forward (GPipe, no interleaving): this rank's rows of
    tokens -> logits on the last pp rank (None on the others), equal to
    ``Transformer.forward`` on the merged parameters."""
    rings = _rings(mesh)
    ends = _ends(config, stage, tokens, num_microbatches,
                 (rings.dp, rings.fsdp))
    return pipeline.pipeline_apply(
        rings.pp, make_stage_fn(config), stage.chunks[0], tokens,
        num_microbatches=num_microbatches,
        post_fn=make_post_logits_fn(config), **ends)


def _tied_sum(ring: Ring, g_pre, g_post):
    """The tied embedding's gradient, lookup part + head part, on the
    first and the last rank, in one order on both (bit-equal)."""
    S = ring.size
    if S == 1:
        return g_pre + g_post
    if ring.rank == 0:
        return g_pre + ring.sendrecv(g_pre, S - 1, S - 1)
    return ring.sendrecv(g_post, 0, 0) + g_post


def pp_loss_and_grads(mesh, config: TransformerConfig, stage: LmStage,
                      tokens, targets, *, num_microbatches: int,
                      num_virtual: int = 1,
                      stats: Optional[dict] = None):
    """1F1B loss + this rank's gradients, keyed by ``stage``'s parameter
    names (the tied embedding's two parts summed on both end ranks).
    ``num_virtual > 1`` runs the interleaved schedule over the rank's
    round-robin chunks.  ``mesh``: a DeviceMesh or one rank's
    MeshRings (pp, and the dp/fsdp replicas the loss and gradients are
    averaged over)."""
    rings = _rings(mesh)
    ring = rings.pp
    if stage.num_stages != ring.size or stage.rank != ring.rank \
            or stage.num_virtual != num_virtual:
        raise ValueError(
            f"stage of rank {stage.rank}/{stage.num_stages} x "
            f"{stage.num_virtual} virtual on pp rank {ring.rank}/"
            f"{ring.size} with num_virtual {num_virtual}")
    ends = _ends(config, stage, tokens, num_microbatches,
                 (rings.dp, rings.fsdp))
    stage_fn = make_stage_fn(config)
    post_fn = make_post_loss_fn(config)
    if num_virtual > 1:
        loss, (g_chunks, g_pre, g_post) = \
            pipeline.pipeline_train_step_interleaved(
                ring, stage_fn, stage.chunks, tokens, targets,
                num_microbatches=num_microbatches, num_virtual=num_virtual,
                post_fn=post_fn, stats=stats, **ends)
        grads = {k: g for c in g_chunks for k, g in c.items()}
    else:
        loss, (grads, g_pre, g_post) = pipeline.pipeline_train_step_1f1b(
            ring, stage_fn, stage.chunks[0], tokens, targets,
            num_microbatches=num_microbatches, post_fn=post_fn,
            stats=stats, **ends)
    if stage.last:
        grads["final_norm.scale"] = g_post["final_norm.scale"]
    if stage.first or stage.last:
        # tied embedding: lookup grad (stage 0) + head grad (last stage)
        grads["embedding"] = _tied_sum(
            ring, g_pre["embedding"] if stage.first else None,
            g_post["embedding"] if stage.last else None)
    return loss, grads


@torch.no_grad()
def clip_over_stages_(stage: LmStage, max_norm: float, ring: Ring):
    """``optax.clip_by_global_norm`` over the whole split model: the sum
    of squares of every rank's gradients (the tied embedding counted
    once, on rank 0), reduced over the pp ring; returns the norm."""
    from k8s_tpu_torch.models.train import clip_to_norm_

    grads = [p.grad for n, p in stage.named_parameters()
             if not (n == "embedding" and stage.last and not stage.first)]
    sq = torch.stack(torch._foreach_norm(grads)).square().sum()
    norm = ring.all_reduce(sq).sqrt()
    clip_to_norm_([p.grad for p in stage.parameters()], norm, max_norm)
    return norm


def make_pp_train_step(config: TransformerConfig, optimizer, mesh, *,
                       num_microbatches: int, num_virtual: int = 1,
                       stats: Optional[dict] = None) -> Callable:
    """The 1F1B train step over an :class:`LmStage` state (``{"model":
    stage, "optimizer", "step"}``, from ``train.init_state``): the pp
    analogue of ``train.make_sharded_train_step``.  ``step(state, (tokens,
    targets))`` takes this rank's rows, clips by the global norm over
    every stage, updates in place and returns the global mean loss (on
    every rank).  ``stats``: a dict that receives this rank's
    ``peak_stashed`` (see ``pipeline``) and, with the clip on, the
    ``grad_norm`` it clipped by."""
    rings = _rings(mesh)
    clip = optimizer.clip_norm if optimizer.clip_norm else 0.0
    update = dataclasses.replace(optimizer, clip_norm=0.0)

    def step(state, batch):
        tokens, targets = batch
        model, opt = state["model"], state["optimizer"]
        loss, grads = pp_loss_and_grads(
            rings, config, model, tokens, targets,
            num_microbatches=num_microbatches, num_virtual=num_virtual,
            stats=stats)
        for n, p in model.named_parameters():
            p.grad = grads[n]
        if clip > 0:
            norm = clip_over_stages_(model, clip, rings.pp)
            if stats is not None:
                stats["grad_norm"] = norm
        update.update(opt)
        state["step"] += 1
        return state, loss

    return step
