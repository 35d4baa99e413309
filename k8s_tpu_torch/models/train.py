"""Training: loss, optimizer, train step and the fit loop, on one device
or FSDP-sharded over a mesh.

Port of ``k8s_tpu/models/train.py``.  The reference's pytree state
``{params, opt_state, step}`` becomes ``{"model", "optimizer", "step"}``:
a trainable ``nn.Module`` (f32 master weights), the ``torch.optim``
optimizer that owns its moments, and an int.  ``apply_fn(model, inputs)``
takes the module where the reference's takes params.  What the reference
gets from optax is reproduced exactly:

- the loss averages over **all** labels, out-of-range ones counting zero
  (``F.cross_entropy(ignore_index=...)`` would average over valid ones);
- global-norm clipping is optax's ``g * max_norm / g_norm`` when
  ``g_norm >= max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm);
- Adam, or AdamW (decoupled) with the given weight decay, never torch's
  default 0.01; b1 0.9, b2 0.999, eps 1e-8 as optax;
- schedules are evaluated at the count of updates before this one, as
  ``optax.scale_by_schedule`` does, warmup joined to cosine or linear decay.

The loss stays on the device: ``fit`` syncs it only where the reference
logs.

Sharded training (``shard_train_state``, ``make_sharded_train_step``,
``fit(mesh=...)``) is FSDP2 over the mesh's (dp, fsdp) axes: each
``Block`` and then the root are ``fully_shard``-ed (the tied embedding
stays in the root, where the gather and the head both use it), with no
mixed-precision policy, so the f32 masters are gathered and the model
casts where it casts unsharded.  Each rank runs its rows of the global
batch; FSDP2 averages the gradients over the data axes, the clip reduces
the norm across the shards, and the step returns the global mean loss.

Sequence and tensor parallelism ride the same step, as in the reference,
whose parameter rule is fsdp-only: parameters are replicated over the
``sp`` and ``tp`` axes, each FSDP2 group spans the (dp, fsdp) ranks of
one (sp, tp) position, and the model gets the mesh (``apply_fn`` passes
it on: ``m(x, mesh=mesh)``).  Each rank runs its rows and its chunk of
the sequence; :func:`make_lm_loss` takes each chunk's next-token loss
over the global token count, so the gradients summed over ``sp`` (after
FSDP2's average over the data axes) are the unsharded step's.  Every tp
rank runs the same rows and ends with the same gradients (the attention's
tp pair gathers them), so nothing is summed over tp.

Expert parallelism rides it too: over a mesh with ep > 1,
:func:`shard_train_state` leaves each rank its ``E/ep`` experts of every
MoE layer (``MoeMLP.place_``, the reference's
``expert_sharding_rule``) and FSDP-shards them over fsdp like every other
parameter.  An ep group holds the same rows (the batch is split over dp
and fsdp only), routes them alike and sums its experts' outputs with the
ep pair of ``parallel.collectives``, whose backward hands every rank the
whole gradient of the replicated parameters, so none is summed over ep;
the clip's norm counts each expert once.  Pipeline parallelism trains
through ``models.pp_lm.make_pp_train_step``; this step treats a pp axis
as replicas.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import math
import os
import threading
import time
from typing import Callable, Optional

import torch

log = logging.getLogger(__name__)


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy; logits ``[B, C]`` (or ``[B, L, C]``),
    in f32.  Logsumexp-minus-gather: no one-hot or log-prob tensor.
    Out-of-range labels (the ``label = -1`` padding idiom) contribute zero
    loss and zero gradient while still counting in the mean's
    denominator."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < num_classes)
    safe = labels.clamp(0, num_classes - 1)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, lse - picked, 0.0).mean()


def lm_loss(logits, tokens):
    """Next-token prediction loss over ``[B, L, V]`` logits and ``[B, L]``
    tokens."""
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])


def _sp_ring(mesh):
    """The mesh's sp ring when sp > 1, else None."""
    from k8s_tpu_torch.parallel.collectives import mesh_rings

    rings = mesh_rings(mesh)
    return rings.sp if rings is not None and rings.sp.size > 1 else None


def sp_next_tokens(tokens, ring):
    """The next-token labels of this rank's chunk ``[B, Lc]`` of the
    sequence: the chunk shifted by one, its last column the next rank's
    first token (-1, no label, after the global last position)."""
    nxt = ring.sendrecv(tokens[:, :1].contiguous(),
                        (ring.rank - 1) % ring.size,
                        (ring.rank + 1) % ring.size)
    if ring.rank == ring.size - 1:
        nxt = torch.full_like(nxt, -1)
    return torch.cat([tokens[:, 1:], nxt], dim=1)


def make_lm_loss(mesh=None) -> Callable:
    """:func:`lm_loss`, or over a mesh with sp > 1 its sequence-parallel
    form: ``loss(logits, tokens)`` on this rank's chunk is the chunk's
    summed next-token loss (labels from :func:`sp_next_tokens`) over the
    rows' global count, ``B * (L - 1)``, so the losses of a row's chunks
    sum to the reference's mean over the whole sequence."""
    ring = _sp_ring(mesh)
    if ring is None:
        return lm_loss

    def loss(logits, tokens):
        labels = sp_next_tokens(tokens, ring)
        Lc = tokens.shape[1]
        return cross_entropy_loss(logits, labels) * (
            Lc / (Lc * ring.size - 1))

    return loss


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: ``init`` to ``end`` over ``steps``."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (
        1 - min(max(count, 0), steps) / steps) + end


def lr_schedule(lr: float, *, schedule: str = "constant",
                warmup_steps: int = 0, decay_steps: int = 0,
                final_fraction: float = 0.1) -> Callable[[int], float]:
    """Learning rate as a function of the update count: linear warmup to
    ``lr`` over ``warmup_steps``, then "constant" | "cosine" | "linear"
    decay over ``decay_steps`` down to ``final_fraction * lr`` — optax's
    schedules, joined as ``optax.join_schedules`` joins them."""
    if schedule not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule != "constant" and decay_steps <= 0:
        raise ValueError(f"schedule {schedule!r} needs decay_steps > 0")
    if schedule == "cosine":
        def main(count):
            c = min(count, decay_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return lr * ((1 - final_fraction) * cosine + final_fraction)
    elif schedule == "linear":
        main = _linear(lr, lr * final_fraction, decay_steps)
    else:
        def main(count):
            return lr
    if warmup_steps > 0:
        warm = _linear(0.0, lr, warmup_steps)
        return lambda count: warm(count) if count < warmup_steps \
            else main(count - warmup_steps)
    return main


def _sharded_sq_norm(grads: list) -> tuple[list, torch.Tensor]:
    """The local shards of FSDP-sharded (DTensor) gradients and the sum of
    their squares over every shard: a sum of the local squares, reduced
    over the mesh dims the gradients are sharded on (not over dp, where
    they are replicated)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    def layout(g):  # the mesh, and which of its dims shard the tensor
        return g.device_mesh, tuple(isinstance(p, Shard)
                                    for p in g.placements)

    mesh, sharded_dims = layout(grads[0])
    if any(layout(g) != (mesh, sharded_dims) for g in grads):
        raise ValueError("gradients sharded over different meshes")
    local = [g.to_local() for g in grads]
    sq = torch.stack(torch._foreach_norm(local)).square().sum()
    for dim, sharded in enumerate(sharded_dims):
        if sharded:
            dist.all_reduce(sq, group=mesh.get_group(dim))
    return local, sq


@torch.no_grad()
def clip_to_norm_(grads: list, norm: torch.Tensor, max_norm: float) -> None:
    """Scale ``grads`` in place as optax.clip_by_global_norm does, given
    their global ``norm``: ``(g / norm) * max_norm`` when ``norm`` reaches
    ``max_norm``.  No host sync."""
    clip = norm >= max_norm
    div = torch.where(clip, norm, 1.0)
    mul = torch.where(clip, max_norm, 1.0).to(norm.dtype)
    for g in grads:
        g.div_(div).mul_(mul)


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm`` every gradient becomes ``(g / g_norm) * max_norm``.  No
    host sync; returns the norm.  FSDP-sharded gradients take the norm
    of the whole gradient, reduced across the shards."""
    from torch.distributed.tensor import DTensor

    if grads and isinstance(grads[0], DTensor):
        grads, sq = _sharded_sq_norm(grads)
        norm = sq.sqrt()
    else:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    clip_to_norm_(grads, norm, max_norm)
    return norm


@torch.no_grad()
def clip_over_ep_(model: torch.nn.Module, max_norm: float, ring) -> None:
    """clip_by_global_norm_ over an FSDP-sharded model whose experts are
    split over the ep ring: the experts' squares summed over ep, every
    other gradient (replicated over ep) counted once."""
    from k8s_tpu_torch.models.moe import is_expert_param

    named = [(n, p.grad) for n, p in model.named_parameters()
             if p.grad is not None]
    experts = [g for n, g in named if is_expert_param(n)]
    local, sq = _sharded_sq_norm([g for n, g in named
                                  if not is_expert_param(n)])
    local_e, sq_e = _sharded_sq_norm(experts)
    norm = (sq + ring.all_reduce(sq_e)).sqrt()
    clip_to_norm_(local + local_e, norm, max_norm)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optimizer of :func:`default_optimizer`: ``init(params)`` builds
    the ``torch.optim`` optimizer that holds the moments (the reference's
    ``opt_state``); ``update(opt)`` clips the gradients and takes one step
    at the schedule's rate.  The update count lives in the optimizer's
    param groups, so it is checkpointed with the moments."""

    lr: float | Callable[[int], float]
    weight_decay: float = 0.0
    clip_norm: float = 0.0

    def init(self, params) -> torch.optim.Optimizer:
        lr = self.lr(0) if callable(self.lr) else self.lr
        kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
        if self.weight_decay:
            opt = torch.optim.AdamW(params, weight_decay=self.weight_decay,
                                    **kw)
        else:
            opt = torch.optim.Adam(params, **kw)
        for group in opt.param_groups:
            group["count"] = 0
        return opt

    def update(self, opt: torch.optim.Optimizer) -> None:
        if self.clip_norm and self.clip_norm > 0:
            clip_by_global_norm_(
                [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None], self.clip_norm)
        for group in opt.param_groups:
            if callable(self.lr):
                group["lr"] = self.lr(group["count"])
            group["count"] += 1
        opt.step()


def default_optimizer(lr: float = 1e-3, weight_decay: float = 0.0,
                      *, clip_norm: float = 0.0, schedule: str = "constant",
                      warmup_steps: int = 0, decay_steps: int = 0
                      ) -> Optimizer:
    """Adam/AdamW with optional global-norm clipping and LR schedule, as
    the reference's optax chain clip_by_global_norm -> adam(w)(schedule)."""
    sched = lr if (schedule == "constant" and not warmup_steps) else \
        lr_schedule(lr, schedule=schedule, warmup_steps=warmup_steps,
                    decay_steps=decay_steps)
    return Optimizer(sched, weight_decay=weight_decay, clip_norm=clip_norm)


def init_state(model: torch.nn.Module, optimizer: Optimizer) -> dict:
    """Train state: ``{"model", "optimizer", "step"}``."""
    return {"model": model, "optimizer": optimizer.init(model.parameters()),
            "step": 0}


def _combined_loss(apply_fn: Callable, loss_fn: Callable, model, batch):
    """The one definition of 'the loss' shared by training and held-out
    eval: apply_fn may return (logits, aux_scalar), added to the task
    loss."""
    inputs, targets = batch
    out = apply_fn(model, inputs)
    if isinstance(out, tuple):
        logits, aux = out
    else:
        logits, aux = out, 0.0
    return loss_fn(logits, targets) + aux


def make_train_step(apply_fn: Callable, loss_fn: Callable,
                    optimizer: Optimizer, grad_accum: int = 1,
                    reduce_grads: Optional[Callable] = None) -> Callable:
    """``step(state, batch) -> (state, loss)``: gradients, then the
    optimizer update, in place.  The loss is returned as a device tensor.

    ``grad_accum > 1`` splits the batch into that many microbatches and
    sums their gradients before one update (then divides by
    ``grad_accum``, as the reference does): activation memory of one
    microbatch, the update of the full batch.  ``reduce_grads(model)``
    runs after the backward, before the update (the sharded step's sum
    over sp)."""

    def step(state, batch):
        model, opt = state["model"], state["optimizer"]
        opt.zero_grad(set_to_none=True)
        if grad_accum > 1:
            inputs, targets = batch
            if inputs.shape[0] % grad_accum:
                raise ValueError(
                    f"global batch {inputs.shape[0]} not divisible into "
                    f"{grad_accum} microbatches")
            total = 0.0
            for mb in zip(inputs.chunk(grad_accum), targets.chunk(grad_accum)):
                loss = _combined_loss(apply_fn, loss_fn, model, mb)
                loss.backward()
                total = total + loss.detach()
            loss = total / grad_accum
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, grad_accum)
        else:
            loss = _combined_loss(apply_fn, loss_fn, model, batch)
            loss.backward()
            loss = loss.detach()
        if reduce_grads is not None:
            reduce_grads(model)
        optimizer.update(opt)
        state["step"] += 1
        return state, loss

    return step


@dataclasses.dataclass(frozen=True)
class StateShardings:
    """Where a sharded train state lives: the mesh, and each parameter's
    spec (``{name: spec}``, the reference's PartitionSpecs as tuples;
    the optimizer moments follow their parameter)."""

    mesh: object
    params: dict


def is_sharded(model: torch.nn.Module) -> bool:
    """True when each rank holds a part of ``model``: FSDP holds its
    parameters as shards, or it is one pp rank's stage
    (``models.pp_lm.LmStage``)."""
    from torch.distributed.tensor import DTensor

    return getattr(model, "pipeline_stage", False) or any(
        isinstance(p, DTensor) for p in model.parameters())


def _replicas(mesh) -> int:
    """How many ranks hold each row's loss: every rank but the sp chunks
    of a row (dp x fsdp rows, each on its tp, pp and ep ranks alike)."""
    from k8s_tpu_torch.parallel.mesh import mesh_shape

    shape = mesh_shape(mesh)
    return math.prod(shape.values()) // shape["sp"]


def _ep_ring(mesh):
    """The mesh's ep ring when ep > 1, else None."""
    from k8s_tpu_torch.parallel.collectives import mesh_rings

    ring = mesh_rings(mesh).ep
    return ring if ring.size > 1 else None


@torch.no_grad()
def sum_grads_over_sp(model: torch.nn.Module, mesh) -> None:
    """Sum the gradients of an FSDP-sharded model over the mesh's sp axis,
    in place: the chunks of a row each gave their part (one flat
    all-reduce of the local shards, which are laid out alike on every sp
    rank).  A no-op at sp 1."""
    ring = _sp_ring(mesh)
    if ring is None:
        return
    local = [p.grad.to_local() for p in model.parameters()
             if p.grad is not None]
    flat = ring.all_reduce(torch.cat([g.reshape(-1) for g in local]))
    for g, part in zip(local, flat.split([g.numel() for g in local])):
        g.copy_(part.view_as(g))


def shard_train_state(state: dict, mesh) -> tuple[dict, StateShardings]:
    """FSDP-shard the model over the mesh's (dp, fsdp) axes, in place:
    ``fully_shard`` on each ``Block`` (``model.layers``) and then on the
    root, each parameter placed by ``parallel.sharding.fsdp_sharding``
    (HSDP over a dp > 1 mesh).  Each MoE layer is first put on the mesh
    (``MoeMLP.place_``: over ep > 1 it keeps only this rank's experts,
    whose spec leads with ``ep``; it routes the global batch).  The
    optimizer is rebuilt over the sharded parameters with its param
    groups (the schedule's ``count``) and any moments it holds, sharded
    like their parameter.  Returns ``(state, shardings)``."""
    from torch.distributed.tensor import distribute_tensor

    from k8s_tpu_torch.models import moe
    from k8s_tpu_torch.parallel import sharding

    model, opt = state["model"], state["optimizer"]
    if is_sharded(model):
        raise ValueError("the train state is sharded already")
    name_of = {id(p): n for n, p in model.named_parameters()}
    ep = _ep_ring(mesh)
    for m in model.modules():
        if isinstance(m, moe.MoeMLP):
            m.place_(mesh)
    old = dict(model.named_parameters())
    specs = sharding.fsdp_sharding(
        old, mesh, rules=(moe.expert_sharding_rule,) if ep else ())
    sharding.apply_fsdp(model, specs, mesh)
    new = dict(model.named_parameters())
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [new[name_of[id(p)]] for p in g["params"]]}
              for g in opt.param_groups]
    sharded_opt = type(opt)(groups)
    for p_old, moments in opt.state.items():
        name = name_of[id(p_old)]
        p = new[name]
        local = moe.expert_slice(name, ep)

        def place(v):
            if not torch.is_tensor(v) or v.shape != p_old.shape:
                return v
            return distribute_tensor(local(v.detach()), p.device_mesh,
                                     p.placements)

        sharded_opt.state[p] = {k: place(v) for k, v in moments.items()}
    state["optimizer"] = sharded_opt
    return state, StateShardings(mesh, specs)


def make_sharded_train_step(apply_fn: Callable, loss_fn: Callable,
                            optimizer: Optimizer, mesh,
                            state_shardings: StateShardings,
                            batch_axes: tuple = ("dp", "fsdp"),
                            grad_accum: int = 1) -> Callable:
    """The train step over a state from :func:`shard_train_state`.  The
    batch is this rank's rows of the global batch, and with sp > 1 its
    chunk of the sequence (``parallel.mesh.data_sharding``;
    ``models.data.prefetch_to_mesh`` hands them out); FSDP2 gathers each
    layer's parameters around its use and averages the gradients over
    ``batch_axes``, and then the gradients are summed over sp (``loss_fn``
    over a mesh with sp > 1 is :func:`make_lm_loss`'s, whose chunk losses
    sum to a row's mean).  Returns the global batch's mean loss, on the
    device."""
    import torch.distributed as dist

    if tuple(batch_axes) != ("dp", "fsdp"):
        raise ValueError(f"batch_axes {batch_axes}: the batch is split "
                         "over (dp, fsdp)")
    if state_shardings.mesh is not mesh:
        raise ValueError("state_shardings are of another mesh")
    sp_ring = _sp_ring(mesh)
    if sp_ring is not None and loss_fn is lm_loss:
        # lm_loss on a chunk would drop the label across each boundary
        # and average over the chunk, not the row
        raise ValueError("over a mesh with sp > 1 the loss is "
                         "make_lm_loss(mesh)'s, not lm_loss")
    # the world's sum counts each row's mean once per rank but its sp
    # chunks
    copies = _replicas(mesh)
    ep = _ep_ring(mesh)
    clip = optimizer.clip_norm if ep is not None else 0.0

    def reduce_grads(m):
        sum_grads_over_sp(m, mesh)
        if clip:
            clip_over_ep_(m, clip, ep)

    step = make_train_step(
        apply_fn, loss_fn,
        dataclasses.replace(optimizer, clip_norm=0.0) if clip else optimizer,
        grad_accum=grad_accum,
        reduce_grads=reduce_grads if sp_ring or clip else None)

    def sharded_step(state, batch):
        if not is_sharded(state["model"]):
            raise ValueError("make_sharded_train_step needs the state "
                             "shard_train_state returns")
        state, loss = step(state, batch)
        # every data shard holds as many rows: the global mean is the
        # mean of the shards' means (gloo has no AVG)
        dist.all_reduce(loss)
        return state, loss / copies

    return sharded_step


def make_moe_apply_fn(model, *, aux_loss_weight: float = 0.01, mesh=None):
    """apply_fn for make_train_step/fit over an MoE transformer: runs the
    model gathering every MoE layer's load-balance loss and returns
    ``(logits, aux_loss_weight * sum)``, which the train step adds to the
    task loss.  Without it the routers get no balancing gradient,
    collapse onto a few experts, and capacity-bounded dispatch drops most
    tokens.  ``mesh`` is passed to the model (expert parallelism needs
    nothing more: ``shard_train_state`` gave each MoE layer its experts
    and its ep ring)."""
    del model  # the apply_fn takes the model it runs, as every apply_fn

    def apply_fn(m, inputs):
        aux: list = []
        logits = m(inputs, aux_losses=aux, mesh=mesh)
        total = sum(aux) if aux else logits.new_zeros(())
        return logits, aux_loss_weight * total

    return apply_fn


class MetricsWriter:
    """Append-only JSONL training scalars: one ``{"step": N, "wall_time":
    unix_s, ...scalars}`` object per record, line-buffered, so curves
    survive preemption (a resumed run appends after the checkpoint's
    steps)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "wall_time": round(time.time(), 3)}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def make_eval_fn(apply_fn: Callable, loss_fn: Callable,
                 eval_iter_factory: Callable, *, batches: int = 8,
                 mesh=None):
    """Held-out evaluation for fit(): mean loss over ``batches`` batches of
    a fresh ``eval_iter_factory()`` stream, without gradients.  With
    ``mesh`` the stream yields this rank's part of each batch
    (``prefetch_to_mesh``) and each batch's loss is reduced over the
    mesh as the sharded step reduces it."""
    copies = None if mesh is None else _replicas(mesh)

    def batch_loss(model, batch):
        loss = _combined_loss(apply_fn, loss_fn, model, batch).detach()
        if copies is not None:
            import torch.distributed as dist

            dist.all_reduce(loss)
            loss = loss / copies
        return float(loss)

    def eval_fn(state) -> float:
        it = eval_iter_factory()
        try:
            total, n = 0.0, 0
            with torch.no_grad():
                for batch in itertools.islice(it, batches):
                    total += batch_loss(state["model"], batch)
                    n += 1
        finally:
            close = getattr(it, "close", None)
            if callable(close):
                close()
        if n == 0:
            raise ValueError("eval stream yielded no batches")
        return total / n

    return eval_fn


@dataclasses.dataclass
class FitResult:
    """Outcome of a fit() run.  ``preempted`` is what the pod entrypoint
    acts on (exit 143 so the operator's exit-code policy restarts the
    gang)."""

    state: dict
    losses: list
    preempted: bool = False
    start_step: int = 0
    # (step, loss) pairs from the held-out eval_fn, when one was passed
    eval_losses: list = dataclasses.field(default_factory=list)

    def __iter__(self):  # (state, losses) unpacking compatibility
        yield self.state
        yield self.losses


def fit(apply_fn: Callable, loss_fn: Callable, optimizer: Optimizer,
        state: dict, data_iter, *, steps: int, checkpoint_dir: str = "",
        checkpoint_every: int = 100, preemption_save: bool = True,
        log_every: int = 0, eval_fn: Optional[Callable] = None,
        eval_every: int = 0, grad_accum: int = 1,
        metrics_path: str = "", mesh=None,
        step_fn: Optional[Callable] = None,
        state_shardings: Optional[StateShardings] = None,
        skip_data_on_resume: bool = True) -> FitResult:
    """The training loop, with the reference's contract: resume from the
    latest checkpoint under ``checkpoint_dir`` (fast-forwarding the data
    stream past the batches the checkpointed run consumed, unless
    ``skip_data_on_resume`` is False: then the resumed run reads the
    stream from its head, as the reference's does), save every
    ``checkpoint_every`` steps, and on SIGTERM (with
    ``preemption_save``) save at the next step boundary and return with
    ``preempted=True``.  ``eval_fn`` runs every ``eval_every`` steps and
    after the last; ``metrics_path`` appends JSONL scalars (every
    ``log_every``'th step, every step when 0, and the last), from process
    0 only.  The state is updated in place and returned in the result.

    Without ``mesh`` the step is :func:`make_train_step` on one device.
    With it the state is sharded (:func:`shard_train_state`) and the step
    is :func:`make_sharded_train_step`; ``data_iter`` then yields this
    rank's rows (``models.data.prefetch_to_mesh``).  A prebuilt
    ``step_fn(state, batch) -> (state, loss)`` replaces the default step;
    with ``state_shardings`` the state is sharded on their mesh first
    unless it is already."""
    if step_fn is None and mesh is not None:
        state, shardings = shard_train_state(state, mesh)
        step_fn = make_sharded_train_step(apply_fn, loss_fn, optimizer,
                                          mesh, shardings,
                                          grad_accum=grad_accum)
    elif step_fn is None:
        step_fn = make_train_step(apply_fn, loss_fn, optimizer,
                                  grad_accum=grad_accum)
    elif state_shardings is not None and not is_sharded(state["model"]):
        state, _ = shard_train_state(state, state_shardings.mesh)

    ckpt = None
    start_step = 0
    if checkpoint_dir:
        from k8s_tpu_torch.models.checkpoint import Checkpointer

        ckpt = Checkpointer(checkpoint_dir,
                            save_interval_steps=checkpoint_every)
        state, start_step = ckpt.restore_or_init(state)
        if start_step > 0 and skip_data_on_resume:
            # continue the (deterministic, seeded) stream where training
            # stopped; data_iter must be freshly positioned at its start
            skip = getattr(data_iter, "skip", None)
            try:
                if callable(skip):
                    skip(start_step)
                else:
                    for _ in range(start_step):
                        next(data_iter)
            except StopIteration:
                raise ValueError(
                    f"data stream exhausted before the resume point "
                    f"(start_step={start_step}); the stream must cover at "
                    f"least as many batches as the checkpointed run "
                    f"consumed") from None
            log.info("resume: fast-forwarded %d data batches", start_step)

    # cooperative preemption: SIGTERM sets a flag; the loop saves at the
    # next step boundary and returns early
    preempted = threading.Event()
    unsubscribe = None
    if preemption_save:
        from k8s_tpu_torch.util import signals

        unsubscribe = signals.on_shutdown(preempted.set)
    # process 0 only: every process of a gang runs fit, and the path
    # usually lies on the shared checkpoint volume
    from k8s_tpu_torch.launcher.bootstrap import process_index

    metrics = MetricsWriter(metrics_path) \
        if metrics_path and process_index() == 0 else None

    losses = []
    eval_losses = []

    def run_eval(step_no):
        el = float(eval_fn(state))
        eval_losses.append((step_no, el))
        log.info("step %d eval loss %.4f", step_no, el)
        if metrics is not None:
            metrics.write(step_no, eval_loss=el)

    last_ran = None
    try:
        for i in range(start_step, steps):
            batch = next(data_iter)
            state, loss = step_fn(state, batch)
            losses.append(loss)
            last_ran = i
            if log_every and (i + 1) % log_every == 0:
                log.info("step %d loss %.4f", i + 1, float(loss))
            if metrics is not None and (
                    not log_every or (i + 1) % log_every == 0
                    or i + 1 == steps):
                metrics.write(i + 1, loss=float(loss))
            if eval_fn is not None and eval_every \
                    and (i + 1) % eval_every == 0 and (i + 1) != steps:
                run_eval(i + 1)
            if ckpt is not None:
                ckpt.maybe_save(i, state)
            if preempted.is_set():
                log.warning(
                    "preemption: checkpointing step %d and stopping", i)
                break
        if eval_fn is not None and last_ran is not None \
                and not preempted.is_set():
            run_eval(last_ran + 1)  # final held-out number for the run

        if ckpt is not None:
            # final or preemption save, labelled with the last step run; a
            # no-op run (start_step >= steps) saves nothing
            if last_ran is not None and ckpt.latest_step() != last_ran:
                ckpt.save(last_ran, state, force=True)
            ckpt.close()
    finally:
        if unsubscribe is not None:
            unsubscribe()
        if metrics is not None:
            metrics.close()
    return FitResult(
        state=state,
        losses=torch.stack(losses).tolist() if losses else [],
        preempted=preempted.is_set(),
        start_step=start_step,
        eval_losses=eval_losses,
    )


def make_fused_lm_apply_fn(model, *, vocab_chunk: int = 8192,
                           z_loss: float = 0.0, mesh=None):
    """apply_fn computing the LM loss without materializing logits: the
    model returns pre-head hidden states and ``ops.fused_ce`` folds the
    tied-embedding product into a chunked online-softmax loss.  Use with
    ``fused_loss_passthrough`` as the loss_fn.  Over a ``mesh`` the model
    gets it, and with sp > 1 the loss is :func:`make_lm_loss`'s form: the
    chunk's next-token loss over the rows' global count."""
    from k8s_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    if getattr(getattr(model, "config", None), "num_experts", 0) > 0:
        raise ValueError(
            "make_fused_lm_apply_fn does not collect the MoE aux loss; "
            "use make_moe_apply_fn for expert models")

    ring = _sp_ring(mesh)

    def apply_fn(m, tokens):
        hidden = m(tokens, return_hidden=True, mesh=mesh)
        if ring is None:
            # next-token shift, as lm_loss does on logits
            return fused_linear_cross_entropy(
                hidden[:, :-1], m.embedding, tokens[:, 1:],
                vocab_chunk=vocab_chunk, z_loss=z_loss)
        Lc = tokens.shape[1]
        return fused_linear_cross_entropy(
            hidden, m.embedding, sp_next_tokens(tokens, ring),
            vocab_chunk=vocab_chunk, z_loss=z_loss) * (
            Lc / (Lc * ring.size - 1))

    return apply_fn


def fused_loss_passthrough(loss, targets):
    """loss_fn for apply_fns that already computed the scalar loss."""
    return loss
