"""Training: loss, optimizer, train step and the fit loop, on one device.

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
logs.  Sharded training (``shard_train_state``,
``make_sharded_train_step``) and MoE (``make_moe_apply_fn``) come with the
parallel slice of the port.
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

_PARALLEL = "comes with the parallel slice of the port"


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


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm`` every gradient becomes ``(g / g_norm) * max_norm``.  No
    host sync; returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    div = torch.where(clip, norm, 1.0)
    mul = torch.where(clip, max_norm, 1.0).to(norm.dtype)
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


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
                    optimizer: Optimizer, grad_accum: int = 1) -> Callable:
    """``step(state, batch) -> (state, loss)``: gradients, then the
    optimizer update, in place.  The loss is returned as a device tensor.

    ``grad_accum > 1`` splits the batch into that many microbatches and
    sums their gradients before one update (then divides by
    ``grad_accum``, as the reference does): activation memory of one
    microbatch, the update of the full batch."""

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
        optimizer.update(opt)
        state["step"] += 1
        return state, loss

    return step


def shard_train_state(*args, **kwargs):
    raise NotImplementedError(f"FSDP-sharded train state {_PARALLEL}")


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError(f"the sharded train step {_PARALLEL}")


def make_moe_apply_fn(*args, **kwargs):
    raise NotImplementedError(f"MoE training {_PARALLEL}")


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
                 eval_iter_factory: Callable, *, batches: int = 8):
    """Held-out evaluation for fit(): mean loss over ``batches`` batches of
    a fresh ``eval_iter_factory()`` stream, without gradients."""

    def eval_fn(state) -> float:
        it = eval_iter_factory()
        try:
            total, n = 0.0, 0
            with torch.no_grad():
                for batch in itertools.islice(it, batches):
                    total += float(_combined_loss(apply_fn, loss_fn,
                                                  state["model"], batch))
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
        metrics_path: str = "") -> FitResult:
    """The training loop on one device, with the reference's contract:
    resume from the latest checkpoint under ``checkpoint_dir`` (fast-
    forwarding the data stream), save every ``checkpoint_every`` steps,
    and on SIGTERM (with ``preemption_save``) save at the next step
    boundary and return with ``preempted=True``.  ``eval_fn`` runs every
    ``eval_every`` steps and after the last; ``metrics_path`` appends
    JSONL scalars (every ``log_every``'th step, every step when 0, and the
    last).  The state is updated in place and returned in the result.
    The reference's ``mesh`` and prebuilt ``step_fn`` (the pipeline
    schedule) come with the parallel slice of the port."""
    step_fn = make_train_step(apply_fn, loss_fn, optimizer,
                              grad_accum=grad_accum)

    ckpt = None
    start_step = 0
    if checkpoint_dir:
        from k8s_tpu_torch.models.checkpoint import Checkpointer

        ckpt = Checkpointer(checkpoint_dir,
                            save_interval_steps=checkpoint_every)
        state, start_step = ckpt.restore_or_init(state)
        if start_step > 0:
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
    metrics = MetricsWriter(metrics_path) if metrics_path else None

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
                           z_loss: float = 0.0):
    """apply_fn computing the LM loss without materializing logits: the
    model returns pre-head hidden states and ``ops.fused_ce`` folds the
    tied-embedding product into a chunked online-softmax loss.  Use with
    ``fused_loss_passthrough`` as the loss_fn."""
    from k8s_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    if getattr(getattr(model, "config", None), "num_experts", 0) > 0:
        raise ValueError(
            "make_fused_lm_apply_fn does not collect the MoE aux loss; "
            "use make_moe_apply_fn for expert models")

    def apply_fn(m, tokens):
        hidden = m(tokens, return_hidden=True)
        # next-token shift, as lm_loss does on logits
        return fused_linear_cross_entropy(
            hidden[:, :-1], m.embedding, tokens[:, 1:],
            vocab_chunk=vocab_chunk, z_loss=z_loss)

    return apply_fn


def fused_loss_passthrough(loss, targets):
    """loss_fn for apply_fns that already computed the scalar loss."""
    return loss
