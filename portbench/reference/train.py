"""The reference's first training steps: the same weights (made again from
the seed), the same rows, next-token cross entropy over every position
but the last, and Adam written out (b1 0.9, b2 0.999, eps 1e-8, bias
corrected), in float32 with each layer recomputed in the backward.

It returns what the check compares: each step's loss, each leaf's
gradient norm at step 1 and each leaf's change after the last step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench import common
from portbench.reference import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


def _leaves(spec, seed, device) -> dict:
    """Every trainable leaf, in the port's state-dict names, f32, each its
    own tensor."""
    out = {"embedding": common.embedding(spec, seed, device,
                                         torch.float32).clone()}
    for i in range(spec.layers):
        for n, t in common.layer_params(spec, seed, i, device,
                                        torch.float32).items():
            out[f"layers.{i}.{n}"] = t.clone()
    out["final_norm.scale"] = torch.ones(spec.hidden, device=device)
    return out


def loss_fn(p, tokens, spec, precision, half_batch=False):
    """Mean next-token cross entropy of ``tokens`` [B, L]; with
    ``half_batch`` (a planted fault) the second half of the rows is left
    out and the mean taken over the rest."""
    if half_batch:
        tokens = tokens[:tokens.shape[0] // 2]
    B, L = tokens.shape
    pos = torch.arange(L, device=tokens.device)
    h = p["embedding"][tokens]
    for i in range(spec.layers):
        pre = f"layers.{i}."
        names = [n for n in p if n.startswith(pre)]

        def block(h, *ws, names=names, pre=pre):
            w = {n[len(pre):]: t for n, t in zip(names, ws)}
            return ref.layer(h, w, spec, pos, precision)

        h = torch.utils.checkpoint.checkpoint(
            block, h, *[p[n] for n in names], use_reentrant=False)
    logits = ref.head(h, p["final_norm.scale"], p["embedding"], spec,
                      precision)
    return F.cross_entropy(logits[:, :-1].reshape(-1, spec.vocab),
                           tokens[:, 1:].reshape(-1))


def run_steps(spec, seed: int, batches: list, lr: float, device,
              precision: str = "f32", fault: str = "") -> dict:
    """``len(batches)`` steps from the seed's weights.  ``fault`` plants
    one for the checks' own tests: ``"half_batch"`` or ``"frozen"`` (the
    update left out)."""
    ref.exact_f32()
    p = _leaves(spec, seed, device)
    for t in p.values():
        t.requires_grad_(True)
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grad_norms = [], {}
    for step, rows in enumerate(batches, start=1):
        tokens = torch.as_tensor(rows, device=device).long()
        loss = loss_fn(p, tokens, spec, precision,
                       half_batch=fault == "half_batch")
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 1:
                grad_norms = {n: float(t.grad.norm()) for n, t in p.items()}
            for n, t in p.items():
                g = t.grad
                m[n].mul_(B1).add_(g, alpha=1 - B1)
                v[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                if fault != "frozen":
                    mh = m[n] / (1 - B1 ** step)
                    vh = v[n] / (1 - B2 ** step)
                    t.sub_(lr * mh / (vh.sqrt() + EPS))
                t.grad = None
    del m, v
    with torch.no_grad():
        change = change_norms(spec, seed, {n: t.detach()
                                           for n, t in p.items()})
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def change_norms(spec, seed: int, params: dict) -> dict:
    """Each leaf's distance from the seed's weights, made again one group
    at a time."""
    ref_dev = params["embedding"].device
    out = {"embedding": float((params["embedding"].float() - common.embedding(
        spec, seed, ref_dev, torch.float32)).norm())}
    for i in range(spec.layers):
        w0 = common.layer_params(spec, seed, i, ref_dev, torch.float32)
        for n, t in w0.items():
            name = f"layers.{i}.{n}"
            out[name] = float((params[name].float() - t).norm())
        del w0
    out["final_norm.scale"] = float((params["final_norm.scale"].float()
                                     - 1.0).norm())
    return out
