"""The reference's reading of served requests: one teacher-forced pass
over each prompt and the tokens served for it, layer by layer, each
layer's weights made again from the seed in the type they were served in
and upcast to float32 as the layer runs.

For every served token it gives the gap by which the token's logit lies
below the reference's best at that position (0 where the token is the
reference's argmax).  The control runs the same pass in fp8 and reads,
at each position, the gap of the token the lower precision puts first.
"""

from __future__ import annotations

import torch

from portbench import common
from portbench.reference import model as ref


@torch.no_grad()
def logits_at_served(spec, seed: int, seqs: list, device, served_dtype,
                     precision: str = "f32") -> list:
    """``seqs``: ``(prompt ids, served ids)`` pairs.  Returns, per
    sequence, the f32 logits ``[n_served, vocab]`` at the positions that
    produced each served token."""
    ref.exact_f32()
    emb = common.embedding(spec, seed, device, served_dtype).float()
    hs = []
    for prompt, served in seqs:
        ids = torch.as_tensor(list(prompt) + list(served[:-1]),
                              device=device).long()
        hs.append(emb[ids][None])
    for i in range(spec.layers):
        w = {n: t.float() for n, t in common.layer_params(
            spec, seed, i, device, served_dtype).items()}
        for j, h in enumerate(hs):
            pos = torch.arange(h.shape[1], device=device)
            hs[j] = ref.layer(h, w, spec, pos, precision)
        del w
    final = torch.ones(spec.hidden, device=device)
    out = []
    for (prompt, _), h in zip(seqs, hs):
        out.append(ref.head(h[0, len(prompt) - 1:], final, emb, spec,
                            precision))
    return out


def served_gaps(ref_logits: list, seqs: list) -> list:
    """Per sequence, the gap of each served token below the best logit."""
    out = []
    for lg, (_, served) in zip(ref_logits, seqs):
        tok = torch.as_tensor(served, device=lg.device).long()
        out.append((lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0])
                   .tolist())
    return out


def control_gaps(ref_logits: list, low_logits: list) -> list:
    """Per sequence, at each position, the gap of the token the lower
    precision ranks first."""
    out = []
    for lg, low in zip(ref_logits, low_logits):
        pick = low.argmax(-1)
        out.append((lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0])
                   .tolist())
    return out
