"""A decoder written plainly: RMSNorm, split-half RoPE, causal (optionally
windowed) grouped-query attention, a SwiGLU MLP or a dropless top-k
mixture of SwiGLU experts, and a tied head.  Float32 throughout.

``precision="fp8"`` is the control: every product of the projections,
the experts and the head takes operands rounded to float8 e4m3 (a scale
per row of the left operand and per column of the right one, along the
contracted axis), the step below the bf16 the configurations state.  In
training the rounding passes the gradient straight through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3 value
QUERY_BLOCK = 512


def exact_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim``, the gradient passed straight through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (``a`` [..., K], ``b`` [K, N]) in float32, or with both
    operands rounded to fp8 along K."""
    if precision == "fp8":
        a, b = _fp8(a, -1), _fp8(b, 0)
    elif precision != "f32":
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return a @ b


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """Split-half rotary embedding of ``x`` [..., T, H, D] at
    ``positions`` [T]."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = positions.float()[:, None] * freqs  # [T, D/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window):
    """Causal attention of one sequence per row: ``q`` [B, T, H, D],
    ``k``/``v`` [B, T, Hk, D], keys kept where ``0 <= q - k < window``
    (no window: every earlier key).  Queries in blocks, so the scores of
    a block are all that is held."""
    B, T, H, D = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    outs = []
    for lo in range(0, T, QUERY_BLOCK):
        hi = min(T, lo + QUERY_BLOCK)
        klo = 0 if window is None else max(0, lo - window + 1)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:hi], k[:, klo:hi])
        s = s * D ** -0.5
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(klo, hi, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
        s = s.masked_fill(~keep, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                 v[:, klo:hi]))
    return torch.cat(outs, dim=1)


def moe(x, w, spec, precision):
    """Dropless top-k routing of ``x`` [N, d]: softmax over the router's
    f32 logits, the top k renormalized, each expert applied to the tokens
    routed to it."""
    probs = torch.softmax(x @ w["moe_mlp.router"], dim=-1)
    top, idx = probs.topk(spec.top_k, dim=-1)
    gates = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x)
    for e in range(spec.experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = mm(F.silu(mm(xe, w["moe_mlp.w_gate"][e], precision))
               * mm(xe, w["moe_mlp.w_up"][e], precision),
               w["moe_mlp.w_down"][e], precision)
        out = out.index_add(0, rows, y * gates[rows, slot, None])
    return out


def layer(h, w, spec, positions, precision):
    """One block over ``h`` [B, T, d]: attention and the MLP (or the
    experts), each behind an RMSNorm and a residual.  ``w`` holds the
    layer's weights in the port's names (``nn.Linear`` layout [out, in])."""
    B, T, d = h.shape
    D = spec.head_dim
    x = rms_norm(h, w["attn_norm.scale"], spec.eps)
    q = mm(x, w["attn.q_proj.weight"].T, precision).view(B, T, -1, D)
    k = mm(x, w["attn.k_proj.weight"].T, precision).view(B, T, -1, D)
    v = mm(x, w["attn.v_proj.weight"].T, precision).view(B, T, -1, D)
    q = rope(q, positions, spec.rope_theta)
    k = rope(k, positions, spec.rope_theta)
    a = attention(q, k, v, spec.window).reshape(B, T, -1)
    h = h + mm(a, w["attn.o_proj.weight"].T, precision)
    x = rms_norm(h, w["mlp_norm.scale"], spec.eps)
    if spec.experts:
        return h + moe(x.reshape(B * T, d), w, spec, precision).view(B, T, d)
    g = mm(x, w["mlp.gate_proj.weight"].T, precision)
    u = mm(x, w["mlp.up_proj.weight"].T, precision)
    return h + mm(F.silu(g) * u, w["mlp.down_proj.weight"].T, precision)


def head(h, final_scale, emb, spec, precision):
    """Logits of the tied head over the final norm of ``h``."""
    return mm(rms_norm(h, final_scale, spec.eps), emb.T, precision)
