"""The yardstick's arithmetic: the chip's peaks and the operations and
bytes that the work needs, counted from shapes.

Model FLOPs count the work the model needs, not what an implementation
does: no recomputation, the top-k experts a token is routed to (not all
of them), the pairs of a causal or windowed mask (not the full square),
and the tied head only where its logits are used.
"""

from __future__ import annotations

from typing import Optional

# the data sheet's dense peaks, chosen by the name torch gives the card
PEAKS = (
    ("h100 80gb hbm3", {"flops": 989e12, "bytes_per_s": 3.35e12}),
)


def peaks_for(device_name: str) -> Optional[dict]:
    """``{"flops", "bytes_per_s"}`` for a card this table knows."""
    low = (device_name or "").lower()
    for key, peak in PEAKS:
        if key in low:
            return peak
    return None


def roofline_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory's rate."""
    return max(flops / peak["flops"], nbytes / peak["bytes_per_s"])


def attended_pairs(start: int, n: int, window: Optional[int] = None) -> int:
    """(query, key) pairs of ``n`` queries at positions ``start`` ..
    ``start + n - 1`` under a causal mask, and a window of ``window``
    keys (``0 <= q - k < window``) when one is given."""
    def upto(m):  # sum over q < m of min(q + 1, window)
        if window is None or m <= window:
            return m * (m + 1) // 2
        return window * (window + 1) // 2 + (m - window) * window

    return upto(start + n) - upto(start)


def layer_matmul_params(spec, active: bool = True) -> int:
    """Parameters of one layer that take part in products: the four
    attention projections and the MLP, or the router and, with
    ``active``, the top-k experts a token reaches (all experts without
    it)."""
    d, f, D = spec.hidden, spec.ffn, spec.head_dim
    attn = d * spec.heads * D * 2 + d * spec.kv_heads * D * 2
    if spec.experts:
        n = spec.top_k if active else spec.experts
        return attn + d * spec.experts + n * 3 * d * f
    return attn + 3 * d * f


def head_params(spec) -> int:
    return spec.vocab * spec.hidden


def train_step_flops(spec, batch: int, seq_len: int) -> float:
    """One training step's model FLOPs: 6 per parameter and token for the
    layers and the tied head, and attention's 12·D per head and attended
    pair (forward 4, backward 8), without recomputation."""
    tokens = batch * seq_len
    dense = 6 * (spec.layers * layer_matmul_params(spec)
                 + head_params(spec)) * tokens
    attn = 12 * spec.heads * spec.head_dim * spec.layers * batch \
        * attended_pairs(0, seq_len, spec.window)
    return float(dense + attn)


def serve_request_flops(spec, prompt_len: int, new_tokens: int) -> float:
    """A served request's model FLOPs: 2 per active parameter for each
    token the layers process (the prompt and every generated token but
    the last), the head for each generated token, and attention's 4·D
    per head and attended pair."""
    body = prompt_len + new_tokens - 1
    pairs = attended_pairs(0, body, spec.window)
    return float(2 * spec.layers * layer_matmul_params(spec) * body
                 + 2 * head_params(spec) * new_tokens
                 + 4 * spec.heads * spec.head_dim * spec.layers * pairs)


def attention_train_work(batch: int, seq_len: int, heads: int,
                         kv_heads: int, head_dim: int,
                         window: Optional[int], elem_bytes: int = 2
                         ) -> tuple[float, float]:
    """(operations, bytes) of attention's forward and backward at one
    shape: 12·D per head and attended pair; q, o, dO and dQ at the query
    heads, k, v, dK and dV at the kv heads, each read or written once,
    and the f32 log-sum-exp written and read once."""
    pairs = batch * attended_pairs(0, seq_len, window)
    flops = 12 * heads * head_dim * pairs
    rows = batch * seq_len * head_dim * elem_bytes
    nbytes = 4 * rows * heads + 4 * rows * kv_heads \
        + 2 * 4 * batch * heads * seq_len
    return float(flops), float(nbytes)


def moe_call_work(tokens: int, spec, experts_hit: int, elem_bytes: int = 2
                  ) -> tuple[float, float]:
    """(operations, bytes) of one MoE layer call over ``tokens`` tokens:
    the f32 router, and the k routed (token, expert) pairs through the
    three expert products; the weights of every expert that receives a
    token read once, the tokens read and the output written once."""
    d, f, E, k = spec.hidden, spec.ffn, spec.experts, spec.top_k
    flops = 2 * tokens * d * E + 6 * k * tokens * d * f
    nbytes = experts_hit * 3 * d * f * elem_bytes + d * E * 4 \
        + 2 * tokens * d * elem_bytes
    return float(flops), float(nbytes)
