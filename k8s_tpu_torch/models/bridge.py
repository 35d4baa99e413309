"""Parameters between the reference's flax tree and the port's state dict,
and random parameters drawn directly on the device.

The flax tree (``k8s_tpu/models/transformer.py``), as numpy arrays::

    embedding                          [V, hidden]
    layer_{i}/attn_norm/scale          [hidden]
    layer_{i}/attn/{q,k,v}_proj/kernel [hidden, heads, D]   (DenseGeneral)
    layer_{i}/attn/o_proj/kernel       [heads, D, hidden]
    layer_{i}/mlp_norm/scale           [hidden]
    layer_{i}/mlp/{gate,up}_proj/kernel [hidden, ffn]       (Dense: [in, out])
    layer_{i}/mlp/down_proj/kernel     [ffn, hidden]
    final_norm/scale                   [hidden]

and for MoE configs (``num_experts > 0``) ``layer_{i}/moe_mlp`` in place
of ``layer_{i}/mlp``::

    layer_{i}/moe_mlp/router           [hidden, E]
    layer_{i}/moe_mlp/{w_gate,w_up}    [E, hidden, ffn]
    layer_{i}/moe_mlp/w_down           [E, ffn, hidden]

The state dict is :class:`~k8s_tpu_torch.models.transformer.Transformer`'s:
``torch.nn.Linear`` weights are ``[out, in]``, so each kernel is flattened
over its head axes and transposed.  The MoE tensors keep the reference's
layout (``layers.{i}.moe_mlp.{router,w_gate,w_up,w_down}``).
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_tpu_torch.models.transformer import TransformerConfig
from k8s_tpu_torch.ops._common import resolve_device

_ATTN = ("q_proj", "k_proj", "v_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
_MOE = ("router", "w_gate", "w_up", "w_down")


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":  # numpy's bf16 extension type
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()  # numpy has no bf16 of its own; widening is exact
    return t.numpy()


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The reference's params tree (nested dicts of arrays) as a state dict
    of CPU tensors, dtypes kept."""
    sd = {"embedding": _to_torch(tree["embedding"])}
    n_layers = sum(1 for k in tree if k.startswith("layer_"))
    for i in range(n_layers):
        lt, p = tree[f"layer_{i}"], f"layers.{i}."
        for norm in ("attn_norm", "mlp_norm"):
            sd[p + norm + ".scale"] = _to_torch(lt[norm]["scale"])
        for name in _ATTN:
            kern = np.asarray(lt["attn"][name]["kernel"])
            sd[p + f"attn.{name}.weight"] = _to_torch(
                kern.reshape(kern.shape[0], -1).T)
        kern = np.asarray(lt["attn"]["o_proj"]["kernel"])
        sd[p + "attn.o_proj.weight"] = _to_torch(
            kern.reshape(-1, kern.shape[-1]).T)
        if "moe_mlp" in lt:
            for name in _MOE:
                sd[p + f"moe_mlp.{name}"] = _to_torch(lt["moe_mlp"][name])
        else:
            for name in _MLP:
                sd[p + f"mlp.{name}.weight"] = _to_torch(
                    np.asarray(lt["mlp"][name]["kernel"]).T)
    sd["final_norm.scale"] = _to_torch(tree["final_norm"]["scale"])
    return sd


def params_to_jax(state_dict: dict, config: TransformerConfig) -> dict:
    """Inverse of :func:`params_from_jax`: a state dict as the reference's
    params tree of numpy arrays (bf16 tensors come back as f32)."""
    H, Hkv, D = config.heads, config.kv_heads, config.dims_per_head
    heads = {"q_proj": H, "k_proj": Hkv, "v_proj": Hkv}
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    tree = {"embedding": sd["embedding"],
            "final_norm": {"scale": sd["final_norm.scale"]}}
    for i in range(config.layers):
        p = f"layers.{i}."
        attn = {name: {"kernel": np.ascontiguousarray(
            sd[p + f"attn.{name}.weight"].T.reshape(-1, heads[name], D))}
            for name in _ATTN}
        attn["o_proj"] = {"kernel": np.ascontiguousarray(
            sd[p + "attn.o_proj.weight"].T.reshape(H, D, -1))}
        tree[f"layer_{i}"] = {
            "attn_norm": {"scale": sd[p + "attn_norm.scale"]},
            "attn": attn,
            "mlp_norm": {"scale": sd[p + "mlp_norm.scale"]},
        }
        if p + "moe_mlp.router" in sd:
            tree[f"layer_{i}"]["moe_mlp"] = {
                name: sd[p + f"moe_mlp.{name}"] for name in _MOE}
        else:
            tree[f"layer_{i}"]["mlp"] = {
                name: {"kernel": np.ascontiguousarray(
                    sd[p + f"mlp.{name}.weight"].T)} for name in _MLP}
    return tree


def init_params(config: TransformerConfig, seed: int, device="cuda",
                dtype=None) -> dict[str, torch.Tensor]:
    """Random parameters from ``seed``, each drawn directly on ``device`` in
    ``dtype`` (default ``config.dtype``), so a large model never has an f32
    copy on the host.  Embedding ~ N(0, 0.02); each projection and expert
    stack ~ N(0, 1/fan_in); an MoE router ~ N(0, 0.02), always f32; norm
    scales are f32 ones, as the reference initializes them."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    H, Hkv, D = config.heads, config.kv_heads, config.dims_per_head
    hid, ffn, E = config.hidden, config.ffn_hidden, config.num_experts

    def normal(shape, std, dt=None):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dt or dtype).mul_(std)

    def ones():
        return torch.ones(hid, dtype=torch.float32, device=dev)

    sd = {"embedding": normal((config.vocab_size, hid), 0.02)}
    for i in range(config.layers):
        p = f"layers.{i}."
        sd[p + "attn_norm.scale"] = ones()
        sd[p + "attn.q_proj.weight"] = normal((H * D, hid), hid ** -0.5)
        sd[p + "attn.k_proj.weight"] = normal((Hkv * D, hid), hid ** -0.5)
        sd[p + "attn.v_proj.weight"] = normal((Hkv * D, hid), hid ** -0.5)
        sd[p + "attn.o_proj.weight"] = normal((hid, H * D), (H * D) ** -0.5)
        sd[p + "mlp_norm.scale"] = ones()
        if E > 0:
            sd[p + "moe_mlp.router"] = normal((hid, E), 0.02, torch.float32)
            sd[p + "moe_mlp.w_gate"] = normal((E, hid, ffn), hid ** -0.5)
            sd[p + "moe_mlp.w_up"] = normal((E, hid, ffn), hid ** -0.5)
            sd[p + "moe_mlp.w_down"] = normal((E, ffn, hid), ffn ** -0.5)
            continue
        sd[p + "mlp.gate_proj.weight"] = normal((ffn, hid), hid ** -0.5)
        sd[p + "mlp.up_proj.weight"] = normal((ffn, hid), hid ** -0.5)
        sd[p + "mlp.down_proj.weight"] = normal((hid, ffn), ffn ** -0.5)
    sd["final_norm.scale"] = ones()
    return sd
