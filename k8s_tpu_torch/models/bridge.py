"""Parameters between the reference's flax trees and the port's state
dicts, and random LM parameters drawn directly on the device.  The LM's
mapping comes first; the vision models' (ResNet, ViT, the MNIST CNN) are
at the end of the module.

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


def _block_from_jax(lt, p: str, sd: dict) -> None:
    """One encoder/decoder block's flax subtree into ``sd`` under the
    state-dict prefix ``p`` (``layers.{i}.``)."""
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


def _n_layers(tree) -> int:
    return sum(1 for k in tree if k.startswith("layer_"))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The reference's params tree (nested dicts of arrays) as a state dict
    of CPU tensors, dtypes kept."""
    sd = {"embedding": _to_torch(tree["embedding"])}
    for i in range(_n_layers(tree)):
        _block_from_jax(tree[f"layer_{i}"], f"layers.{i}.", sd)
    sd["final_norm.scale"] = _to_torch(tree["final_norm"]["scale"])
    return sd


def _block_to_jax(sd: dict, p: str, heads: int, kv_heads: int,
                  head_dim: int) -> dict:
    """Inverse of :func:`_block_from_jax` over a state dict of numpy
    arrays."""
    per = {"q_proj": heads, "k_proj": kv_heads, "v_proj": kv_heads}
    attn = {name: {"kernel": np.ascontiguousarray(
        sd[p + f"attn.{name}.weight"].T.reshape(-1, per[name], head_dim))}
        for name in _ATTN}
    attn["o_proj"] = {"kernel": np.ascontiguousarray(
        sd[p + "attn.o_proj.weight"].T.reshape(heads, head_dim, -1))}
    block = {"attn_norm": {"scale": sd[p + "attn_norm.scale"]},
             "attn": attn,
             "mlp_norm": {"scale": sd[p + "mlp_norm.scale"]}}
    if p + "moe_mlp.router" in sd:
        block["moe_mlp"] = {name: sd[p + f"moe_mlp.{name}"] for name in _MOE}
    else:
        block["mlp"] = {name: {"kernel": np.ascontiguousarray(
            sd[p + f"mlp.{name}.weight"].T)} for name in _MLP}
    return block


def params_to_jax(state_dict: dict, config: TransformerConfig) -> dict:
    """Inverse of :func:`params_from_jax`: a state dict as the reference's
    params tree of numpy arrays (bf16 tensors come back as f32)."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    tree = {"embedding": sd["embedding"],
            "final_norm": {"scale": sd["final_norm.scale"]}}
    for i in range(config.layers):
        tree[f"layer_{i}"] = _block_to_jax(
            sd, f"layers.{i}.", config.heads, config.kv_heads,
            config.dims_per_head)
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


# -- vision models ----------------------------------------------------------
#
# flax kernels: Conv [kh, kw, in, out] (torch Conv2d [out, in, kh, kw]),
# Dense [in, out] (torch Linear [out, in]); biases as they are.


def _layer_from_jax(leaf, p: str, sd: dict) -> None:
    """A flax Conv or Dense (``kernel`` and maybe ``bias``) into ``sd``
    as ``{p}weight`` / ``{p}bias``."""
    kern = np.asarray(leaf["kernel"])
    sd[p + "weight"] = _to_torch(
        kern.transpose(3, 2, 0, 1) if kern.ndim == 4 else kern.T)
    if "bias" in leaf:
        sd[p + "bias"] = _to_torch(leaf["bias"])


def _layer_to_jax(sd: dict, p: str) -> dict:
    w = sd[p + "weight"]
    leaf = {"kernel": np.ascontiguousarray(
        w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T)}
    if p + "bias" in sd:
        leaf["bias"] = sd[p + "bias"]
    return leaf


def resnet_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """The reference ResNet's ``params`` and ``batch_stats`` trees as a
    state dict of :class:`~k8s_tpu_torch.models.resnet.ResNet`: convs
    ``conv_init`` and ``stage{i}_block{j}/{conv1,conv2,conv3,conv_proj}``
    (under ``blocks.``), BatchNorm ``bn_*`` with ``scale`` / ``bias`` from
    ``params`` and ``mean`` / ``var`` from ``batch_stats``, the dense
    ``head``."""
    sd: dict = {}

    def walk(ptree, stree, prefix):
        for name, leaf in ptree.items():
            p = prefix + name + "."
            if name.startswith("stage"):
                walk(leaf, stree[name], "blocks." + p)
            elif name.startswith("bn"):
                for key in ("scale", "bias"):
                    sd[p + key] = _to_torch(leaf[key])
                for key in ("mean", "var"):
                    sd[p + key] = _to_torch(stree[name][key])
            else:  # conv_* and the head
                _layer_from_jax(leaf, p, sd)
    walk(params, batch_stats, "")
    return sd


def _subtree(tree: dict, path) -> dict:
    for part in path:
        tree = tree.setdefault(part, {})
    return tree


def resnet_to_jax(state_dict: dict) -> tuple[dict, dict]:
    """Inverse of :func:`resnet_from_jax`: ``(params, batch_stats)`` trees
    of numpy arrays."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}
    for key in sd:
        module, leaf = key.rsplit(".", 1)
        path = module.split(".")
        if path[0] == "blocks":
            path = path[1:]
        if path[-1].startswith("bn"):
            tree = stats if leaf in ("mean", "var") else params
            _subtree(tree, path)[leaf] = sd[key]
        elif leaf == "weight":  # a conv or the head, bias and all
            _subtree(params, path[:-1])[path[-1]] = _layer_to_jax(
                sd, module + ".")
    return params, stats


def mnist_from_jax(params) -> dict[str, torch.Tensor]:
    """The reference ``MnistCNN``'s params (``Conv_0``, ``Conv_1``,
    ``Dense_0``, ``Dense_1``) as :class:`~k8s_tpu_torch.models.mnist.
    MnistCNN`'s state dict.  ``Dense_0``'s rows stay in the reference's
    (h, w, c) flatten order: the port flattens NHWC too."""
    sd: dict = {}
    for name, leaf in params.items():
        _layer_from_jax(leaf, name.lower() + ".", sd)
    return sd


def mnist_to_jax(state_dict: dict) -> dict:
    """Inverse of :func:`mnist_from_jax`."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    return {name: _layer_to_jax(sd, name.lower() + ".")
            for name in ("Conv_0", "Conv_1", "Dense_0", "Dense_1")}


def vit_from_jax(params) -> dict[str, torch.Tensor]:
    """The reference ViT's params (``patch_embed``, ``cls_token``,
    ``pos_embedding``, ``layer_{i}``, ``final_norm``, ``head``) as
    :class:`~k8s_tpu_torch.models.vit.ViT`'s state dict; each layer maps
    as the LM's blocks do."""
    sd: dict = {}
    _layer_from_jax(params["patch_embed"], "patch_embed.", sd)
    for name in ("cls_token", "pos_embedding"):
        sd[name] = _to_torch(params[name])
    for i in range(_n_layers(params)):
        _block_from_jax(params[f"layer_{i}"], f"layers.{i}.", sd)
    sd["final_norm.scale"] = _to_torch(params["final_norm"]["scale"])
    _layer_from_jax(params["head"], "head.", sd)
    return sd


def vit_to_jax(state_dict: dict, config) -> dict:
    """Inverse of :func:`vit_from_jax` for a ``ViTConfig``."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    tree = {"patch_embed": _layer_to_jax(sd, "patch_embed."),
            "cls_token": sd["cls_token"],
            "pos_embedding": sd["pos_embedding"],
            "final_norm": {"scale": sd["final_norm.scale"]},
            "head": _layer_to_jax(sd, "head.")}
    head_dim = config.hidden // config.heads
    for i in range(config.layers):
        tree[f"layer_{i}"] = _block_to_jax(sd, f"layers.{i}.", config.heads,
                                           config.heads, head_dim)
    return tree
