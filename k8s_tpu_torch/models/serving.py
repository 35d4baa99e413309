"""Serving artifacts: ``<train_dir>/serving/`` holds ``model_config.json``
(the TransformerConfig with its dtype by name — the reference's schema,
so the reference's file loads as is) and the port's params file
``params.pt`` (a ``torch.save``d state dict).

Port of ``k8s_tpu/models/serving.py``.  Reading the reference's orbax
params checkpoint needs JAX; that converter lives outside this package.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from k8s_tpu_torch.models.transformer import TransformerConfig
from k8s_tpu_torch.ops._common import resolve_device

CONFIG_FILE = "model_config.json"
PARAMS_FILE = "params.pt"
_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def export_serving(train_dir: str, config: TransformerConfig,
                   params: dict) -> str:
    """Write the serving artifact; returns the serving directory path."""
    if not config.causal:
        raise ValueError(
            "serving artifacts are for causal LMs: decode-mode attention "
            "is causal by construction, so a bidirectional (causal=False) "
            "model would serve silently wrong")
    d = os.path.join(train_dir, "serving")
    os.makedirs(d, exist_ok=True)
    # the sp ring is a training-scale composition; params are the same
    config = dataclasses.replace(config, use_ring_attention=False)
    if config.dtype not in _DTYPE_NAMES:
        raise ValueError(f"unserializable dtype {config.dtype!r}")
    cfg = dataclasses.asdict(config)
    cfg["dtype"] = _DTYPE_NAMES[config.dtype]
    tmp = os.path.join(d, CONFIG_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(cfg, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, os.path.join(d, CONFIG_FILE))
    tmp = os.path.join(d, PARAMS_FILE + ".tmp")
    torch.save({k: v.detach().cpu() for k, v in params.items()}, tmp)
    os.replace(tmp, os.path.join(d, PARAMS_FILE))
    return d


def load_config(train_dir: str) -> TransformerConfig:
    """The artifact's ``model_config.json`` (written by either package)."""
    path = os.path.join(train_dir, "serving", CONFIG_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no serving artifact at {path}")
    with open(path) as f:
        cfg_dict = json.load(f)
    cfg_dict["dtype"] = _DTYPES[cfg_dict["dtype"]]
    return TransformerConfig(**cfg_dict)


def load_serving(train_dir: str, device="cuda"
                 ) -> tuple[TransformerConfig, dict]:
    """Reconstruct ``(config, params)`` from a serving artifact, with the
    params on ``device``."""
    config = load_config(train_dir)
    d = os.path.join(train_dir, "serving")
    ppath = os.path.join(d, PARAMS_FILE)
    if not os.path.exists(ppath):
        raise FileNotFoundError(
            f"no {PARAMS_FILE} at {d}: an export written by the JAX "
            "package holds orbax params, which need converting first")
    params = torch.load(ppath, map_location=resolve_device(device),
                        weights_only=True)
    return config, params


def load_for_serving(train_dir: str, kv_cache: str = "model",
                     param_dtype: str = "model", device="cuda"):
    """Artifact load plus the serving overrides: returns ``(config,
    params)`` with ``kv_cache="int8"`` / ``param_dtype="bfloat16"``
    applied."""
    config, params = load_serving(train_dir, device=device)
    if kv_cache == "int8":
        config = dataclasses.replace(config, kv_cache_dtype="int8")
    elif kv_cache != "model":
        raise ValueError(
            f"kv_cache must be 'model' or 'int8', got {kv_cache!r}")
    if param_dtype == "bfloat16":
        params = cast_params_for_serving(params)
    elif param_dtype != "model":
        raise ValueError(
            f"param_dtype must be 'model' or 'bfloat16', got {param_dtype!r}")
    return config, params


def strip_after_eos(toks, eos_id):
    """Rendered output: drop the EOS token and the pad tail after it."""
    toks = list(toks)
    if eos_id is not None and eos_id in toks:
        toks = toks[:toks.index(eos_id)]
    return toks


def cast_params_for_serving(params: dict) -> dict:
    """f32 -> bf16 for every f32 tensor, norm scales included (decode
    re-reads every param per token, so at f32 they dominate HBM traffic);
    other tensors pass through untouched."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}
