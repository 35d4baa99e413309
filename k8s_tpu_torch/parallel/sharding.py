"""Sharding rules: logical parameter axes onto mesh axes, applied with
FSDP2 (``torch.distributed.fsdp.fully_shard``).

Port of ``k8s_tpu/parallel/sharding.py``.  The spec functions are
pure functions of names and shapes and return the reference's
PartitionSpecs as tuples (``(None, "fsdp")`` for ``P(None, "fsdp")``):
a parameter shards its largest dimension divisible by the fsdp size,
else it is replicated.  :func:`placement_fn` turns a spec into the
``shard_placement_fn`` FSDP2 takes: the fsdp dimension becomes
``Shard(dim)``.  FSDP2 holds every parameter it manages as a shard, so a
replicated spec keeps FSDP2's default ``Shard(0)`` (padded where the
size does not divide): the gathered parameter and the reduced gradient
are the same, only where its bytes rest differs.

The serving tensor-parallel specs (:func:`serve_tp_spec`,
:func:`serve_pool_spec`, :func:`check_serve_tp_config`) are the
reference's Megatron split written in the port's state-dict layout, and
:func:`shard_serve_params` cuts a tp rank's shard out of a state dict, as
the reference's ``MeshPrograms.globalize`` places each device's part
(models/mesh_serve.py serves over them).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from k8s_tpu_torch.parallel.mesh import mesh_shape

# logical axis -> preferred mesh axis
DEFAULT_RULES: dict[str, Optional[str]] = {
    "batch": "dp",
    "seq": "sp",
    "embed": None,      # hidden dim stays unsharded in params
    "mlp": "tp",
    "heads": "tp",
    "kv": None,
    "vocab": "tp",
    "conv_out": "tp",
}


def logical_to_spec(logical_axes: tuple, rules: Optional[dict] = None,
                    fsdp_axis: str = "fsdp",
                    shape: Optional[tuple] = None,
                    fsdp_size: Optional[int] = None) -> tuple:
    """Map logical axis names to a spec.  After the rule table, one
    still-unsharded named dimension shards over ``fsdp``: with ``shape``
    the largest one divisible by ``fsdp_size`` (none: replicated), else
    the first named candidate."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    spec: list = [rules.get(a) if a else None for a in logical_axes]
    if fsdp_axis and fsdp_axis not in spec:
        candidates = [i for i, (axis, assigned)
                      in enumerate(zip(logical_axes, spec))
                      if assigned is None and axis is not None]
        if candidates:
            if shape is not None and len(shape) == len(logical_axes):
                if fsdp_size:
                    candidates = [i for i in candidates
                                  if shape[i] % fsdp_size == 0
                                  and shape[i] >= fsdp_size]
                best = max(candidates, key=lambda i: shape[i], default=None)
            else:
                best = candidates[0]
            if best is not None:
                spec[best] = fsdp_axis
    return tuple(spec)


def fsdp_spec(shape: tuple, fsdp_size: int) -> tuple:
    """The FSDP rule on one shape: a >=2-D weight shards its largest
    dimension divisible by ``fsdp_size`` (the first on a tie); anything
    else is replicated (``()``)."""
    shape = tuple(shape)
    if len(shape) >= 2:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
                spec = [None] * len(shape)
                spec[i] = "fsdp"
                return tuple(spec)
    return ()


def _fsdp_size(mesh) -> int:
    sizes = mesh if isinstance(mesh, Mapping) else mesh_shape(mesh)
    return sizes["fsdp"]


def fsdp_sharding(params: Mapping, mesh, rules=()) -> dict:
    """``{name: spec}`` of :func:`fsdp_spec` for each tensor of
    ``params``; ``mesh`` is a ``DeviceMesh`` or a ``{axis: size}``
    mapping.  ``rules``: param-path rules (``rule(name, mesh)`` -> a
    leading spec or None, e.g. ``models.moe.expert_sharding_rule``); the
    first that names a parameter places its leading dims, and the fsdp
    rule the rest (a local expert stack ``[E/ep, d, f]``: ``("ep", None,
    "fsdp")``)."""
    n = _fsdp_size(mesh)
    out = {}
    for name, t in params.items():
        shape = tuple(t.shape)
        lead = next((spec for spec in (r(name, mesh) for r in rules)
                     if spec), ())
        rest = fsdp_spec(shape[len(lead):], n)
        out[name] = tuple(lead) + (rest or (None,) * (len(shape) - len(lead))
                                   if lead else rest)
    return out


def infer_logical_axes(params: Mapping) -> dict:
    """Size heuristic for parameters without annotations: a >=2-D weight
    names its largest dimension ``fsdp_dim``; 1-D ones name nothing."""
    out = {}
    for name, t in params.items():
        shape = tuple(t.shape)
        if len(shape) < 2:
            out[name] = (None,) * len(shape)
        else:
            largest = int(np.argmax(shape))
            out[name] = tuple("fsdp_dim" if i == largest else None
                              for i in range(len(shape)))
    return out


def fsdp_mesh(mesh):
    """The mesh FSDP2 takes: the 1-D ``fsdp`` sub-mesh, or the 2-D
    (``dp``, ``fsdp``) one when dp > 1 (HSDP: replicated over dp, sharded
    over fsdp, as the reference's hybrid mesh places parameters)."""
    if mesh_shape(mesh)["dp"] > 1:
        return mesh["dp", "fsdp"]
    return mesh["fsdp"]


def placement_fn(specs_by_param: Mapping):
    """FSDP2's ``shard_placement_fn`` for ``{parameter: spec}``: the
    spec's fsdp dimension as ``Shard(dim)``; None (FSDP2's default
    ``Shard(0)``) for a replicated spec."""
    from torch.distributed.tensor import Shard

    def fn(param):
        spec = specs_by_param.get(param, ())
        return Shard(spec.index("fsdp")) if "fsdp" in spec else None

    return fn


def apply_fsdp(module, specs: Mapping, mesh):
    """FSDP2 over ``module``, in place: ``fully_shard`` on each block of
    ``module.layers`` (when it has them), then on the root, each
    parameter placed by its spec in ``specs`` (``{name: spec}``)."""
    from torch.distributed.fsdp import fully_shard

    params = dict(module.named_parameters())
    for p in params.values():  # FSDP2 shards contiguous parameters only
        if not p.is_contiguous():
            p.data = p.data.contiguous()
    place = placement_fn({p: specs[n] for n, p in params.items()})
    sub = fsdp_mesh(mesh)
    for block in getattr(module, "layers", ()):
        fully_shard(block, mesh=sub, shard_placement_fn=place)
    fully_shard(module, mesh=sub, shard_placement_fn=place)
    return module


def shard_params(module, logical_axes: Mapping, mesh,
                 rules: Optional[dict] = None):
    """FSDP2 over ``module`` with each parameter placed by
    :func:`logical_to_spec` on its logical axes (``{name: axes}``);
    returns the module, now sharded in place."""
    n = _fsdp_size(mesh)
    return apply_fsdp(module, {
        name: logical_to_spec(logical_axes[name], rules,
                              shape=tuple(p.shape), fsdp_size=n)
        for name, p in module.named_parameters()}, mesh)


# -- serving tp ---------------------------------------------------------------


def serve_tp_spec(name: str, shape) -> tuple:
    """Tensor-parallel spec of one served-transformer tensor, keyed on its
    state-dict name: the Megatron split.  ``q/k/v_proj.weight`` ``[heads
    * D, hidden]`` and ``gate/up_proj.weight`` ``[ffn, hidden]`` shard dim
    0 (contiguous head or ffn blocks), ``o_proj.weight`` ``[hidden, heads
    * D]`` and ``down_proj.weight`` ``[hidden, ffn]`` shard dim 1 (their
    products are per-rank partial sums, summed over tp after each), and
    everything on the replicated hidden stream (the embedding, the norm
    scales) is replicated (``()``).  The embedding stays whole on every
    rank: the tied head multiplies a replicated hidden, and a decode
    step's activations are ``[B, 1, ...]``, so replication costs memory
    where sharding would cost a collective per token."""
    ndim = len(tuple(shape))
    if ndim != 2:
        return ()
    leaf = name.rsplit(".", 2)
    proj = leaf[-2] if len(leaf) >= 2 and leaf[-1] == "weight" else ""
    if proj in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        return ("tp", None)
    if proj in ("o_proj", "down_proj"):
        return (None, "tp")
    return ()


def serve_tp_param_specs(params: Mapping) -> dict:
    """``{name: spec}`` of :func:`serve_tp_spec` for a served
    transformer's state dict."""
    return {name: serve_tp_spec(name, t.shape) for name, t in params.items()}


def serve_pool_spec(shape) -> tuple:
    """Spec of one KV block-pool leaf: the kv-head axis is the tp axis,
    so each rank holds its head slice of every block and the same block
    tables address every rank's slice.  ``[N, bs, kv_heads, D]`` K/V
    leaves and ``[N, bs, kv_heads]`` int8 scale leaves both shard dim 2;
    anything else replicates."""
    ndim = len(tuple(shape))
    if ndim == 4:
        return (None, None, "tp", None)
    if ndim == 3:
        return (None, None, "tp")
    return ()


def serve_pool_specs(pool) -> list:
    """The spec of every leaf of the engine's pool (a list of per-layer
    dicts of tensors), in its structure."""
    return [{k: serve_pool_spec(v.shape) for k, v in node.items()}
            for node in pool]


def check_serve_tp_config(config, tp: int) -> None:
    """The divisibility contract serving tensor parallelism needs: every
    sharded dimension must split evenly over ``tp`` or a rank would hold
    a ragged slice."""
    problems = []
    if config.heads % tp:
        problems.append(f"heads {config.heads} % tp {tp}")
    if config.kv_heads % tp:
        problems.append(f"kv_heads {config.kv_heads} % tp {tp}")
    if config.ffn_hidden % tp:
        problems.append(f"ffn_hidden {config.ffn_hidden} % tp {tp}")
    if getattr(config, "num_experts", 0):
        problems.append("MoE serving is single-host for now "
                        "(expert params ride the ep axis, not tp)")
    if problems:
        raise ValueError(
            "config does not shard over tp=%d: %s"
            % (tp, "; ".join(problems)))


def serve_rank_config(config, tp: int):
    """The config of one tp rank's served model: ``heads / tp``,
    ``kv_heads / tp`` and ``ffn_hidden / tp``, with ``head_dim`` set so
    the per-head width stays the full model's.  Contiguous head blocks
    keep GQA groups whole: rank r's query heads are served by rank r's kv
    heads.  At tp 1 the config itself."""
    check_serve_tp_config(config, tp)
    if tp == 1:
        return config
    return dataclasses.replace(
        config, heads=config.heads // tp, kv_heads=config.kv_heads // tp,
        ffn_hidden=config.ffn_hidden // tp, head_dim=config.dims_per_head)


def shard_serve_params(state_dict: Mapping, rank: int, tp: int) -> dict:
    """Tp rank ``rank``'s shard of a served transformer's state dict: each
    tensor narrowed to the rank's block of its :func:`serve_tp_spec` dim
    (contiguous; a dim-0 block is a view of the whole tensor, a dim-1
    block a copy), replicated tensors shared as they are."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp {tp}")
    out = {}
    for name, t in state_dict.items():
        spec = serve_tp_spec(name, t.shape)
        if "tp" in spec and tp > 1:
            dim = spec.index("tp")
            if t.shape[dim] % tp:
                raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does "
                                 f"not divide over tp {tp}")
            n = t.shape[dim] // tp
            t = t.narrow(dim, rank * n, n).contiguous()
        out[name] = t
    return out
