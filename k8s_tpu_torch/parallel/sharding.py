"""Sharding rules: logical parameter axes onto mesh axes, applied with
FSDP2 (``torch.distributed.fsdp.fully_shard``).

Port of ``k8s_tpu/parallel/sharding.py:30-141``.  The spec functions are
pure functions of names and shapes and return the reference's
PartitionSpecs as tuples (``(None, "fsdp")`` for ``P(None, "fsdp")``):
a parameter shards its largest dimension divisible by the fsdp size,
else it is replicated.  :func:`placement_fn` turns a spec into the
``shard_placement_fn`` FSDP2 takes: the fsdp dimension becomes
``Shard(dim)``.  FSDP2 holds every parameter it manages as a shard, so a
replicated spec keeps FSDP2's default ``Shard(0)`` (padded where the
size does not divide): the gathered parameter and the reduced gradient
are the same, only where its bytes rest differs.

The serving tensor-parallel specs (``serve_tp_spec``, ``serve_pool_spec``)
come with the mesh-serving slice of the port (ROADMAP.md Queue 1 item 8c).
"""

from __future__ import annotations

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
