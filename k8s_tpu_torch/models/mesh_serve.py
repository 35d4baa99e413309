"""Tensor-parallel serving over a ``tp`` ring: port of
``k8s_tpu/models/mesh_serve.py``.

``MeshPlacement`` runs the engine's compute bodies
(models/placement.PagedCompute) as tp rank 0 of a ring of ranks, one
process (or, in the checks, one ``ThreadRing`` thread) per rank:

- **params** are split the Megatron way (parallel/sharding.serve_tp_*):
  each rank builds its model from its shard, q/k/v and gate/up
  column-split, o_proj and down_proj row-split, their partial sums summed
  over the ring after each (models/transformer.py), the embedding and the
  norms replicated;
- **the KV block pool** is split along the kv-head axis: each rank holds
  its head slice of every block, and the chief's block tables address
  every rank's slice alike; the pool write and the paged attention run on
  the rank's slice with no collective (the rank's config carries its head
  counts, so the single-device bodies of models/paged.py serve it);
- **the batch plan** (slot, table, position and token ints) is per-step
  host data on the chief: it goes to every follower over the plan bus
  (models/mp_plan.py) before the chief runs the same body, and the tokens
  rank 0 samples reach the other ranks over the ring inside the fused
  step, so only the chief reads them.

The chief runs the whole engine (scheduler, HTTP, metrics), unchanged;
the other ranks run :func:`follower_loop`, replaying the plan, so every
rank runs the same body sequence.  ``torch.distributed`` comes up
through the same operator env contract training gangs use
(launcher/bootstrap.py), and models/mp_serve.py drives a gang the way
the training gangs are driven.  A chief crash closes the plan bus and
every follower exits non-zero; a follower parked in a collective when
its chief dies fails within :data:`COLLECTIVE_TIMEOUT_S`: a half-dead
serving gang restarts whole, it never hangs.

What differs from the reference: eager PyTorch compiles nothing, so
:class:`MeshPrograms` is a plain executor from opcode to ``PagedCompute``
method and the follower's ``compile_ledger`` is null; the ring is the
``torch.distributed`` world (one device per process) rather than a JAX
device mesh.  :func:`run_in_threads` runs the ranks as threads of one
process over ``ThreadRing`` (how the checks run tp ranks on one device;
no entry point selects it).

Knobs: ``K8S_TPU_SERVE_MESH`` (process count; 0/unset = one device) and
``K8S_TPU_SERVE_PLAN_PORT`` (the plan bus port followers dial).  The tp
ring is the whole world: one device per process, every process a rank.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from k8s_tpu_torch.models import mp_plan
from k8s_tpu_torch.models import placement as placement_lib
from k8s_tpu_torch.models.transformer import Transformer
from k8s_tpu_torch.parallel import collectives
from k8s_tpu_torch.parallel.sharding import (
    check_serve_tp_config,
    serve_pool_spec,
    serve_rank_config,
    shard_serve_params,
)

log = logging.getLogger(__name__)

ENV_PLAN_PORT = "K8S_TPU_SERVE_PLAN_PORT"
WORKER_OK = "SERVE_MP_WORKER "

# A serving collective that waits longer than this fails, so a follower
# whose chief died inside a step exits instead of hanging.  The ranks of
# a step run in lockstep; only the plan bus waits without bound (an idle
# server is no fault).
COLLECTIVE_TIMEOUT_S = 60

# plan-bus opcodes (the closed protocol the follower replays)
OP_INIT = "init"
OP_TABLES = "tables"
OP_PAGED_STEP = "paged_step"
OP_SPEC_STEP = "spec_step"
OP_COW = "cow"
OP_PREFILL = "prefill"


def build_serve_mesh() -> collectives.Ring:
    """The serving tp ring over the whole ``torch.distributed`` world:
    every process is a rank (a process outside the ring would never join
    its collectives).  One process: the default group's one-rank ring
    when a group exists, else the plain one-rank ``Ring``.  More: a group
    of its own with a bounded timeout (:data:`COLLECTIVE_TIMEOUT_S`)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized():
        return collectives.Ring()
    if world == 1:
        return collectives.ProcessGroupRing(None)
    return collectives.ProcessGroupRing(dist.new_group(
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)))


def local_fraction(local: Iterable[torch.Tensor], total: int) -> float:
    """MEASURED share one rank holds: the elements of the tensors it
    holds over ``total``, the whole model's (or pool's) elements.  1/tp
    for the head-split pool, between 1/tp and 1 for the params (the
    embedding and the norms are whole on every rank)."""
    return sum(int(t.numel()) for t in local) / max(int(total), 1)


def _manifest_numel(manifest: list) -> int:
    return sum(int(np.prod(shape)) for _, _, shape in manifest)


def _rank_compute(config, params, ring, device) -> placement_lib.PagedCompute:
    """The compute bodies over tp rank ``ring.rank``'s model: its config
    and its shard of ``params``, the ring summing its partial sums."""
    check_serve_tp_config(config, ring.size)
    model = Transformer(serve_rank_config(config, ring.size),
                        shard_serve_params(params, ring.rank, ring.size),
                        device=device, tp=ring)
    return placement_lib.PagedCompute(model)


def _params_fraction(compute, params) -> float:
    return round(local_fraction(
        compute.model.state_dict().values(),
        sum(int(t.numel()) for t in params.values())), 4)


class MeshPrograms:
    """One rank's executor of plan ops over its ``PagedCompute``: the
    chief calls :meth:`execute` right after broadcasting the same message
    and followers call it on receipt, so both sides run one code path."""

    def __init__(self, compute: placement_lib.PagedCompute, tp: int):
        self.compute = compute
        self.tp = tp
        self.device = compute.model.embedding.device

    def zeros_pool(self, manifest: list) -> list:
        """This rank's zero slice of the pool the chief's init manifest
        describes (split per ``serve_pool_spec``): no rank, chief
        included, ever allocates a whole pool leaf."""
        layers: dict = {}
        for path, dtype, shape in manifest:
            spec = serve_pool_spec(shape) or (None,) * len(shape)
            local = [d // self.tp if a == "tp" else d
                     for d, a in zip(shape, spec)]
            layers.setdefault(path[0], {})[path[-1]] = torch.zeros(
                local, dtype=getattr(torch, dtype), device=self.device)
        return [layers[k] for k in sorted(
            layers, key=lambda k: int(k.rsplit("_", 1)[1]))]

    def execute(self, op: str, statics: dict, arrays: dict, pool, tables,
                rows=(None, None, None)):
        """Run one plan op; returns ``(pool, tables, outputs)`` (the pool
        is updated in place).  ``rows``: the slots' generators,
        temperatures and top-k, which only the chief holds."""
        c = self.compute
        with torch.inference_mode():
            if op == OP_TABLES:
                return pool, torch.as_tensor(
                    arrays["tables"], dtype=torch.long).to(self.device), None
            if op == OP_PAGED_STEP:
                width = int(statics["width"])
                return pool, tables, c.paged_step(
                    pool, tables[:, :width], arrays["ints"], *rows,
                    int(statics["k"]))
            if op == OP_SPEC_STEP:
                width = int(statics["width"])
                return pool, tables, c.spec_step(
                    pool, tables[:, :width], arrays["chunk"],
                    arrays["ints"], *rows, int(statics["k"]))
            if op == OP_COW:
                c.cow(pool, int(arrays["src"].item()),
                      int(arrays["dst"].item()))
                return pool, tables, None
            if op == OP_PREFILL:
                return pool, tables, c.prefill_paged(
                    pool, arrays["table"], arrays["chunk"],
                    arrays["positions"])
        raise ValueError(f"unknown plan op {op!r}")


class MeshPlacement:
    """The engine-facing seam for tensor-parallel serving: the
    ``LocalPlacement`` surface (``build_compute`` / ``wrap`` /
    ``build_pool`` / ``put_tables``), with the engine's model rank 0's
    shard and every call's host plan broadcast to the followers first.

    ``ring``: the tp ring (default :func:`build_serve_mesh`); ``bus``: the
    plan bus the followers dialed (None without followers); ``device``:
    this rank's device (default the process's)."""

    is_mesh = True

    def __init__(self, config, ring: Optional[collectives.Ring] = None, *,
                 bus: Optional[mp_plan.PlanBus] = None, device=None):
        import torch.distributed as dist

        from k8s_tpu_torch.launcher import bootstrap

        self.ring = ring if ring is not None else build_serve_mesh()
        self.tp = self.ring.size
        check_serve_tp_config(config, self.tp)
        if self.ring.rank != 0:
            raise ValueError(
                f"the engine runs on tp rank 0 (this ring's rank is "
                f"{self.ring.rank}); other ranks run follower_loop")
        self.config = config
        self.device = torch.device(device) if device is not None \
            else bootstrap.process_device()
        self._bus = bus
        self._progs: Optional[MeshPrograms] = None
        self._num_processes = dist.get_world_size() \
            if dist.is_initialized() else 1
        # measured at build_compute / build_pool
        self.params_local_fraction: Optional[float] = None
        self.pool_local_fraction: Optional[float] = None

    @classmethod
    def from_env(cls, config, *, device=None) -> "MeshPlacement":
        """The serving pod's placement: the ring over the already
        initialized ``torch.distributed`` world (launcher env contract),
        the plan bus bound on ``K8S_TPU_SERVE_PLAN_PORT`` when there are
        followers to feed."""
        import torch.distributed as dist

        ring = build_serve_mesh()
        check_serve_tp_config(config, ring.size)
        bus = None
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world > 1:
            port = int(os.environ.get(ENV_PLAN_PORT, "0") or 0)
            # bind all interfaces: in a real multi-pod gang the followers
            # dial the chief pod's hostname (the coordinator host), not
            # loopback; pipelined, so the chief's next body overlaps the
            # plan's socket I/O
            bus = mp_plan.PlanBus(world - 1, host="", port=port,
                                  pipelined=True)
            bus.accept_workers()
        return cls(config, ring, bus=bus, device=device)

    def info(self) -> dict:
        return {"num_processes": self._num_processes,
                "mesh_shape": {"tp": self.tp}, "tp_degree": self.tp,
                "placement": "mesh"}

    # ------------------------------------------------------------- seam API

    def build_compute(self, config, params) -> placement_lib.PagedCompute:
        """The bodies over tp rank 0's model, built from its shard of the
        whole ``params`` (every rank loads the same artifact or seed, so
        no parameter crosses the wire)."""
        if config != self.config:
            raise ValueError("the placement was built for another config")
        compute = _rank_compute(config, params, self.ring, self.device)
        self._progs = MeshPrograms(compute, self.tp)
        self.params_local_fraction = _params_fraction(compute, params)
        return compute

    def _broadcast(self, op: str, statics: dict, arrays: dict) -> None:
        if self._bus is not None:
            self._bus.broadcast(op, statics, arrays)

    def _execute(self, op, statics, msg, pool, tables=None,
                 rows=(None, None, None)):
        return self._progs.execute(op, statics, msg, pool, tables, rows)[2]

    def wrap(self, op: str, fn: Callable) -> Callable:
        """A callable with ``fn``'s signature that broadcasts the
        per-call host plan, then runs the op on rank 0's compute through
        the same executor the followers replay it with (``fn`` is that
        compute's body, so it is not called directly)."""
        del fn

        if op == OP_PAGED_STEP:
            def step(pool, tables, ints, gens, temps, topks, k):
                statics = {"k": int(k), "width": int(tables.shape[1])}
                msg = {"ints": np.asarray(ints)}
                self._broadcast(op, statics, msg)
                return self._execute(op, statics, msg, pool, tables,
                                     (gens, temps, topks))
            return step
        if op == OP_SPEC_STEP:
            def spec(pool, tables, chunk, ints, gens, temps, topks, k):
                statics = {"k": int(k), "width": int(tables.shape[1])}
                msg = {"chunk": np.asarray(chunk), "ints": np.asarray(ints)}
                self._broadcast(op, statics, msg)
                return self._execute(op, statics, msg, pool, tables,
                                     (gens, temps, topks))
            return spec
        if op == OP_COW:
            def cow(pool, src, dst):
                msg = {"src": np.int32(src), "dst": np.int32(dst)}
                self._broadcast(op, {}, msg)
                return self._execute(op, {}, msg, pool)
            return cow
        if op == OP_PREFILL:
            def prefill(pool, table, chunk, positions):
                msg = {"table": np.asarray(table),
                       "chunk": np.asarray(chunk),
                       "positions": np.asarray(positions)}
                self._broadcast(op, {}, msg)
                return self._execute(op, {}, msg, pool)
            return prefill
        raise ValueError(
            f"mesh placement has no program for op {op!r} (windowed "
            "dense configs are single-host)")

    def build_pool(self, compute, pool_blocks: int, block_size: int):
        """Rank 0's zero slice of the head-split pool, after telling the
        followers its shape manifest: the ``init`` message every follower
        builds its own slice from (no pool bytes cross the wire)."""
        manifest = compute.pool_manifest(pool_blocks, block_size, self.tp)
        self._broadcast(OP_INIT, {"pool": manifest}, {})
        pool = self._progs.zeros_pool(manifest)
        self.pool_local_fraction = round(local_fraction(
            (leaf for _, leaf in compute.pool_leaves(pool)),
            _manifest_numel(manifest)), 4)
        return pool

    def put_tables(self, stack: np.ndarray) -> torch.Tensor:
        """Upload the ``[slots, max_blocks]`` block-table stack on every
        rank."""
        msg = {"tables": np.asarray(stack)}
        self._broadcast(OP_TABLES, {}, msg)
        return self._progs.execute(OP_TABLES, {}, msg, None, None)[1]

    def plan_bus_stats(self) -> Optional[dict]:
        """The plan bus's pipelining telemetry (None without followers):
        broadcasts, bytes, enqueue-wait against send seconds."""
        return self._bus.stats() if self._bus is not None else None

    def close(self) -> None:
        if self._bus is not None:
            self._bus.close()


# ---------------------------------------------------------------- follower

def follower_loop(config, params, *, chief_host: str = "127.0.0.1",
                  plan_port: Optional[int] = None,
                  ring: Optional[collectives.Ring] = None, device=None,
                  report: Optional[dict] = None) -> int:
    """A follower rank's main loop: build this rank's shard of the model
    the chief serves, then replay plan messages until the chief says bye
    (returns 0) or the stream dies (returns 1: the gang restarts whole).
    On a clean bye prints one ``SERVE_MP_WORKER {json}`` line (and puts
    the same payload into ``report`` when one is given): the ops
    replayed and the MEASURED shares of the pool and the params this rank
    holds.  ``ring`` defaults to :func:`build_serve_mesh`, ``device`` to
    the process's."""
    from k8s_tpu_torch.launcher import bootstrap

    ring = ring if ring is not None else build_serve_mesh()
    check_serve_tp_config(config, ring.size)
    dev = torch.device(device) if device is not None \
        else bootstrap.process_device()
    compute = _rank_compute(config, params, ring, dev)
    progs = MeshPrograms(compute, ring.size)
    params_frac = _params_fraction(compute, params)
    port = plan_port if plan_port is not None \
        else int(os.environ.get(ENV_PLAN_PORT, "0") or 0)
    follower = mp_plan.PlanFollower(chief_host, port)
    pool = None
    tables = None
    steps = 0
    pool_frac = None
    try:
        while True:
            try:
                op, statics, arrays = follower.recv()
            except mp_plan.PlanBusClosed as e:
                if e.clean:
                    payload = {
                        "process_id": bootstrap.process_index(),
                        "tp_rank": ring.rank,
                        "ops": steps,
                        # eager PyTorch compiles no programs
                        "compile_ledger": None,
                        "pool_local_fraction": pool_frac,
                        "params_local_fraction": params_frac,
                    }
                    if report is not None:
                        report.update(payload)
                    print(WORKER_OK + json.dumps(payload, sort_keys=True),
                          flush=True)
                    return 0
                log.error("plan bus died (chief crashed?): %s", e)
                return 1
            if op == OP_INIT:
                pool = progs.zeros_pool(statics["pool"])
                pool_frac = round(local_fraction(
                    (leaf for _, leaf in compute.pool_leaves(pool)),
                    _manifest_numel(statics["pool"])), 4)
                continue
            # the received arrays are read-only views of the frame
            arrays = {k: np.array(v) for k, v in arrays.items()}
            pool, tables, _ = progs.execute(op, statics, arrays, pool,
                                            tables)
            steps += 1
    finally:
        follower.close()


def run_in_threads(tp: int, config, params, chief: Callable, *, device,
                   timeout: float = 600.0):
    """Run a tp mesh as ``ThreadRing`` threads of this process, with the
    real plan bus on loopback: rank 0 makes a :class:`MeshPlacement` and
    returns ``chief(placement)`` (which builds the engine over it and
    shuts it down); ranks 1.. run :func:`follower_loop`.  Returns
    ``(chief's result, [each follower's SERVE_MP_WORKER payload])``.  A
    follower that does not end on a clean bye fails the run."""
    bus = mp_plan.PlanBus(tp - 1, pipelined=True) if tp > 1 else None
    reports = [{} for _ in range(tp)]

    def body(ring):
        if ring.rank == 0:
            try:
                if bus is not None:
                    bus.accept_workers()
                return chief(MeshPlacement(config, ring, bus=bus,
                                           device=device))
            finally:
                if bus is not None:
                    bus.close()
        rc = follower_loop(config, params, plan_port=bus.port, ring=ring,
                           device=device, report=reports[ring.rank])
        if rc != 0:
            raise RuntimeError(f"follower rank {ring.rank} exited {rc}")
        return rc

    results = collectives.ThreadRing.run(tp, body, timeout=timeout)
    return results[0], reports[1:]
