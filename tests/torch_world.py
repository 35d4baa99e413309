"""Gloo worlds of the port for the CPU tests: ``spawn`` starts N processes
under the operator's env contract, and ``python tests/torch_world.py fsdp
IO_DIR`` is the worker of the sharded-step tests.

``spawn`` builds each worker's env (``gang_envs``, which the serving
gang tests also use to start servers that outlive a run) with the
reference's own gang helpers
(``k8s_tpu.e2e.multiprocess.build_gang_tfjob`` and ``localhost_env``:
``controller_v2.tpu_config.gen_env_vars`` with the coordinator mapped to
loopback), adds ``K8S_TPU_PLATFORM=cpu`` as ``run_gang`` does, and runs
any command line, so the port's entry points run with their own flags.
The pytest process itself never joins a process group.

The ``sp`` worker trains sequence- and tensor-parallel cases the same
way (``sp_worker``).  The ``fsdp`` worker reads ``IO_DIR/in.json`` (config overrides of
``tiny_test``, optimizer, steps, grad_accum) and ``IO_DIR/in.npz``
(``param/<name>`` weights, ``tokens`` ``[steps, B, L]``), trains through
``train.fit(mesh=...)`` on the mesh ``make_training_mesh`` builds from the
env, with a checkpoint at the end, then restores that checkpoint into a
fresh sharded state, and takes the gradient at the final weights on the
first batch.  Process 0 writes ``out.json`` and ``out.npz``.  The
``ckpt`` worker drives the sharded ``Checkpointer`` the same way, the
``pp`` worker trains pipeline-parallel cases and ``train_lm --pp`` runs
(``pp_worker``), and the ``moe`` worker trains the MoE Transformer on an
(fsdp, ep) mesh (``moe_worker``).
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_torch_thread():
    """The body of the port's CPU tests' autouse fixture
    (``pytest.fixture(autouse=True)(torch_world.one_torch_thread)``):
    torch's intra-op threads pinned to one while a test runs.  Beside the
    other test workers more threads oversubscribe the host (a 60-step
    tiny ViT took 516 s instead of 5); spawned workers get
    ``OMP_NUM_THREADS=1`` for the same reason."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rendezvous_port() -> int:
    """A free TCP port below the kernel's ephemeral range, for a gang's
    rendezvous.  A port the kernel hands out (a bind to port 0, the local
    end of any outgoing connection) can be taken by another test worker
    between the pick and the rank-0 store's bind seconds later, and the
    gang then fails with EADDRINUSE; ports below the range are never
    handed out, so only another explicit pick can take one."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    pick = random.Random()
    for _ in range(100):
        port = pick.randrange(max(1024, low - 10000), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in [{low - 10000}, {low})")


def gang_envs(n: int, *, num_slices: int = 1, extra_env=None) -> list:
    """Each of an n-worker gang's envs: the operator's (``localhost_env``
    of a TFJob from ``build_gang_tfjob``, its coordinator on a
    ``rendezvous_port``), on the CPU, the repository on the path,
    ``extra_env`` last."""
    from k8s_tpu.e2e import multiprocess

    tfjob = multiprocess.build_gang_tfjob(n, rendezvous_port(),
                                          num_slices=num_slices)
    envs = []
    for i in range(n):
        env = dict(os.environ)
        env.update(multiprocess.localhost_env(tfjob, "worker", i))
        env.update(K8S_TPU_PLATFORM="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        env.update(extra_env or {})
        envs.append(env)
    return envs


def spawn(n: int, argv: list, *, num_slices: int = 1, extra_env=None,
          timeout: float = 120.0) -> tuple[list, list]:
    """Run ``argv`` (after ``python``) as an n-process gang; returns each
    worker's exit code and output.  The first failure terminates the
    rest, as the operator restarts a whole gang.  A worker still running
    at ``timeout`` is killed, and its output ends with a line that says
    so and how long the gang ran."""
    procs, logs = [], []
    for env in gang_envs(n, num_slices=num_slices, extra_env=extra_env):
        log = tempfile.TemporaryFile()
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *argv], env=env,
                                      cwd=REPO, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    while time.time() < deadline and any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.terminate()
        time.sleep(0.05)
    outputs = []
    took = time.time() - deadline + timeout
    for p, log in zip(procs, logs):
        killed = p.poll() is None
        if killed:
            p.kill()
        p.wait()
        log.seek(0)
        outputs.append(log.read().decode(errors="replace") + (
            f"\n[killed at the {timeout:.0f} s limit, {took:.1f} s after "
            "the gang started]" if killed else ""))
        log.close()
    return [p.returncode for p in procs], outputs


def fsdp_worker(io_dir: str) -> int:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed

    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import checkpoint
    from k8s_tpu_torch.models import data as data_lib
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models import transformer as tt
    from k8s_tpu_torch.parallel.mesh import data_sharding, mesh_shape

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(io_dir, "in.json")))
    arrays = np.load(os.path.join(io_dir, "in.npz"))
    cfg = dataclasses.replace(tt.tiny_test(), **spec["config"])
    params = {k[len("param/"):]: torch.from_numpy(arrays[k])
              for k in arrays.files if k.startswith("param/")}
    tokens = arrays["tokens"]

    launch = bootstrap.initialize_distributed()
    mesh, launch = bootstrap.make_training_mesh(config=launch)
    optimizer = train_lib.default_optimizer(**spec["opt"])

    def fresh(p):
        model = tt.Transformer(cfg, p, device="cpu", trainable=True)
        return train_lib.init_state(model, optimizer)

    ckpt_dir = os.path.join(io_dir, "ckpt")
    it = data_lib.prefetch_to_mesh(((t, t) for t in tokens), mesh, "cpu")
    try:
        result = train_lib.fit(
            lambda m, x: m(x), train_lib.lm_loss, optimizer, fresh(params),
            it, steps=len(tokens), mesh=mesh, grad_accum=spec["grad_accum"],
            checkpoint_dir=ckpt_dir, checkpoint_every=1000,
            preemption_save=False)
    finally:
        it.close()
    state = result.state
    full = {n: p.detach().full_tensor().numpy()
            for n, p in state["model"].named_parameters()}

    # the checkpoint round trip, into a fresh state with other weights and
    # a wrong update count
    other = fresh({n: torch.zeros_like(t) for n, t in params.items()})
    other, _ = train_lib.shard_train_state(other, mesh)
    for group in other["optimizer"].param_groups:
        group["count"] = -1
    ck = checkpoint.Checkpointer(ckpt_dir)
    other, next_step = ck.restore_or_init(other)
    restored_equal = all(
        torch.equal(a.to_local(), b.to_local()) for a, b in zip(
            state["model"].parameters(), other["model"].parameters()))
    moments_equal = all(
        torch.equal(state["optimizer"].state[a]["exp_avg_sq"].to_local(),
                    other["optimizer"].state[b]["exp_avg_sq"].to_local())
        for a, b in zip(state["model"].parameters(),
                        other["model"].parameters()))
    # the gradient at the final weights on the first batch: FSDP's
    # reduction over the data shards, before any clip or Adam normalizes
    # its scale away
    model = state["model"]
    model.zero_grad(set_to_none=True)
    rows = data_sharding(mesh).local(torch.from_numpy(tokens[0]))
    train_lib.lm_loss(model(rows), rows).backward()
    grads = {f"grad/{n}": p.grad.full_tensor().numpy()
             for n, p in model.named_parameters()}
    # shard_params places each parameter by logical_to_spec on its axes
    from k8s_tpu_torch.parallel import sharding

    plain = fresh(params)["model"]
    axes = sharding.infer_logical_axes(dict(plain.named_parameters()))
    sharding.shard_params(plain, axes, mesh)
    fsdp = mesh_shape(mesh)["fsdp"]

    def want_dim(name, p):
        spec = sharding.logical_to_spec(axes[name], shape=tuple(p.shape),
                                        fsdp_size=fsdp)
        return spec.index("fsdp") if "fsdp" in spec else 0  # FSDP2's default

    placed = all(p.placements[-1].dim == want_dim(n, p)
                 for n, p in plain.named_parameters())
    # every rank checked its own shards
    same = torch.tensor([int(restored_equal and moments_equal and placed)])
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    if launch.is_chief:
        shard = data_sharding(mesh)
        out = {"losses": result.losses, "mesh": mesh_shape(mesh),
               "data_shard": [shard.index, shard.count],
               "count": [g["count"] for g in state["optimizer"].param_groups],
               "restored_count": [g["count"] for g in
                                  other["optimizer"].param_groups],
               "restored_step": other["step"], "next_step": next_step,
               "restored_equal": bool(same.item()),
               "ckpt_steps": ck.all_steps(),
               "ckpt_files": sorted(os.listdir(
                   os.path.join(ckpt_dir, str(len(tokens) - 1))))}
        with open(os.path.join(io_dir, "out.json"), "w") as f:
            json.dump(out, f)
        np.savez(os.path.join(io_dir, "out.npz"), **full, **grads)
    return 0


def ckpt_worker(io_dir: str) -> int:
    """The sharded Checkpointer: the interval and ``max_to_keep`` policy,
    a synchronous round trip, and an async save that keeps the state it
    was handed while the next step changes the weights."""
    import torch
    import torch.distributed as dist

    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models import transformer as tt
    from k8s_tpu_torch.models.checkpoint import Checkpointer
    from k8s_tpu_torch.parallel.mesh import data_sharding

    torch.set_num_threads(1)
    launch = bootstrap.initialize_distributed()
    mesh, launch = bootstrap.make_training_mesh(config=launch)
    cfg = tt.tiny_test()
    optimizer = train_lib.default_optimizer(1e-2, clip_norm=1.0)

    def fresh(seed):
        model = tt.Transformer(cfg, bridge.init_params(
            cfg, seed, "cpu", dtype=torch.float32), device="cpu",
            trainable=True)
        return train_lib.shard_train_state(
            train_lib.init_state(model, optimizer), mesh)

    state, shardings = fresh(0)
    step = train_lib.make_sharded_train_step(
        lambda m, x: m(x), train_lib.lm_loss, optimizer, mesh, shardings)
    tokens = torch.from_numpy(__import__("numpy").random.default_rng(
        3).integers(0, 256, (4, 16)))
    rows = data_sharding(mesh).local(tokens)
    state, _ = step(state, (rows, rows))

    def snapshot(s):
        return ([p.detach().to_local().clone()
                 for p in s["model"].parameters()],
                [s["optimizer"].state[p]["exp_avg"].to_local().clone()
                 for p in s["model"].parameters()],
                [g["count"] for g in s["optimizer"].param_groups],
                s["step"])

    def same(s, snap):
        params, moments, count, step_no = snapshot(s)
        return (all(torch.equal(a, b) for a, b in zip(params, snap[0]))
                and all(torch.equal(a, b) for a, b in zip(moments, snap[1]))
                and count == snap[2] and step_no == snap[3])

    out = {}
    ck = Checkpointer(os.path.join(io_dir, "sync"), max_to_keep=2,
                      save_interval_steps=3)
    out["saved"] = [s for s in range(8) if ck.maybe_save(s, state)]
    out["kept"] = ck.all_steps()
    out["resave_refused"] = not ck.save(6, state)
    out["forced"] = ck.save(7, state, force=True)
    snap = snapshot(state)
    other, _ = fresh(1)
    other, out["next_step"] = ck.restore_or_init(other)
    ok = same(other, snap)

    ack = Checkpointer(os.path.join(io_dir, "async"), async_save=True)
    ack.save(9, state)
    out["pending_latest"] = ack.latest_step()
    state, _ = step(state, (rows, rows))  # the weights move on meanwhile
    ack.wait()
    out["async_steps"] = ack.all_steps()
    other, _ = fresh(2)
    other, _ = ack.restore_latest(other)
    ok = ok and same(other, snap) and not same(state, snap)
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    out["restored_equal"] = bool(flag.item())
    if launch.is_chief:
        out["async_files"] = sorted(os.listdir(os.path.join(io_dir, "async",
                                                            "9")))
        with open(os.path.join(io_dir, "out.json"), "w") as f:
            json.dump(out, f)
    return 0


def sp_worker(io_dir: str) -> int:
    """Sequence- and tensor-parallel training: each case of
    ``IO_DIR/in.json`` (``tiny_test`` overrides, sp, tp, grad_accum,
    fused) trains the ``param/<name>`` weights of ``in.npz`` on its
    ``tokens`` through ``train.fit(mesh=...)`` on an (sp, tp) mesh, then
    takes the gradient at the final weights on the first batch (summed
    over sp) and checks that the tp ranks hold the same weights.  With
    ``train_lm`` in the spec, ``train_lm.main`` runs with those flags for
    4 steps, and for 2 then 4 steps in another directory (a resume from
    the step-2 DCP checkpoint).  Process 0 writes ``out.json`` and
    ``out.npz``."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from k8s_tpu_torch import train_lm
    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import data as data_lib
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models import transformer as tt
    from k8s_tpu_torch.parallel.mesh import data_sharding, mesh_shape

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(io_dir, "in.json")))
    arrays = np.load(os.path.join(io_dir, "in.npz"))
    params = {k[len("param/"):]: torch.from_numpy(arrays[k])
              for k in arrays.files if k.startswith("param/")}
    tokens = arrays["tokens"]
    launch = bootstrap.initialize_distributed()
    out, npz = {}, {}
    for case in spec["cases"]:
        name = case["name"]
        cfg = dataclasses.replace(tt.tiny_test(), **case["config"])
        mesh, _ = bootstrap.make_training_mesh(tp=case["tp"], sp=case["sp"],
                                               config=launch)
        optimizer = train_lib.default_optimizer(**spec["opt"])
        model = tt.Transformer(cfg, params, device="cpu", trainable=True)
        if case["fused"]:
            apply_fn = train_lib.make_fused_lm_apply_fn(model, mesh=mesh)
            loss_fn = train_lib.fused_loss_passthrough
        else:
            def apply_fn(m, x, mesh=mesh):
                return m(x, mesh=mesh)

            loss_fn = train_lib.make_lm_loss(mesh)
        it = data_lib.prefetch_to_mesh(((t, t) for t in tokens), mesh, "cpu")
        try:
            result = train_lib.fit(
                apply_fn, loss_fn, optimizer,
                train_lib.init_state(model, optimizer), it,
                steps=len(tokens), mesh=mesh, grad_accum=case["grad_accum"],
                preemption_save=False)
        finally:
            it.close()
        model = result.state["model"]
        full = {n: p.detach().full_tensor()
                for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        part = data_sharding(mesh).local(torch.from_numpy(tokens[0]))
        loss = (loss_fn(apply_fn(model, part), part)
                if not case["fused"] else apply_fn(model, part))
        loss.backward()
        train_lib.sum_grads_over_sp(model, mesh)
        grads = {n: p.grad.full_tensor() for n, p in model.named_parameters()}
        # every rank's weights, summed: the tp ranks must hold the same
        sums = torch.stack([t.double().sum() for t in full.values()])
        every = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
        dist.all_gather(every, sums)
        shape = mesh_shape(mesh)
        grid = torch.stack(every).view(-1, shape["sp"], shape["tp"],
                                       len(sums))
        out[name] = {"losses": result.losses, "mesh": shape,
                     "tp_ranks_equal": bool((grid == grid[..., :1, :]).all())}
        npz.update({f"{name}/param/{n}": t.numpy() for n, t in full.items()})
        npz.update({f"{name}/grad/{n}": t.numpy() for n, t in grads.items()})
    if spec.get("train_lm"):
        def run(train_dir, steps):
            argv = [*spec["train_lm"], f"--train_dir={train_dir}",
                    f"--train_steps={steps}"]
            rc = train_lm.main(argv)
            path = os.path.join(train_dir, "metrics.jsonl")
            recs = [json.loads(x) for x in open(path)] \
                if launch.is_chief else []
            return rc, recs

        whole = run(os.path.join(io_dir, "lm_whole"), 4)
        first = run(os.path.join(io_dir, "lm_resumed"), 2)
        resumed = run(os.path.join(io_dir, "lm_resumed"), 4)
        ckpts = sorted(os.listdir(os.path.join(io_dir, "lm_resumed")))
        last = os.path.join(io_dir, "lm_whole", "3")
        out["train_lm"] = {
            "whole": whole, "first": first, "resumed": resumed,
            "files": ckpts,
            # the DCP shards of the last step: replicated over sp, so
            # written once, not once a rank
            "distcp_bytes": sum(os.path.getsize(os.path.join(last, f))
                                for f in os.listdir(last)
                                if f.endswith(".distcp"))}
    if launch.is_chief:
        with open(os.path.join(io_dir, "out.json"), "w") as f:
            json.dump(out, f)
        np.savez(os.path.join(io_dir, "out.npz"), **npz)
    return 0


def _train_lm_runs(io_dir: str, name: str, flags: list, is_chief: bool):
    """``train_lm.main`` with ``flags`` for 4 steps, and for 2 then 4
    steps in another directory (a resume from the step-2 checkpoint):
    each run's exit code and metrics records (process 0's)."""
    from k8s_tpu_torch import train_lm

    def run(train_dir, steps):
        rc = train_lm.main([*flags, f"--train_dir={train_dir}",
                            f"--train_steps={steps}"])
        path = os.path.join(train_dir, "metrics.jsonl")
        recs = [json.loads(x) for x in open(path)] if is_chief else []
        return rc, recs

    whole = run(os.path.join(io_dir, f"{name}_whole"), 4)
    first = run(os.path.join(io_dir, f"{name}_resumed"), 2)
    resumed = run(os.path.join(io_dir, f"{name}_resumed"), 4)
    return {"whole": whole, "first": first, "resumed": resumed,
            "files": sorted(os.listdir(os.path.join(io_dir,
                                                    f"{name}_resumed")))}


def pp_worker(io_dir: str) -> int:
    """Pipeline-parallel training: each case of ``IO_DIR/in.json``
    (``tiny_test`` overrides, num_virtual, num_microbatches) trains the
    ``param/<name>`` weights of ``in.npz`` on its ``tokens`` through
    ``pp_lm.make_pp_train_step`` over the pp ranks ``make_training_mesh``
    makes from the env, then takes ``pp_loss_and_grads`` at the final
    weights on the first batch.  Each rank writes its stage's weights and
    gradients to ``out_<case>_<rank>.npz``.  Each ``train_lm`` flag set
    of the spec runs through :func:`_train_lm_runs` (with
    ``train_lm_layers``, on ``tiny_test`` at that many layers).  Process 0
    writes ``out.json``."""
    import dataclasses

    import numpy as np
    import torch

    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import pp_lm
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models import transformer as tt
    from k8s_tpu_torch.parallel.collectives import mesh_rings

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(io_dir, "in.json")))
    arrays = np.load(os.path.join(io_dir, "in.npz"))
    params = {k[len("param/"):]: torch.from_numpy(arrays[k])
              for k in arrays.files if k.startswith("param/")}
    tokens = torch.from_numpy(arrays["tokens"]).long()
    launch = bootstrap.initialize_distributed()
    out = {}
    for case in spec["cases"]:
        name, v, M = case["name"], case["num_virtual"], case["M"]
        cfg = dataclasses.replace(tt.tiny_test(), **case["config"])
        mesh, _ = bootstrap.make_training_mesh(pp=case["pp"], config=launch)
        rank = mesh_rings(mesh).pp.rank
        stage = pp_lm.LmStage(cfg, params, rank=rank,
                              num_stages=case["pp"], num_virtual=v,
                              device="cpu")
        optimizer = train_lib.default_optimizer(**spec["opt"])
        state = train_lib.init_state(stage, optimizer)
        stats: dict = {}
        step = pp_lm.make_pp_train_step(cfg, optimizer, mesh,
                                        num_microbatches=M, num_virtual=v,
                                        stats=stats)
        losses = []
        for t in tokens:
            state, loss = step(state, (t, t))
            losses.append(float(loss))
        _, grads = pp_lm.pp_loss_and_grads(
            mesh, cfg, stage, tokens[0], tokens[0], num_microbatches=M,
            num_virtual=v)
        np.savez(os.path.join(io_dir, f"out_{name}_{rank}.npz"),
                 **{f"param/{n}": p.detach().numpy()
                    for n, p in stage.named_parameters()},
                 **{f"grad/{n}": g.numpy() for n, g in grads.items()})
        out[name] = {"losses": losses,
                     "peak_stashed": stats["peak_stashed"],
                     "count": [g["count"] for g in
                               state["optimizer"].param_groups]}
    if spec.get("train_lm_layers"):  # the tiny preset at more layers
        tiny = tt.tiny_test
        tt.tiny_test = lambda: dataclasses.replace(
            tiny(), layers=spec["train_lm_layers"])
    for name, flags in spec.get("train_lm", {}).items():
        out[name] = _train_lm_runs(io_dir, name, flags, launch.is_chief)
    if launch.is_chief:
        with open(os.path.join(io_dir, "out.json"), "w") as f:
            json.dump(out, f)
    return 0


def moe_worker(io_dir: str) -> int:
    """The MoE Transformer (``tiny_test`` overrides of ``in.json``) on the
    (fsdp, ep) mesh of ``in.json``: 3 steps of the sharded step through
    ``make_moe_apply_fn(mesh=)`` on ``in.npz``'s ``tokens`` (each rank
    its rows), then the gradient at the final weights on the first batch,
    and a DCP save restored into a fresh sharded state.  Each rank writes
    its local parameters and gradients (its experts' slice, whole after
    FSDP's gather) to ``out_<rank>.npz``."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed

    from k8s_tpu_torch.launcher import bootstrap
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models import transformer as tt
    from k8s_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(io_dir, "in.json")))
    arrays = np.load(os.path.join(io_dir, "in.npz"))
    params = {k[len("param/"):]: torch.from_numpy(arrays[k])
              for k in arrays.files if k.startswith("param/")}
    tokens = torch.from_numpy(arrays["tokens"]).long()
    launch = bootstrap.initialize_distributed()
    cfg = dataclasses.replace(tt.tiny_test(), **spec["config"])
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**spec["mesh"]),
                              device_type="cpu")
    optimizer = train_lib.default_optimizer(**spec["opt"])
    model = tt.Transformer(cfg, params, device="cpu", trainable=True)
    state, shardings = train_lib.shard_train_state(
        train_lib.init_state(model, optimizer), mesh)
    apply_fn = train_lib.make_moe_apply_fn(model, mesh=mesh)
    step = train_lib.make_sharded_train_step(
        apply_fn, train_lib.lm_loss, optimizer, mesh, shardings)
    shard = mesh_lib.data_sharding(mesh)
    losses = []
    for t in tokens:
        rows = shard.local(t)
        state, loss = step(state, (rows, rows))
        losses.append(float(loss))
    model = state["model"]
    full = {n: p.detach().full_tensor() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rows = shard.local(tokens[0])
    # the step's gradient: FSDP averages over the data shards
    train_lib._combined_loss(apply_fn, train_lib.lm_loss, model,
                             (rows, rows)).backward()
    grads = {n: p.grad.full_tensor() for n, p in model.named_parameters()}
    # the DCP round trip into a fresh sharded state: each ep rank's
    # experts under names of their own, the rest written once
    from k8s_tpu_torch.models.checkpoint import Checkpointer

    ck = Checkpointer(os.path.join(io_dir, "ckpt"))
    ck.save(len(tokens) - 1, state, force=True)
    other, _ = train_lib.shard_train_state(train_lib.init_state(
        tt.Transformer(cfg, {n: torch.zeros_like(t)
                             for n, t in params.items()}, device="cpu",
                       trainable=True), optimizer), mesh)
    other, next_step = ck.restore_or_init(other)
    pairs = list(zip(model.parameters(), other["model"].parameters()))
    same = all(torch.equal(a.to_local(), b.to_local()) for a, b in pairs) \
        and all(torch.equal(
            state["optimizer"].state[a]["exp_avg_sq"].to_local(),
            other["optimizer"].state[b]["exp_avg_sq"].to_local())
            for a, b in pairs) and next_step == len(tokens)
    flag = torch.tensor([int(same)])
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    np.savez(os.path.join(io_dir, f"out_{launch.process_id}.npz"),
             **{f"param/{n}": t.numpy() for n, t in full.items()},
             **{f"grad/{n}": t.numpy() for n, t in grads.items()})
    if launch.is_chief:
        with open(os.path.join(io_dir, "out.json"), "w") as f:
            json.dump({"losses": losses, "ep_rank": coord["ep"],
                       "mesh": mesh_lib.mesh_shape(mesh),
                       "restored_equal": bool(flag.item()),
                       "ckpt_files": sorted(os.listdir(os.path.join(
                           io_dir, "ckpt", str(len(tokens) - 1))))}, f)
    with open(os.path.join(io_dir, f"coord_{launch.process_id}.json"),
              "w") as f:
        json.dump(coord, f)
    return 0


if __name__ == "__main__":
    workers = {"fsdp": fsdp_worker, "ckpt": ckpt_worker, "sp": sp_worker,
               "pp": pp_worker, "moe": moe_worker}
    if sys.argv[1] not in workers:
        raise SystemExit(f"unknown scenario {sys.argv[1]!r}")
    sys.exit(workers[sys.argv[1]](sys.argv[2]))
