"""A training cell: ``models/train.py``'s step (Adam over f32 masters,
compute in the file's type, the hand-written kernels on, no remat), fed
by ``models/dataset.py``'s ``TokenDataset`` over token shards the set-up
writes, through ``models/data.py``'s ``prefetch_to_device``, as
``train_lm.py`` wires them.

Set-up builds the one train state and drives it through the first three
steps, which are both the warm-up and the steps the reference follows;
the window then runs that same state on.  ``train_tokens_per_s`` is all
the tokens of the steps the window ran over the window, closed by a
synchronize.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import check, common, flops, traffic
from portbench.drivers import peak_bytes, port_config, release, sync
from portbench.reference import train as ref_train

CHECK_STEPS = 3


def _fed_rows_outside(corpus: np.ndarray, seq_len: int, fed: list) -> int:
    """Rows the program fed that are no window of the corpus."""
    windows = {corpus[i:i + seq_len].tobytes()
               for i in range(0, len(corpus) - seq_len + 1, seq_len)}
    return sum(row.astype(corpus.dtype).tobytes() not in windows
               for batch in fed for row in batch)


def run(ctx) -> dict:
    from k8s_tpu_torch.models import data as data_lib
    from k8s_tpu_torch.models import dataset as ds_lib
    from k8s_tpu_torch.models import train as train_lib
    from k8s_tpu_torch.models.transformer import Transformer

    spec, wl, dev = ctx.spec, ctx.workload, ctx.device
    B, L = wl["batch"], wl["seq_len"]
    lr = wl["optimizer"]["lr"]
    cfg = port_config(spec, max_seq_len=L, remat=False)

    data_dir = tempfile.mkdtemp(prefix="portbench-tokens-")
    corpus = traffic.token_corpus(ctx.seed, wl["corpus_windows"] * L,
                                  spec.vocab)
    ds_lib.write_token_shards(data_dir, corpus,
                              shard_tokens=wl["shard_windows"] * L,
                              vocab_size=spec.vocab)
    fed: list = []

    def tee(stream):
        for batch in stream:
            if len(fed) < CHECK_STEPS:
                fed.append(batch[0].copy())
            yield batch

    batches = ds_lib.TokenDataset(data_dir).batches(B, L, seed=ctx.seed)
    data_iter = data_lib.prefetch_to_device(tee(batches), dev)

    common.log(ctx.t_start, "token shards written")
    params = common.make_params(spec, ctx.seed, dev, torch.float32)
    model = Transformer(cfg, params, device=dev, trainable=True)
    del params
    optimizer = train_lib.default_optimizer(lr)
    state = train_lib.init_state(model, optimizer)
    step = train_lib.make_train_step(lambda m, x: m(x), train_lib.lm_loss,
                                     optimizer)
    names = {id(p): n for n, p in model.named_parameters()}
    common.log(ctx.t_start, "train state built")

    prog = {"losses": []}
    for i in range(CHECK_STEPS):
        state, loss = step(state, next(data_iter))
        prog["losses"].append(float(loss))
        if i == 0:
            opt = state["optimizer"]
            prog["grad_norms"] = {
                names[id(p)]: _first_grad_norm(opt, p)
                for g in opt.param_groups for p in g["params"]}
    with torch.no_grad():
        prog["change_norms"] = ref_train.change_norms(
            spec, ctx.seed, dict(model.named_parameters()))
    sync(dev)

    record = {"setup_s": time.perf_counter() - ctx.t_start}
    common.log(ctx.t_start, "set-up done; window opens")
    step_flops = flops.train_step_flops(spec, B, L)
    steps, t0 = 0, time.perf_counter()
    deadline = t0 + ctx.seconds
    rest_from = (t0, 0)
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        slice_s = min(ctx.trace_slice_s, ctx.seconds / 2)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            while time.perf_counter() - p0 < slice_s:
                state, loss = step(state, next(data_iter))
                steps += 1
            sync(dev)
            p1 = time.perf_counter()
        record["profile"] = (prof, p1 - p0)
        rest_from = (time.perf_counter(), steps)
    while time.perf_counter() < deadline:
        state, loss = step(state, next(data_iter))
        steps += 1
    last_loss = float(loss)  # synchronizes: the window's work is done
    t1 = time.perf_counter()
    window = t1 - t0
    record["e2e"] = {"train_tokens_per_s": steps * B * L / window}
    record["attempted"] = steps
    record["failed"] = 0 if last_loss == last_loss else 1
    record["window_s"] = window
    rest_s, rest_steps = t1 - rest_from[0], steps - rest_from[1]
    record["model_flops_per_s"] = step_flops * rest_steps / rest_s \
        if rest_steps else None
    record["memory_peak_bytes"] = peak_bytes(dev)
    common.log(ctx.t_start, f"window closed: {steps} steps in {window:.3f} s")
    data_iter.close()
    del state, model, optimizer, loss
    gc.collect()

    if ctx.trace:
        record["attention"] = _time_attention(spec, B, L, dev)
    release(dev)

    ref = ref_train.run_steps(spec, ctx.seed, fed, lr, dev)
    common.log(ctx.t_start, "reference done")
    numbers = check.train_numbers(prog, ref)
    numbers["rows_outside_corpus"] = _fed_rows_outside(corpus, L, fed)
    record["numbers"] = numbers
    record["checks"] = check.judge(numbers, wl["limits"])
    shutil.rmtree(data_dir, ignore_errors=True)
    return record


def _first_grad_norm(opt, p) -> float:
    """The norm of the first gradient the optimizer got for ``p``, from
    its state after one step: Adam's first moment is then (1 - b1) g (0
    where it holds no state: no step was taken)."""
    m = opt.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(m.norm() / (1 - opt.defaults[
        "betas"][0]))


def _time_attention(spec, B, L, dev) -> dict:
    """Device seconds of the port's public attention entry, forward and
    backward, at the cell's shape, and the work that shape needs (None
    off the card: a CPU run gives no device time)."""
    from k8s_tpu_torch.ops.flash_attention import flash_attention

    if dev.type != "cuda":
        return None
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(h):
        return torch.randn((B, L, h, spec.head_dim), generator=g, device=dev,
                           dtype=spec.torch_dtype).requires_grad_(True)

    q, k, v = rand(spec.heads), rand(spec.kv_heads), rand(spec.kv_heads)
    do = torch.randn_like(q)

    def fwd_bwd():
        out = flash_attention(q, k, v, causal=True, window=spec.window)
        torch.autograd.grad(out, (q, k, v), do)

    seconds = common.cuda_seconds(fwd_bwd, reps=10)
    f, b = flops.attention_train_work(B, L, spec.heads, spec.kv_heads,
                                      spec.head_dim, spec.window)
    return {"seconds": seconds, "flops": f, "bytes": b}
