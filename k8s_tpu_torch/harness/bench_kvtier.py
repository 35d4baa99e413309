"""Tiered KV memory bench: the host-RAM spill tier against
evict-recompute, fingerprint-dedup migration, and fixed-seed identity
through every tier crossing.  The port of
``k8s_tpu/harness/bench_kvtier.py``, over the port's ``Engine``,
``LmServer``, ``kvtier`` and ``kvxfer``.

    python -m k8s_tpu_torch.harness.bench_kvtier
    python -m k8s_tpu_torch.harness.bench_kvtier --device cpu   # no card

Three stages on bench_serve's model:

- **spill throughput**: one engine, a prompt corpus whose distinct
  prefix blocks total ~10x the pool's prefix headroom, replayed for
  several rounds (the same traffic and seed in both arms).  With
  ``spill_mb`` set, evicted ``PrefixTree`` leaves demote to host RAM and
  are promoted back on the next tree walk; without it, eviction discards
  and every revisit prefills again.  Failures: post-warm-up tokens/s and
  prefix hit rate must strictly beat evict-recompute, and the spill arm
  must have demoted and promoted (a corpus that never pressures the
  pool proves nothing).
- **spill identity**: an int8-KV-pool engine (spill stores int8 pools
  bit-exact) answers each lane (greedy, sampled, top-k, speculative),
  then a filler flood forces the lane's blocks through demote, and the
  re-ask must return the same tokens through the promote path (the
  lane's ``spill_promotions`` must move).
- **dedup migration storm**: two real ``LmServer``s over real sockets
  (prefill -> decode), a repeated-prefix storm of ``kv_dest``
  migrations.  The fingerprint handshake must skip blocks the receiver
  already holds (sender-side ``serve_kvxfer_dedup_blocks_skipped_total``
  > 0, estimated wire bytes saved > 0), and each lane's answer through a
  deduped migration must equal the local single-engine oracle.

One JSON line; on a failure it still lands, with a ``failures`` field.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA without a card raises.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import urllib.request

import numpy as np

log = logging.getLogger(__name__)

LANES = ("greedy", "sampled", "top_k", "spec")


def _lane_kwargs(lane: str) -> dict:
    return {
        "greedy": {},
        "sampled": {"temperature": 1.0, "seed": 1234},
        "top_k": {"temperature": 0.7, "top_k": 7, "seed": 77},
        "spec": {"speculative": 4},
    }[lane]


def _prompt(rank: int, n: int) -> np.ndarray:
    return np.asarray([(rank * 37 + i * 11 + 5) % 256 for i in range(n)],
                      np.int32)


def _post(port: int, body: dict, timeout: float = 180.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _spill_arm(config, params, *, spill_mb, corpus: int,
               prompt_len: int, rounds: int, prefix_blocks: int,
               max_new: int, device="cuda") -> dict:
    """One throughput arm: the same corpus replay with the spill tier on
    (``spill_mb``) or off (None).  A warm-up round builds every chain
    cold and an unmeasured settle round pays the arm's first promotions,
    so the measured rounds compare steady states."""
    from k8s_tpu_torch.models.engine import Engine

    eng = Engine(config, params, slots=2, queue_limit=64,
                 block_size=16, prefix_blocks=prefix_blocks,
                 spill_mb=spill_mb, device=device)
    try:
        prompts = [_prompt(r, prompt_len) for r in range(corpus)]

        def replay() -> int:
            emitted = 0
            for p in prompts:
                emitted += len(eng.submit(p, max_new))
            return emitted

        replay()  # warm-up: every chain cold
        replay()  # settle: the first promotions, unmeasured
        s0 = eng.stats()
        t0 = time.monotonic()
        tokens = sum(replay() for _ in range(rounds))
        wall = time.monotonic() - t0
        s1 = eng.stats()
        submitted = rounds * corpus * prompt_len
        saved = s1["prefix_tokens_saved"] - s0["prefix_tokens_saved"]
        return {
            "spill_mb": spill_mb,
            "rounds": rounds,
            "corpus": corpus,
            "wall_s": round(wall, 3),
            "tokens": tokens,
            "tokens_per_s": round(tokens / wall, 2) if wall else None,
            "prefix_hit_rate": round(saved / submitted, 4),
            "prefix_tokens_saved": int(saved),
            "spill_demotions": int(s1["spill_demotions"]),
            "spill_promotions": int(s1["spill_promotions"]),
            "spill_blocks": int(s1["spill_blocks"]),
            "spill_bytes": int(s1["spill_bytes"]),
            "tree_evictions": int(s1["tree_evictions"]),
        }
    finally:
        eng.shutdown()


def _spill_identity(config, params, *, prompt_len: int, max_new: int,
                    failures: list, spill_mb: int = 32,
                    device="cuda") -> dict:
    """Fixed-seed identity through demote -> promote on every lane, on an
    int8 KV pool: spill stores int8 pools raw, so the crossing is
    bit-exact (a bf16 pool is also stored raw; an f32 pool int8-quantizes
    and is lossy, as on the migration wire)."""
    from k8s_tpu_torch.models.engine import Engine

    cfg8 = dataclasses.replace(config, kv_cache_dtype="int8")
    eng = Engine(cfg8, params, slots=2, queue_limit=32, block_size=16,
                 prefix_blocks=6, spill_mb=spill_mb, device=device)
    out: dict = {}
    try:
        prompts = {lane: _prompt(500 + i, prompt_len)
                   for i, lane in enumerate(LANES)}
        refs = {lane: eng.submit(prompts[lane], max_new,
                                 **_lane_kwargs(lane))
                for lane in LANES}
        # filler flood: enough distinct chains to push every lane's
        # blocks out of the tree and into the spill tier
        for r in range(8):
            eng.submit(_prompt(900 + r, prompt_len), 2)
        if eng.stats()["spill_demotions"] < 1:
            failures.append(
                "spill identity: the filler flood never demoted a "
                "block — the pool is too large for the flood, retune")
        for lane in LANES:
            before = eng.stats()["spill_promotions"]
            got = eng.submit(prompts[lane], max_new,
                             **_lane_kwargs(lane))
            promoted = eng.stats()["spill_promotions"] - before
            ok = got == refs[lane]
            out[lane] = {"ok": ok, "promoted_blocks": int(promoted)}
            if promoted < 1:
                failures.append(
                    f"spill identity [{lane}]: the re-ask never "
                    "promoted from the spill tier (blocks were still "
                    "in-tree), so this lane proved nothing — retune")
            if not ok:
                failures.append(
                    f"spill identity [{lane}]: fixed-seed output "
                    f"through demote->promote differs from the cold "
                    f"answer (ref {refs[lane][:6]}... vs got "
                    f"{got[:6]}...): the spill tier changed the math")
        return out
    finally:
        eng.shutdown()


def _dedup_storm(config, params, *, base_len: int, tail_len: int,
                 storm: int, max_new: int, failures: list,
                 device="cuda") -> dict:
    """Repeated-prefix migration storm and per-lane identity through a
    deduped migration, on two real LmServers over real sockets."""
    from k8s_tpu_torch.models import server as server_mod
    from k8s_tpu_torch.models.engine import Engine
    from k8s_tpu_torch.util import metrics as metrics_mod

    # the local oracle first (shut down before the servers start)
    base = _prompt(7, base_len)
    lane_prompts = {
        lane: np.concatenate([base, _prompt(700 + i, tail_len)])
        for i, lane in enumerate(LANES)}
    ref_eng = Engine(config, params, slots=2, queue_limit=16,
                     block_size=16, device=device)
    try:
        refs = {lane: ref_eng.submit(lane_prompts[lane], max_new,
                                     **_lane_kwargs(lane))
                for lane in LANES}
    finally:
        ref_eng.shutdown()

    sender = server_mod.LmServer(
        config=config, params=params, slots=4, queue_limit=64,
        role="prefill", registry=metrics_mod.Registry(), device=device)
    try:
        receiver = server_mod.LmServer(
            config=config, params=params, slots=4, queue_limit=64,
            role="decode", kvxfer_port=0, registry=metrics_mod.Registry(),
            device=device)
    except BaseException:
        sender.close()
        raise
    httpd = server_mod.serve(sender)
    port = httpd.server_address[1]
    kv_dest = f"127.0.0.1:{receiver._kv_receiver.port}"
    try:
        # warm both engines on a chain disjoint from the storm's shared
        # base, so the storm's first migration is the cold one
        warm = [int(t) for t in _prompt(999, base_len + tail_len)]
        _post(port, {"tokens": warm, "max_new_tokens": max_new})
        _post(port, {"tokens": warm, "max_new_tokens": max_new,
                     "kv_dest": kv_dest})

        skipped0 = sender.metrics["kvxfer_dedup_skipped"].value
        for r in range(storm):
            tokens = [int(t) for t in
                      np.concatenate([base, _prompt(800 + r, tail_len)])]
            _post(port, {"tokens": tokens, "max_new_tokens": max_new,
                         "kv_dest": kv_dest})
        skipped = int(sender.metrics["kvxfer_dedup_skipped"].value
                      - skipped0)
        # estimated wire bytes a block, read off the sender's own cached
        # chain (the arrays a full frame would ship)
        manifest = sender.engine.fetch_prefix(base)
        if manifest and manifest["n_blocks"]:
            per_block = sum(a.nbytes
                            for a in manifest["blocks"].values()) \
                / manifest["n_blocks"]
        else:
            per_block = 0.0
        bytes_saved = int(skipped * per_block)
        if skipped < 1:
            failures.append(
                "dedup storm: the fingerprint handshake never skipped "
                "a block across a repeated-prefix migration storm")
        elif bytes_saved < 1:
            failures.append(
                "dedup storm: blocks were skipped but the estimated "
                "wire bytes saved is zero — the block footprint "
                "estimate is broken")

        identity: dict = {}
        for lane in LANES:
            before = receiver.engine.stats()["kv_blocks_deduped"]
            got = _post(port, {
                "tokens": [int(t) for t in lane_prompts[lane]],
                "max_new_tokens": max_new,
                **_lane_kwargs(lane), "kv_dest": kv_dest})["tokens"]
            deduped = receiver.engine.stats()["kv_blocks_deduped"] \
                - before
            ok = got == refs[lane]
            identity[lane] = {"ok": ok,
                              "deduped_blocks": int(deduped)}
            if deduped < 1:
                failures.append(
                    f"migration identity [{lane}]: the migration was "
                    "never deduped (the storm should have seeded the "
                    "receiver's tree with the shared base) — this "
                    "lane proved nothing")
            if not ok:
                failures.append(
                    f"migration identity [{lane}]: fixed-seed output "
                    f"through a deduped migration differs from local "
                    f"(local {refs[lane][:6]}... vs routed "
                    f"{got[:6]}...): dedup changed the math")
        return {
            "storm_requests": storm,
            "skipped_blocks": skipped,
            "bytes_saved_est": bytes_saved,
            "wire_bytes_per_block_est": int(per_block),
            "receiver_blocks_deduped": int(
                receiver.engine.stats()["kv_blocks_deduped"]),
            "identity": identity,
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        sender.close()
        receiver.close()


def run_bench(corpus: int = 24, rounds: int = 3, prompt_len: int = 96,
              prefix_blocks: int = 12, spill_mb: int = 16,
              max_new: int = 4, storm: int = 6, hidden: int = 256,
              layers: int = 2, device="cuda") -> dict:
    from k8s_tpu_torch.harness.bench_serve import build_model

    failures: list[str] = []
    config, params = build_model(0, hidden=hidden, layers=layers,
                                 device=device)

    arm_kw = dict(corpus=corpus, prompt_len=prompt_len, rounds=rounds,
                  prefix_blocks=prefix_blocks, max_new=max_new,
                  device=device)
    arms = {
        "spill": _spill_arm(config, params, spill_mb=spill_mb, **arm_kw),
        "baseline": _spill_arm(config, params, spill_mb=None, **arm_kw),
    }
    sp, bl = arms["spill"], arms["baseline"]
    failures += spill_failures(sp, bl)

    spill_identity = _spill_identity(config, params,
                                     prompt_len=80, max_new=8,
                                     failures=failures, device=device)
    dedup = _dedup_storm(config, params, base_len=64, tail_len=16,
                         storm=storm, max_new=8, failures=failures,
                         device=device)

    result = {
        "metric": "kvtier_spill_speedup",
        "value": round(sp["tokens_per_s"] / bl["tokens_per_s"], 3)
        if sp["tokens_per_s"] and bl["tokens_per_s"] else None,
        "unit": "x_tokens_per_s_vs_evict_recompute",
        "model": {"hidden": hidden, "layers": layers},
        "workload": {"corpus": corpus, "rounds": rounds,
                     "prompt_len": prompt_len,
                     "prefix_blocks": prefix_blocks,
                     "spill_mb": spill_mb, "max_new": max_new,
                     "storm": storm},
        "spill": sp,
        "baseline": bl,
        "spill_identity": spill_identity,
        "dedup": dedup,
    }
    if failures:
        result["failures"] = failures
        err = RuntimeError("kvtier bench assertions failed:\n  "
                           + "\n  ".join(failures))
        err.result = result
        raise err
    return result


def spill_failures(sp: dict, bl: dict) -> list[str]:
    """The spill arm's assertions against the evict-recompute arm."""
    failures = []
    if sp["spill_demotions"] < 1 or sp["spill_promotions"] < 1:
        failures.append(
            "spill arm never demoted/promoted "
            f"({sp['spill_demotions']}/{sp['spill_promotions']}): the "
            "corpus does not pressure the pool, the bench proves "
            "nothing — retune it")
    if not (sp["tokens_per_s"] and bl["tokens_per_s"]
            and sp["tokens_per_s"] > bl["tokens_per_s"]):
        failures.append(
            f"spill tokens/s ({sp['tokens_per_s']}) does not strictly "
            f"beat evict-recompute ({bl['tokens_per_s']}) on the same "
            "traffic: promoting from host RAM lost to re-prefilling")
    if not sp["prefix_hit_rate"] > bl["prefix_hit_rate"]:
        failures.append(
            f"spill post-warmup prefix hit rate "
            f"({sp['prefix_hit_rate']}) does not strictly beat the "
            f"baseline ({bl['prefix_hit_rate']})")
    return failures


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", type=int, default=24)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--prompt-len", type=int, default=96)
    p.add_argument("--prefix-blocks", type=int, default=12)
    p.add_argument("--spill-mb", type=int, default=16)
    p.add_argument("--storm", type=int, default=6)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for the plain versions")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    def _write(payload: dict) -> None:
        line = json.dumps(payload)
        print(line)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(line + "\n")

    try:
        result = run_bench(
            corpus=args.corpus, rounds=args.rounds,
            prompt_len=args.prompt_len,
            prefix_blocks=args.prefix_blocks, spill_mb=args.spill_mb,
            storm=args.storm, hidden=args.hidden, layers=args.layers,
            device=args.device)
    except RuntimeError as e:
        partial = getattr(e, "result", None)
        if partial is not None:
            _write(partial)
        raise
    _write(result)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
