"""The port's disaggregated-serving bench (k8s_tpu_torch/harness/
bench_disagg.py) and its copy of the router's phase split
(k8s_tpu_torch/harness/disagg_router.py) against the JAX package's
(k8s_tpu/harness/bench_disagg.py, k8s_tpu/router/) on the CPU: the
prompts, defaults, fingerprints, ring walks, placements and phase split
are the reference's; the retry walk forwards the reference's bodies to
live backends; the exposition reader reads what the fleet parser reads;
the judgment gives the reference's results and failure messages on the
same arms; and one real disaggregated arm (three pod processes at tiny
size) holds greedy and sampled identity against the local oracle."""

from __future__ import annotations

import copy
import inspect
import json
import os
import random
import re
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from k8s_tpu.fleet import parser as ref_parser
from k8s_tpu.harness import bench_disagg as ref
from k8s_tpu.router import ring as ref_ring
from k8s_tpu.router import router as ref_router
from k8s_tpu_torch.harness import bench_disagg as bd
from k8s_tpu_torch.harness import disagg_router as dr
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- prompts and defaults -----------------------------------------------------

@pytest.mark.parametrize("rank,i,n", [(0, 0, 8), (3, 17, 8), (901, 64, 64),
                                      (900, 0, 1), (250, 9, 33)])
def test_short_prompt_is_the_references(rank, i, n):
    assert bd._short_prompt(rank, i, n) == ref._short_prompt(rank, i, n)
    assert bd._short_prompt(rank, i) == ref._short_prompt(rank, i)


@pytest.mark.parametrize("rank,i,n", [(7, 7, 112), (100, 3005, 112),
                                      (900, 2, 112), (105, 0, 48),
                                      (0, 0, 1)])
def test_long_prompt_is_the_references(rank, i, n):
    assert bd._long_prompt(rank, i, n) == ref._long_prompt(rank, i, n)


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("name", ["run_bench", "_closed_loop_phase",
                                  "_run_arm", "_reference_outputs"])
def test_defaults_are_the_references(name):
    want = _defaults(getattr(ref, name))
    got = _defaults(getattr(bd, name))
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) <= {"model", "device"}
    assert (bd.DEFAULT_FLAT_FACTOR, bd.DEFAULT_CONVOY_FACTOR, bd.POD_READY) \
        == (ref.DEFAULT_FLAT_FACTOR, ref.DEFAULT_CONVOY_FACTOR,
            ref.POD_READY)


# -- the ring -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("block_size", [1, 8, 16])
def test_fingerprints_are_the_references(seed, block_size):
    rng = random.Random(seed)
    for n in (0, 1, block_size - 1, block_size, 2 * block_size + 3, 112):
        toks = [rng.randrange(256) for _ in range(n)]
        assert dr.fingerprint_tokens(toks, block_size) == \
            ref_ring.fingerprint_tokens(toks, block_size)
        for req in ({"tokens": toks}, {"text": bytes(toks).decode(
                "latin-1")}, {"tokens": ["x"]}, {}):
            assert dr.fingerprint_request(req, block_size) == \
                ref_ring.fingerprint_request(req, block_size)


@pytest.mark.parametrize("nodes", [
    ["pod-0", "pod-1", "pod-2"],
    ["pod-prefill-0", "pod-decode-1", "pod-decode-2"],
    ["a", "b", "c", "d", "e"], ["only"], []])
def test_ring_walks_are_the_references(nodes):
    ours, theirs = dr.HashRing(), ref_ring.HashRing()
    for ring in (ours, theirs):
        ring.replace(nodes)
    rng = random.Random(len(nodes))
    keys = [ref_ring.fingerprint_tokens(
        [rng.randrange(256) for _ in range(32)], 16) for _ in range(64)]
    for key in keys:
        assert ours.candidates(key) == theirs.candidates(key)
    # membership edits keep matching
    for ring in (ours, theirs):
        ring.replace(nodes[1:])
        ring.add("late")
        ring.remove("b")
    for key in keys:
        assert ours.candidates(key) == theirs.candidates(key)


# -- placement ----------------------------------------------------------------

SPLIT = [("pod-prefill-0", "http://127.0.0.1:9/metrics", "prefill", None),
         ("pod-decode-1", "http://127.0.0.1:10", "decode", "127.0.0.1:20"),
         ("pod-decode-2", "http://127.0.0.1:11", "decode", "127.0.0.1:21")]
COLLAPSED = [("pod-0", "http://127.0.0.1:9"), ("pod-1", "http://127.0.0.1:10"),
             ("pod-2", "http://127.0.0.1:11")]


def _requests() -> list[dict]:
    out = []
    for k in range(6):
        out.append({"tokens": bd._short_prompt(k, k),
                    "max_new_tokens": 17})
        out.append({"tokens": bd._long_prompt(100 + k, k, 112),
                    "max_new_tokens": 5})
        out.append({"tokens": bd._long_prompt(100 + k, k, 112),
                    "max_new_tokens": 5, "kv_dest": "127.0.0.1:21"})
    out.append({"tokens": bd._long_prompt(7, 7, 40)})  # under the split
    out.append({"tokens": [1, 2, 3]})  # no full block
    return out


def _routers(targets, **kw):
    theirs = ref_router.Router(lambda: targets, **kw)
    ours = dr.Router(lambda: targets, **kw)
    assert theirs.refresh_once() == ours.refresh_once() == len(targets)
    return ours, theirs


@pytest.mark.parametrize("targets", [SPLIT, COLLAPSED],
                         ids=["split", "collapsed"])
@pytest.mark.parametrize("shed", [None, 0, 1, 2])
def test_plans_are_the_references(targets, shed):
    ours, theirs = _routers(targets, block_size=16, phase_split_tokens=48)
    if shed is not None:
        # a 503 from one pod: the affine plan falls back to the
        # least-outstanding walk on both
        for r in (ours, theirs):
            r._note_success(targets[shed][0], 503)
    for req in _requests():
        assert ours.plan(req) == theirs.plan(req)
        assert ours.plan_disagg(req) == theirs.plan_disagg(req)


def test_inflight_orders_the_fallback_as_the_reference():
    ours, theirs = _routers(COLLAPSED, block_size=16)
    for r in (ours, theirs):
        r._backends["pod-0"].inflight = 2
        r._backends["pod-2"].inflight = 1
    for req in _requests():
        assert ours.plan(req) == theirs.plan(req)


# -- the retry walk against live backends -------------------------------------

class _Fake:
    """A stdlib backend that records each POST body and answers from a
    script of statuses (then 200s echoing the tokens)."""

    def __init__(self):
        fake = self
        self.bodies: list = []
        self.script: list = []
        self.lock = threading.Lock()

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                with fake.lock:
                    fake.bodies.append(body)
                    status = fake.script.pop(0) if fake.script else 200
                out = json.dumps({"tokens": body.get("tokens", [])[:3]}
                                 if status == 200 else
                                 {"error": "shedding"}).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                if status == 503:
                    self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(out)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True).start()
        self.url = "http://127.0.0.1:%d" % self.httpd.server_address[1]


@pytest.fixture(scope="module")
def fakes():
    f = [_Fake(), _Fake()]
    yield f
    for x in f:
        x.httpd.shutdown()
        x.httpd.server_close()


def _walk(router_cls, fakes, n_prefill, statuses, reqs):
    a, b = fakes
    targets = [(f"pre-{k}", (a, b)[k % 2].url, "prefill")
               for k in range(n_prefill)]
    targets += [("dec-a", b.url, "decode", "127.0.0.1:7001"),
                ("dec-b", a.url, "decode", "127.0.0.1:7002"),
                ("dec-c", b.url, "decode", "127.0.0.1:7003")]
    for f in fakes:
        f.bodies, f.script = [], list(statuses)
    r = router_cls(lambda: targets, block_size=16, phase_split_tokens=48)
    r.refresh_once()
    out = []
    try:
        for req in reqs:
            status, headers, body, info = r.handle_generate(
                json.dumps(req).encode(), {})
            out.append((status, json.loads(body), headers.get(
                "X-Router-Backend"), info["attempts"]))
    finally:
        r.stop()
    return out, [list(f.bodies) for f in fakes]


@pytest.mark.parametrize("n_prefill", [1, 2, 4])
@pytest.mark.parametrize("statuses", [[503] * 8, [503, 200], [500, 503]],
                         ids=["all_shed", "one_shed", "error_then_shed"])
def test_handle_generate_forwards_the_references_bodies(fakes, n_prefill,
                                                        statuses):
    reqs = [{"tokens": bd._long_prompt(7, 7, 112), "max_new_tokens": 5},
            {"tokens": bd._short_prompt(1, 2), "max_new_tokens": 17},
            {"tokens": bd._long_prompt(8, 1, 64), "max_new_tokens": 5,
             "temperature": 1.0, "seed": 3}]
    theirs = _walk(ref_router.Router, fakes, n_prefill, statuses, reqs)
    ours = _walk(dr.Router, fakes, n_prefill, statuses, reqs)
    assert ours == theirs
    # the first (long) request: one attempt a prefill pod within the
    # retry budget (2), its kv_dest rotating over the decode tier
    seen = [b for bodies in ours[1] for b in bodies
            if b["tokens"] == reqs[0]["tokens"]]
    if statuses[:2] == [503, 503]:
        assert len(seen) == min(n_prefill, 1 + dr.RETRY_BUDGET)
    dests = [b["kv_dest"] for b in seen]
    assert len(set(dests)) == len(dests)
    assert set(dests) <= {"127.0.0.1:7001", "127.0.0.1:7002",
                          "127.0.0.1:7003"}


# -- the exposition reader ----------------------------------------------------

def test_sample_value_reads_what_the_fleet_parser_reads():
    from k8s_tpu_torch.util import metrics as metrics_mod

    reg = metrics_mod.Registry()
    m = metrics_mod.serving_metrics(reg)
    m["prefill_convoy"].inc(3)
    m["kv_migrated"].inc(41)
    for s in (0.003, 0.02, 0.7, 12.5):
        m["kv_migrate"].observe(s)
    m["tokens"].inc(1234)
    m["requests"].labels("ok").inc(5)
    text = reg.expose()
    unlabeled = [(name, value)
                 for fam in ref_parser.parse_exposition(text).values()
                 for name, labels, value in fam.samples if not labels]
    names = {n for n, _ in unlabeled}
    assert {"serve_prefill_convoy_total", "serve_kv_blocks_migrated_total",
            "serve_kv_migrate_seconds_sum",
            "serve_kv_migrate_seconds_count"} <= names
    for name, value in unlabeled:
        assert dr.sample_value(text, name) == value, name
    assert dr.sample_value(text, "serve_requests_total") is None  # labeled
    assert dr.sample_value(text, "no_such_metric") is None


# -- the judgment -------------------------------------------------------------

def _phase(p99, errors=0, blocks=None):
    out = {"short_p99_s": p99, "error_count": errors,
           "errors": [f"HTTPError: HTTP Error 503 #{k}"
                      for k in range(min(errors, 5))]}
    if blocks is not None:
        out["blocks_migrated"] = blocks
    return out


def _arms(case):
    ok_tokens = [5, 6, 7, 8, 9, 10, 11]
    dis = {"topology": "disaggregated", "prefill_convoys_total": 0,
           "phases": {"unloaded": _phase(0.1, blocks=0),
                      "storm1x": _phase(0.105, blocks=40),
                      "storm2x": _phase(0.11, blocks=70)},
           "identity": {"greedy": {"ok": True, "local": ok_tokens,
                                   "routed": ok_tokens},
                        "sampled": {"ok": True, "local": ok_tokens,
                                    "routed": ok_tokens},
                        "migrations": 2},
           "migrations": 30}
    col = {"topology": "collapsed", "prefill_convoys_total": 9,
           "phases": {"unloaded": _phase(0.1), "storm1x": _phase(0.2),
                      "storm2x": _phase(0.3)}}
    if case == "flat_broken":
        dis["phases"]["storm2x"]["short_p99_s"] = 0.15
    elif case == "convoy_broken":
        col["phases"]["storm2x"]["short_p99_s"] = 0.15
    elif case == "no_convoys":
        col["prefill_convoys_total"] = 0
    elif case == "identity_broken":
        dis["identity"]["sampled"] = {"ok": False, "local": ok_tokens,
                                      "routed": ok_tokens[::-1]}
    elif case == "no_migration":
        dis["identity"]["migrations"] = 0
        for p in ("storm1x", "storm2x"):
            dis["phases"][p]["blocks_migrated"] = 0
    elif case == "request_errors":
        dis["phases"]["storm1x"] = _phase(0.1, errors=2, blocks=3)
        col["phases"]["unloaded"] = _phase(0.1, errors=7)
    elif case == "no_latencies":
        col["phases"]["unloaded"]["short_p99_s"] = None
    return {"disaggregated": dis, "collapsed": col}


def _judged(mod, monkeypatch, case, **kw):
    arms = _arms(case)
    monkeypatch.setattr(mod, "_reference_outputs", lambda *a, **k: [])
    monkeypatch.setattr(
        mod, "_run_arm", lambda **k: copy.deepcopy(
            arms["disaggregated" if k["disagg"] else "collapsed"]))
    try:
        return mod.run_bench(**kw), None
    except RuntimeError as e:
        return e.result, str(e)


@pytest.mark.parametrize("case", [
    "pass", "flat_broken", "convoy_broken", "no_convoys", "identity_broken",
    "no_migration", "request_errors", "no_latencies"])
def test_judgment_is_the_references(monkeypatch, case):
    theirs = _judged(ref, monkeypatch, case)
    ours = _judged(bd, monkeypatch, case, device="cpu")
    assert ours == theirs
    assert (theirs[1] is None) == (case == "pass")


def test_judge_does_not_raise_and_keeps_the_arms():
    arms = _arms("flat_broken")
    workload = dict(shorts=4, longs=3, slots=12, duration_s=4.0,
                    max_new_short=17, max_new_long=5, long_len=112,
                    phase_tokens=48, hidden=256, layers=4)
    model = {"preset": "llama_8b", "layers": 16}
    result, failures = bd.judge(arms, **workload, model=model)
    assert failures == result["failures"] and len(failures) == 1
    assert failures[0].startswith("disaggregated decode p99 degraded 1.50x")
    assert result["model"] == model
    assert "identity" not in result["disaggregated"]


# -- the real thing, at tiny size ---------------------------------------------

def test_disaggregated_arm_holds_identity(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    probes = bd._reference_outputs(112, 12, 64, 2, device="cpu")
    arm = bd._run_arm(disagg=True, slots=12, phase_tokens=48, shorts=4,
                      longs=3, duration_s=0.5, max_new_short=17,
                      max_new_long=5, long_len=112, hidden=64, layers=2,
                      identity_probes=probes, device="cpu")
    ident = arm["identity"]
    for lane in ("greedy", "sampled"):
        assert ident[lane]["ok"], ident[lane]
        assert len(ident[lane]["routed"]) == 12
    assert ident["migrations"] >= 1
    assert all(p["error_count"] == 0 for p in arm["phases"].values()), arm
    assert sum(arm["phases"][p]["blocks_migrated"]
               for p in ("storm1x", "storm2x")) >= 1
    assert arm["migrations"] >= 1 and arm["kv_imports"] >= 1
    pods = arm["pods"]
    assert [p["role"] for p in pods] == ["prefill", "decode", "decode"]
    digests = {json.dumps(p["weights"], sort_keys=True) for p in pods}
    assert len(digests) == 1
    import torch

    local = bd.weights_digest(bd.build_pod_model(None, 64, 2, "cpu")[1])
    assert pods[0]["weights"] == local
    for p in pods:
        assert p["exit_code"] == 0 and p["stats"] is not None, p
        assert p["stats"]["model_calls"] > 0
        # the plain versions on the CPU: no kernel launched
        assert not any(p["stats"]["launches"].values())
    assert torch.get_num_threads() == 1


def test_pod_asked_for_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")  # the CPU sandbox has none
    with pytest.raises(RuntimeError) as e:
        bd._SubprocPod(role="", cpus=None, slots=2, hidden=64, layers=2,
                       device="cuda", timeout=120).wait_ready()
    assert "died during bring-up" in str(e.value)
    assert "torch.cuda.is_available() is False" in str(e.value)
    with pytest.raises(RuntimeError, match="is_available"):
        bd.measure(device="cuda")


# -- isolation ----------------------------------------------------------------

@pytest.mark.parametrize("module", ["bench_disagg", "disagg_router"])
def test_module_names_nothing_of_the_jax_package(module):
    src = open(os.path.join(REPO, "k8s_tpu_torch", "harness",
                            module + ".py")).read()
    assert not re.findall(r"k8s_tpu\.(?!_torch)", src.replace(
        "k8s_tpu_torch", "")), "a dotted k8s_tpu name (import or -m)"
    code = (f"import sys, k8s_tpu_torch.harness.{module}; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'flax') "
            "or m == 'k8s_tpu' or m.startswith('k8s_tpu.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
