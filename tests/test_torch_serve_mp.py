"""Multi-process serving gangs of the port (models/mp_serve.py,
models/server.py's mesh route) as real processes over gloo on the CPU.

A 2-process gang (``run_serve_gang``) must exit ``[0, 0]`` with the
tokens a 1-process gang gives on the three-lane fixed-seed script, its
follower's ``SERVE_MP_WORKER`` line showing half the pool; the
chief-crash drill kills process 0 in steady state and the follower must
exit non-zero, not hang, within ``mesh_serve.COLLECTIVE_TIMEOUT_S`` of
the kill; members started under the operator's own env
(``tests/torch_world.py``) must give the same tokens; and ``python -m
k8s_tpu_torch.models.server`` with ``K8S_TPU_SERVE_MESH=2`` must answer
over HTTP what a local server answers on the same artifact, and exit 0
on both processes when the chief is interrupted.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import pytest

from k8s_tpu_torch.models import mesh_serve, mp_serve
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_world  # noqa: E402

SCRIPT = mp_serve.default_script(1)


def _outputs(res):
    return "\n".join(f"--- proc {i} rc={res.exit_codes[i]} ---\n{out[-2000:]}"
                     for i, out in enumerate(res.worker_outputs))


@pytest.fixture(scope="module")
def gangs():
    out = {}
    for n in (1, 2):
        res, workers = mp_serve.run_serve_gang(n, script=SCRIPT, timeout=180)
        assert res.success, _outputs(res)
        out[n] = (res, workers)
    return out


def test_gangs_exit_clean(gangs):
    for n, (res, _) in gangs.items():
        assert res.exit_codes == [0] * n


def test_two_process_tokens_equal_one_process(gangs):
    one = gangs[1][0].chief_result
    two = gangs[2][0].chief_result
    assert one["results"] == two["results"]
    assert all(one["results"]) and not two["errors"]
    assert (two["num_processes"], two["tp_degree"], two["mesh_shape"],
            two["placement"]) == (2, 2, {"tp": 2}, "mesh")
    assert (one["num_processes"], one["tp_degree"]) == (1, 1)
    assert two["pool_local_fraction"] == 0.5
    assert one["pool_local_fraction"] == 1.0
    assert two["compile_ledger"] is None


def test_follower_line_shows_half_the_pool(gangs):
    _, workers = gangs[2]
    assert len(workers) == 1
    w = workers[0]
    assert (w["process_id"], w["tp_rank"]) == (1, 1)
    assert w["pool_local_fraction"] == 0.5
    assert 0.5 < w["params_local_fraction"] < 1
    assert w["compile_ledger"] is None and w["ops"] > 0
    bus = gangs[2][0].chief_result["plan_bus"]
    # every broadcast but the pool's init message is a replayed op
    assert bus["pipelined"] and bus["broadcasts"] == w["ops"] + 1
    assert bus["send_error"] is None and bus["bytes"] > 0
    assert gangs[1][0].chief_result["plan_bus"] is None


def test_chief_crash_makes_the_follower_exit_nonzero():
    """Process 0 is killed half a second after its plan bus took the
    follower, inside a long script: the follower is then either parked on
    the plan bus (EOF) or inside a collective (gloo sees the peer go),
    and must exit non-zero well inside the bound."""
    res, _ = mp_serve.run_serve_gang(
        2, script=mp_serve.default_script(40, 32), kill_chief_after=0.5,
        kill_chief_when="plan bus: worker 1/1 connected", timeout=150)
    assert res.chief_killed_s is not None, _outputs(res)
    assert res.exit_codes[0] != 0
    assert res.exit_codes[1] is not None, "the follower hung: " + \
        _outputs(res)
    assert res.exit_codes[1] != 0, _outputs(res)
    assert res.exit_s[1] - res.chief_killed_s < \
        mesh_serve.COLLECTIVE_TIMEOUT_S


def test_members_under_the_operator_env(gangs, tmp_path):
    path = tmp_path / "script.json"
    path.write_text(json.dumps(SCRIPT))
    rcs, outs = torch_world.spawn(
        2, ["-m", "k8s_tpu_torch.models.mp_serve", "--script", str(path)],
        extra_env={"K8S_TPU_SERVE_MESH": "2",
                   "K8S_TPU_SERVE_PLAN_PORT": str(mp_serve.free_port())},
        timeout=180)
    assert rcs == [0, 0], "\n".join(o[-2000:] for o in outs)
    chief = [json.loads(line[len(mp_serve.CHIEF_OK):])
             for line in outs[0].splitlines()
             if line.startswith(mp_serve.CHIEF_OK)]
    assert chief and chief[0]["results"] == \
        gangs[1][0].chief_result["results"]
    assert any(line.startswith(mp_serve.WORKER_OK)
               for line in outs[1].splitlines())


def _post(url, body):
    r = urllib.request.Request(url + "/v1/generate",
                               data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=60) as resp:
        return json.loads(resp.read())["tokens"]


def test_server_entry_serves_a_two_process_mesh(tmp_path):
    from k8s_tpu_torch.models import serving
    from k8s_tpu_torch.models.server import LmServer
    from k8s_tpu_torch.util import metrics as metrics_mod

    config, params = mp_serve.build_model(3)
    serving.export_serving(str(tmp_path), config, params)
    requests = [{"tokens": [5, 9, 2, 7, 1], "max_new_tokens": 6},
                {"tokens": [3, 3, 8], "max_new_tokens": 5,
                 "temperature": 0.9, "seed": 4},
                {"tokens": [1, 2, 3, 1, 2, 3, 1], "max_new_tokens": 6,
                 "speculative": 3}]
    lm = LmServer(train_dir=str(tmp_path), device="cpu",
                  registry=metrics_mod.Registry())
    try:
        from k8s_tpu_torch.models.server import parse_request
        want = [lm.generate(parse_request(config, r, 8))["tokens"]
                for r in requests]
    finally:
        lm.close()

    envs = torch_world.gang_envs(2, extra_env={
        "K8S_TPU_SERVE_MESH": "2",
        "K8S_TPU_SERVE_PLAN_PORT": str(mp_serve.free_port())})
    argv = [sys.executable, "-m", "k8s_tpu_torch.models.server",
            "--train_dir", str(tmp_path), "--port", "0"]
    follower_log = tempfile.TemporaryFile()
    chief = subprocess.Popen(argv, env=envs[0], cwd=torch_world.REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    follower = subprocess.Popen(argv, env=envs[1], cwd=torch_world.REPO,
                                stdout=follower_log,
                                stderr=subprocess.STDOUT)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in chief.stdout],
                     daemon=True).start()
    seen = []
    try:
        url = None
        deadline = time.time() + 120
        while url is None and time.time() < deadline:
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                assert chief.poll() is None, "".join(seen)
                continue
            seen.append(line)
            if line.startswith("READY "):
                url = line.split()[1]
        assert url, "".join(seen)
        got = [_post(url, r) for r in requests]
        health = json.loads(urllib.request.urlopen(
            url + "/healthz", timeout=30).read())["serving"]
        chief.send_signal(signal.SIGINT)
        rcs = [chief.wait(timeout=60), follower.wait(timeout=60)]
    finally:
        for p in (chief, follower):
            if p.poll() is None:
                p.kill()
                p.wait()
        follower_log.seek(0)
        tail = follower_log.read().decode(errors="replace")[-2000:]
        follower_log.close()
    assert got == want
    assert (health["placement"], health["tp_degree"],
            health["num_processes"]) == ("mesh", 2, 2)
    assert rcs == [0, 0], tail
    assert mp_serve.WORKER_OK in tail
