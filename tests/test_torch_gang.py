"""The port's in-pod payloads under the reference's unchanged gang harness:
``k8s_tpu.e2e.multiprocess.run_gang(n, module=...)`` builds each worker's
env with the operator's ``gen_env_vars`` (``K8S_TPU_PLATFORM=cpu``), runs
``python -m k8s_tpu_torch.e2e.rendezvous_worker`` (or the port's
``launcher.tpu_smoke``) as N real processes and classifies the gang's
exit as the operator classifies a dead pod.  The scenarios are those of
``tests/test_multiprocess_e2e.py``; the port's workers join a gloo world
in seconds, so they run in tier-1.
"""

import math

import pytest

from k8s_tpu.e2e import multiprocess
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

WORKER = "k8s_tpu_torch.e2e.rendezvous_worker"


def _gang(n, **kw):
    res = multiprocess.run_gang(n, module=kw.pop("module", WORKER),
                                timeout=kw.pop("timeout", 120), **kw)
    return res


def _explain(res):
    return "\n".join(f"--- worker {i} rc={res.exit_codes[i]} ---\n"
                     f"{out[-2000:]}"
                     for i, out in enumerate(res.worker_outputs))


@pytest.fixture(scope="module")
def gang4():
    res = _gang(4)
    assert res.success, _explain(res)
    return res


def test_four_workers_are_one_world(gang4):
    assert gang4.exit_codes == [0, 0, 0, 0]
    assert gang4.restart_decision == "succeeded"
    chief = gang4.chief_result
    assert chief["num_processes"] == 4 and chief["global_devices"] == 4
    # membership: each process adds pid + 1, so 1+2+3+4; four separate
    # one-process worlds cannot produce it
    assert chief["membership_sum"] == 10.0


def test_four_workers_train_one_sharded_step(gang4):
    chief = gang4.chief_result
    assert math.isfinite(chief["loss"]) and chief["step"] == 1
    assert math.prod(chief["mesh"].values()) == 4
    assert chief["mesh"]["fsdp"] == 4
    assert set(chief) == {"process_id", "num_processes", "is_chief",
                          "global_devices", "mesh", "num_slices",
                          "membership_sum", "loss", "step", "start_step"}


def test_two_slice_gang_builds_the_hybrid_mesh():
    res = _gang(4, num_slices=2)
    assert res.success, _explain(res)
    chief = res.chief_result
    assert chief["num_slices"] == 2
    assert chief["mesh"]["dp"] == 2  # across the two slices
    assert chief["mesh"]["dp"] * chief["mesh"]["fsdp"] == 4


def test_preempted_gang_resumes_to_the_control_loss(tmp_path):
    env = {"K8S_TPU_E2E_STEPS": "4", "K8S_TPU_E2E_CKPT_EVERY": "1",
           "CHECKPOINT_DIR": str(tmp_path / "gang-ckpt")}
    first = _gang(2, fail="1:143:step_2", extra_env=env)
    assert not first.success
    assert first.first_failure == 143
    assert first.restart_decision == "restart"

    second = _gang(2, extra_env=env)
    assert second.success, _explain(second)
    chief = second.chief_result
    assert chief["start_step"] >= 2, chief  # resumed, not restarted
    assert chief["step"] == 4

    control = _gang(2, extra_env={**env, "CHECKPOINT_DIR":
                                  str(tmp_path / "control")})
    assert control.success, _explain(control)
    assert control.chief_result["start_step"] == 0
    assert control.chief_result["loss"] == chief["loss"]


@pytest.mark.parametrize("fail,rc,decision", [
    ("1:1:startup", 1, "failed"),
    ("0:137:startup", 137, "restart"),
    ("1:143:post_init", 143, "restart"),
], ids=["exit-1-permanent", "oom-137-retryable", "preempt-143-mid-world"])
def test_failures_are_classified_as_the_operator_does(fail, rc, decision):
    res = _gang(2, fail=fail)
    assert not res.success
    assert res.first_failure == rc
    assert res.restart_decision == decision


def test_tpu_smoke_runs_as_a_gang():
    res = _gang(2, module="k8s_tpu_torch.launcher.tpu_smoke")
    assert res.success, _explain(res)
    assert any("smoke OK on 2 devices" in out for out in res.worker_outputs)
