"""The port stands alone: no module of k8s_tpu_torch, and neither
chip_smoke.py nor chip_profile.py, imports JAX, flax, optax, orbax or
anything of k8s_tpu."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "k8s_tpu")


def _port_files():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                             "chip_profile.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "k8s_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # built at run time
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_sees_the_whole_package():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"chip_smoke.py", "chip_profile.py"} <= rel
    assert os.path.join("k8s_tpu_torch", "models", "server.py") in rel
    assert os.path.join("k8s_tpu_torch", "ops", "flash_attention.py") in rel
    for part in (("trace", "__init__.py"), ("trace", "tracer.py"),
                 ("trace", "export.py"), ("trace", "propagation.py"),
                 ("models", "moe.py"), ("models", "dataset.py"),
                 ("models", "resnet.py"), ("models", "vit.py"),
                 ("models", "mnist.py"), ("models", "mnist_data.py"),
                 ("models", "mp_plan.py"), ("models", "mesh_serve.py"),
                 ("models", "mp_serve.py"), ("native", "__init__.py"),
                 ("native", "dataloader.py"), ("dist_mnist.py",),
                 ("harness", "__init__.py"), ("harness", "bench_serve.py"),
                 ("harness", "bench_kvtier.py"),
                 ("harness", "bench_serve_mp.py"), ("util", "util.py"),
                 ("bench.py",)):
        assert os.path.join("k8s_tpu_torch", *part) in rel


def test_server_import_loads_nothing_of_k8s_tpu():
    code = ("import sys, k8s_tpu_torch.models.server, "
            "k8s_tpu_torch.models.bridge, k8s_tpu_torch.models.dataset, "
            "k8s_tpu_torch.models.resnet, k8s_tpu_torch.models.vit, "
            "k8s_tpu_torch.models.mnist, k8s_tpu_torch.models.mnist_data, "
            "k8s_tpu_torch.train_lm, k8s_tpu_torch.dist_mnist, "
            "k8s_tpu_torch.native.dataloader, "
            "k8s_tpu_torch.launcher.bootstrap, "
            "k8s_tpu_torch.harness.bench_serve, "
            "k8s_tpu_torch.harness.bench_kvtier, "
            "k8s_tpu_torch.harness.bench_serve_mp, k8s_tpu_torch.bench; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'k8s_tpu' or m.startswith('k8s_tpu.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
