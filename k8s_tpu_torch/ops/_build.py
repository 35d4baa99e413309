"""Build the CUDA C++ kernels under ``k8s_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, compiled by nvcc for Hopper (``sm_90a``) into
``k8s_tpu_torch/_build/<name>-<hash>.so`` and loaded with ctypes.  The
hash covers the source, every ``csrc/*.cuh`` header and the flags, so an
edited source builds anew and an unchanged one is reused.  Nothing falls
back: a missing nvcc or a failed compile raises.

Building this way (no PyTorch headers, no ``torch.utils.cpp_extension``)
takes seconds per source instead of minutes.  ``build_all`` starts one
nvcc per source, all at once, so the slowest source sets the build's
time: the flash backward (``csrc/flash_bwd.cuh``) is two sources,
``flash_bwd_dq.cu`` and ``flash_bwd_dkv.cu``, each with one half of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's report per source (ptxas registers, shared memory, spills)
BUILD_LOGS: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from source at first use")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h.update(f.read())
    for hdr in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, hdr), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str) -> str:
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_compile(name))
            _libs[name] = lib
        return lib


def build_all() -> dict[str, float]:
    """Build every source in parallel and load it; returns the seconds
    each one took (nvcc, or 0.0-ish when its library was already built)."""
    names = sources()

    def one(name: str) -> float:
        t0 = time.perf_counter()
        _compile(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futures = {n: ex.submit(one, n) for n in names}
        secs = {n: f.result() for n, f in futures.items()}
    for n in names:
        load(n)
    return secs
