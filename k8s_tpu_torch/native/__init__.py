"""Build and load the native window reader (``src/dataloader.cc``).

The port's counterpart of ``k8s_tpu/native/__init__.py``, for the data
loader only: the reference's ``runtime.cc`` (the controllers' work queue
and expectations) is operator side and stays there.  The system g++
compiles ``src/dataloader.cc`` at first use into the git-ignored
``k8s_tpu_torch/_build/`` as ``libk8stpu_dataloader-<hash>.so``; the hash
covers the sources and the flags, so an edited source builds anew and an
unchanged one is reused.  Each build writes under a temporary name of its
own process and thread and renames it into place, so processes that
build at once never write one file.  Bound with ctypes (plain C ABI).

``K8S_TPU_NATIVE``, as the reference reads it: ``"0"`` disables the
library (``reader="auto"`` takes the mmap reader), ``"1"`` makes a failed
build raise, unset uses it when it builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "src")
SOURCES = ("dataloader.cc", "tsan_wait.h")
STRESS_SRC = "stress_dataloader.cc"
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
STRESS_FLAGS = ("-O1", "-g", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _digest(names, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in names:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(out: str, cmd: list, what: str) -> str | None:
    """Run g++ ``cmd`` (ending in ``-o``) into a temporary name of this
    process and thread, then rename it to ``out``; None on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    r = subprocess.run([*cmd, tmp], capture_output=True, text=True)
    if r.returncode != 0:
        log.warning("%s build failed (exit %d): %s", what, r.returncode,
                    r.stderr[-2000:])
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, out)
    return out


def library_path() -> str:
    return os.path.join(
        BUILD_DIR, f"libk8stpu_dataloader-{_digest(SOURCES, FLAGS)}.so")


def build() -> str | None:
    """The library's path, compiled if it is not built yet; None when g++
    is missing or the compile fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        log.warning("g++ not found; the native window reader is unavailable")
        return None
    path = _compile(out, [gxx, *FLAGS, os.path.join(SRC_DIR, SOURCES[0]),
                          "-o"], "native window reader")
    if path is not None:
        log.info("built the native window reader: %s", path)
    return path


def build_stress_binary(tsan: bool = False) -> str | None:
    """Compile ``src/stress_dataloader.cc`` (the reader's ordering and
    content stress) into a standalone binary, with ``tsan`` under
    ``-fsanitize=thread``.  Run it as ``binary DIR``.  None when g++ (or,
    with ``tsan``, libtsan) is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    flags = ("-fsanitize=thread", *STRESS_FLAGS) if tsan else STRESS_FLAGS
    name = "stress_dataloader_tsan" if tsan else "stress_dataloader"
    out = os.path.join(
        BUILD_DIR,
        f"{name}-{_digest((*SOURCES, STRESS_SRC), flags)}")
    if os.path.exists(out):
        return out
    return _compile(out, [gxx, *flags, "-I", SRC_DIR,
                          os.path.join(SRC_DIR, STRESS_SRC), "-o"],
                    f"stress binary ({'tsan' if tsan else 'plain'})")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dl_new.restype = ctypes.c_void_p
    lib.dl_new.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.dl_free.restype = None
    lib.dl_free.argtypes = [ctypes.c_void_p]
    lib.dl_register_file.restype = ctypes.c_int
    lib.dl_register_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dl_submit.restype = ctypes.c_int
    lib.dl_submit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_uint64, ctypes.c_uint64]
    lib.dl_next.restype = ctypes.c_int64
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint64, ctypes.c_int]
    lib.dl_error.restype = ctypes.c_int
    lib.dl_error.argtypes = [ctypes.c_void_p]
    lib.dl_inflight.restype = ctypes.c_uint64
    lib.dl_inflight.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL | None:
    """Build if needed and dlopen the library; None when it is disabled
    (``K8S_TPU_NATIVE=0``) or cannot be built.  With ``K8S_TPU_NATIVE=1``
    a library that cannot be built raises, on every call."""
    global _lib, _tried
    mode = os.environ.get("K8S_TPU_NATIVE", "")
    if mode == "0":
        return None  # read on every call: the variable works at any time
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            path = build()
            if path is not None:
                _lib = _declare(ctypes.CDLL(path))
        if _lib is None and mode == "1":
            raise RuntimeError(
                "K8S_TPU_NATIVE=1 but the native window reader failed to "
                "build")
        return _lib
