"""Python wrapper over the native window reader (src/dataloader.cc).

The port's copy of ``k8s_tpu/native/dataloader.py``.
``NativeWindowReader`` streams fixed-size byte windows from registered
files in submission order, with the reads running on C++ threads — no GIL
involvement, unlike the mmap path whose page faults block the whole
interpreter.  k8s_tpu_torch/models/dataset.py uses it as the
``reader="native"`` backend for token-shard windows.

``delivered()`` counts the windows every reader of this process has
handed to Python since ``reset_delivered()``: a run zeroes it and reads it
back to tell which reader fed it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterable, Iterator, Sequence

from k8s_tpu_torch import native

_DELIVERED = 0
# readers of the train and eval streams run on different threads
_DELIVERED_LOCK = threading.Lock()


def reset_delivered() -> None:
    global _DELIVERED
    with _DELIVERED_LOCK:
        _DELIVERED = 0


def delivered() -> int:
    """Windows handed to Python by every reader since the last reset."""
    return _DELIVERED


def _count_window() -> None:
    global _DELIVERED
    with _DELIVERED_LOCK:
        _DELIVERED += 1


def available() -> bool:
    return native.load() is not None


class NativeWindowReader:
    """Ordered windows over (path, offset, nbytes) descriptors.

    Usage::

        with NativeWindowReader(paths, window_bytes) as r:
            for data in r.stream(descriptors):  # (path_idx, offset) pairs
                ...
    """

    def __init__(self, paths: Sequence[str], window_bytes: int,
                 n_slots: int = 16, n_threads: int = 2):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native window reader unavailable (g++ "
                               "missing, the build failed, or "
                               "K8S_TPU_NATIVE=0)")
        self._lib = lib
        self._window_bytes = int(window_bytes)
        self._h = lib.dl_new(int(n_slots), self._window_bytes, int(n_threads))
        if not self._h:
            raise RuntimeError("dl_new failed")
        self._file_ids = []
        for p in paths:
            fid = lib.dl_register_file(self._h, p.encode())
            if fid < 0:
                self.close()
                raise FileNotFoundError(f"native loader cannot open {p}")
            self._file_ids.append(fid)
        self._buf = ctypes.create_string_buffer(self._window_bytes)

    def close(self) -> None:
        if self._h:
            self._lib.dl_free(self._h)
            self._h = None

    def __enter__(self) -> "NativeWindowReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stream(self, descriptors: Iterable[tuple[int, int]],
               timeout_s: float = 30.0) -> Iterator[bytes]:
        """Yield each descriptor's bytes in order; descriptors are
        (path_index, byte_offset) pairs, all window_bytes long."""
        it = iter(descriptors)
        exhausted = False
        pending = 0
        while True:
            # keep the ring full before draining one window
            while not exhausted:
                try:
                    path_idx, offset = next(it)
                except StopIteration:
                    exhausted = True
                    break
                rc = self._lib.dl_submit(
                    self._h, self._file_ids[path_idx], int(offset),
                    self._window_bytes)
                if rc == 0:
                    # ring full: consume one window, then submit again
                    yield self._next(timeout_s)
                    pending -= 1
                    rc = self._lib.dl_submit(
                        self._h, self._file_ids[path_idx], int(offset),
                        self._window_bytes)
                if rc != 1:
                    raise IOError("native loader rejected a window "
                                  "(poisoned by an earlier read failure)")
                pending += 1
            if pending == 0:
                return
            yield self._next(timeout_s)
            pending -= 1

    def _next(self, timeout_s: float) -> bytes:
        n = self._lib.dl_next(self._h, self._buf, self._window_bytes,
                              int(timeout_s * 1000))
        if n == 0:
            raise TimeoutError("native loader stalled (no window within "
                               f"{timeout_s}s)")
        if n < 0:
            raise IOError(f"native loader failed (rc={n}) — short read or "
                          "IO error on a shard")
        if n != self._window_bytes:
            raise IOError(f"native loader returned {n} bytes, expected "
                          f"{self._window_bytes}")
        _count_window()
        return self._buf.raw[:n]
