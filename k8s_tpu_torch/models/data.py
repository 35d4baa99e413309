"""Input pipeline: host-side batching and asynchronous device staging.

Port of ``k8s_tpu/models/data.py``.  ``array_batches`` is the reference's
numpy epoch/shuffle/batch loop, unchanged.  ``PrefetchIterator`` runs a
host iterator on a background thread and stages up to ``buffer_size``
batches ahead onto the device: each array goes through pinned host memory
and a ``non_blocking`` copy, so the host-to-device transfer of the next
batches is queued while the device computes on the current one.  It keeps
the reference's contract: producer exceptions surface at the consumer's
next ``__next__``, ``close()`` stops the producer, and ``skip(n)`` before
the first batch fast-forwards the source (checkpoint resume).
``prefetch_to_mesh`` stages only this rank's part of each global batch:
every process draws the same seeded global batches and keeps its block
of rows over the mesh's (dp, fsdp) axes and, with sp > 1, its chunk of
the sequence, as the reference's ``device_put`` of a global batch keeps
each process's shards.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


def array_batches(
    arrays: Sequence[np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = None,
    drop_remainder: bool = True,
) -> Iterator[tuple]:
    """Host-side epoch/shuffle/batch over aligned numpy arrays.

    Yields tuples of per-array batches (the (inputs, targets) shape fit()
    consumes).  ``epochs=None`` repeats forever — the step budget lives in
    fit(steps=...), not the data pipeline.
    """
    n = len(arrays[0])
    for a in arrays:
        if len(a) != n:
            raise ValueError(f"misaligned arrays: {len(a)} != {n}")
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_remainder else n
        for start in range(0, end, batch_size):
            take = idx[start:start + batch_size]
            yield tuple(a[take] for a in arrays)
        epoch += 1


class PrefetchIterator:
    """Asynchronous device staging of a host batch iterator.

    Runs the wrapped iterator on a daemon thread, moving every array of
    each batch (a tuple or list of numpy arrays or tensors) to
    ``device`` into a bounded queue.  ``device`` is required: the
    caller names where its step runs (``cuda``, or ``cpu`` for tests).
    ``shard`` (a ``parallel.mesh.DataSharding``) keeps only this rank's
    rows of every array.  ``transform(batch) -> batch``, when given, runs
    on the producer thread on each host batch before it is staged (as the
    reference's: e.g. a host-side augmentation or a cast), so it overlaps
    the step too.  Call ``close()`` (use try/finally around the
    consuming loop) to stop the producer: the live thread keeps the
    iterator reachable, so garbage collection alone will not stop it.
    """

    _DONE = object()

    def __init__(self, it: Iterable, *, device, buffer_size: int = 2,
                 shard=None, transform: Optional[Callable] = None):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self._device = torch.device(device)
        self._shard = shard
        self._transform = transform
        self._source = it
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        # lazy start: the producer begins on first consumption, so a
        # pre-consumption skip() can still reach the source's index jump
        self._thread: Optional[threading.Thread] = None

    def skip(self, n: int) -> None:
        """Forward a pre-consumption skip to the source (its ``skip(n)``
        when it has one, else drain ``n`` batches)."""
        if self._thread is not None:
            raise RuntimeError("skip() must be called before consumption")
        source_skip = getattr(self._source, "skip", None)
        if callable(source_skip):
            source_skip(n)
        else:
            it = iter(self._source)
            for _ in range(n):
                next(it)
            self._source = it

    def _ensure_started(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, args=(iter(self._source),), daemon=True,
                name="prefetch-producer")
            self._thread.start()

    def _stage(self, batch):
        if self._transform is not None:
            batch = self._transform(batch)
        cuda = self._device.type == "cuda"
        staged: dict = {}  # one copy of an array that appears twice

        def put(x):
            if id(x) not in staged:
                t = torch.as_tensor(x if self._shard is None
                                    else self._shard.local(x))
                if cuda:
                    t = t.pin_memory().to(self._device, non_blocking=True)
                else:
                    t = t.to(self._device)
                staged[id(x)] = t
            return staged[id(x)]

        return type(batch)(put(x) for x in batch)

    def _produce(self, it) -> None:
        try:
            for batch in it:
                if self._stop.is_set():
                    return
                self._put_blocking(self._stage(batch))
            self._put_blocking(self._DONE)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            self._put_blocking(e)

    def _put_blocking(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        self._ensure_started()
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                # re-check _stop: close() from another thread may have
                # stopped the producer before it enqueued the sentinel
                continue
        if item is self._DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)


def prefetch_to_device(it: Iterable, device, *, buffer_size: int = 2
                       ) -> PrefetchIterator:
    """The one-call path for fit(): stage every batch on ``device``,
    ``buffer_size`` batches ahead (one device; :func:`prefetch_to_mesh`
    for a sharded step)."""
    return PrefetchIterator(it, device=device, buffer_size=buffer_size)


def prefetch_to_mesh(it: Iterable, mesh, device, *,
                     axes: Sequence[str] = ("dp", "fsdp"),
                     buffer_size: int = 2,
                     transform: Optional[Callable] = None
                     ) -> PrefetchIterator:
    """The one-call path for a sharded fit(): from each global batch of
    ``it`` (after ``transform``, when given), stage this rank's rows over
    ``axes`` of ``mesh`` and its chunk of the sequence over sp, inputs
    and targets alike (``parallel.mesh.data_sharding``), on ``device``,
    ``buffer_size`` batches ahead.  ``skip(n)`` still skips n global
    batches."""
    from k8s_tpu_torch.parallel.mesh import data_sharding

    return PrefetchIterator(it, device=device, buffer_size=buffer_size,
                            shard=data_sharding(mesh, axes),
                            transform=transform)

