"""Token-shard dataset: checksummed binary shards streamed into training.
The port's own copy of ``k8s_tpu/models/dataset.py``: the same on-disk
format, the same writer and the same window streams, so shards either
package writes are read by the other window for window.

Format: a directory of ``tokens-NNNNN.npy`` shards, each a 1-D packed token
stream (uint16 or int32), plus ``MANIFEST.json``::

    {"dtype": "uint16", "total_tokens": N, "vocab_size": V,
     "shards": [{"file": "tokens-00000.npy", "sha256": "...",
                 "n_tokens": n}, ...]}

Shards are memory-mapped (np.load mmap_mode="r"), so reading scales to
corpora far beyond host RAM; sha256 is verified per shard on open (a
corrupted shard fails loudly, not as silently-wrong training data).

``reader="native"`` streams the same windows through the port's C++
window reader (``k8s_tpu_torch/native/``: ``pread`` on C++ threads, off
the GIL); ``"auto"``, the default, takes it whenever g++ builds it and
``K8S_TPU_NATIVE`` is not ``0``, as the reference does.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np

MANIFEST = "MANIFEST.json"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def encode_bytes(text: bytes | str) -> np.ndarray:
    """Byte-level tokenization: vocab 256, identity over raw bytes.  The
    zero-dependency tokenizer for tests/examples; real runs can write
    shards from any tokenizer's ids via write_token_shards."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(text, dtype=np.uint8).astype(np.uint16)


def decode_bytes(tokens: np.ndarray) -> str:
    return bytes(np.asarray(tokens, dtype=np.uint8)).decode(
        "utf-8", errors="replace")


def write_token_shards(
    out_dir: str,
    tokens: np.ndarray,
    *,
    shard_tokens: int = 1 << 20,
    vocab_size: Optional[int] = None,
) -> dict:
    """Split a packed 1-D token array into checksummed .npy shards +
    manifest.  Returns the manifest dict."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be a packed 1-D stream, got {tokens.shape}")
    if tokens.size == 0:
        raise ValueError("empty token stream")
    if tokens.min() < 0:
        # a -1 sentinel would wrap to 65535 under uint16 and checksum as
        # valid — reject up front rather than shipping corrupted shards
        raise ValueError(
            f"negative token ids (min {int(tokens.min())}); token shards "
            "store vocabulary indices — map padding/sentinel ids first")
    dtype = np.uint16 if tokens.max() < (1 << 16) else np.int32
    tokens = tokens.astype(dtype)
    os.makedirs(out_dir, exist_ok=True)
    shards = []
    for i, start in enumerate(range(0, len(tokens), shard_tokens)):
        chunk = tokens[start:start + shard_tokens]
        name = f"tokens-{i:05d}.npy"
        path = os.path.join(out_dir, name)
        np.save(path, chunk)
        shards.append({
            "file": name,
            "sha256": _sha256(path),
            "n_tokens": int(chunk.size),
        })
    manifest = {
        "dtype": np.dtype(dtype).name,
        "total_tokens": int(tokens.size),
        "vocab_size": int(vocab_size if vocab_size is not None
                          else int(tokens.max()) + 1),
        "shards": shards,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class TokenDataset:
    """Streaming reader over a token-shard directory.

    Shards are opened lazily as memory-maps; ``verify=True`` (default)
    checks each shard's sha256 against the manifest the first time that
    shard is opened — fail-loud before any of its tokens are consumed, but
    no full-corpus hashing stall at startup (a multi-hundred-GB corpus
    would otherwise re-scan every disk byte on every gang restart).
    """

    def __init__(self, data_dir: str, *, verify: bool = True):
        self.data_dir = data_dir
        self._verify = verify
        mpath = os.path.join(data_dir, MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no {MANIFEST} in {data_dir} — not a token-shard directory "
                f"(write one with write_token_shards)")
        with open(mpath) as f:
            self.manifest = json.load(f)
        self.vocab_size = int(self.manifest.get("vocab_size", 0))
        self.total_tokens = int(self.manifest["total_tokens"])
        declared = sum(s["n_tokens"] for s in self.manifest["shards"])
        if declared != self.total_tokens:
            raise ValueError(
                f"manifest inconsistent: shards sum to {declared}, "
                f"total_tokens says {self.total_tokens}")
        self._sums = {s["file"]: s["sha256"] for s in self.manifest["shards"]}
        self._mmaps: dict[str, np.ndarray] = {}
        self._verified: set[str] = set()

    def _check_shard(self, name: str) -> str:
        """Verify one shard's checksum (once); returns its path."""
        path = os.path.join(self.data_dir, name)
        if self._verify and name not in self._verified:
            got = _sha256(path)
            if got != self._sums[name]:
                raise ValueError(
                    f"checksum mismatch for {name}: manifest "
                    f"{self._sums[name][:12]}…, file {got[:12]}…")
            self._verified.add(name)
        return path

    def _shard(self, name: str) -> np.ndarray:
        if name not in self._mmaps:
            self._mmaps[name] = np.load(self._check_shard(name), mmap_mode="r")
        return self._mmaps[name]

    def num_sequences(self, seq_len: int) -> int:
        """Whole non-overlapping seq_len windows per epoch (windows never
        straddle a shard boundary — each shard is an independent stream)."""
        return sum(s["n_tokens"] // seq_len
                   for s in self.manifest["shards"])

    @staticmethod
    def _split_bounds(total: int, split: str, eval_fraction: float):
        """(base, size) of a split's window range within [0, total).

        The eval split is the LAST ceil-ish slice of the UNSHUFFLED global
        window order — a stable function of (corpus, seq_len,
        eval_fraction) only, so train/eval never overlap across runs,
        resumes, or reader implementations.  train is the complementary
        prefix, which keeps its shuffled index math identical to the
        no-split path (a permutation of [0, train_total)).
        """
        if split not in ("all", "train", "eval"):
            raise ValueError(f"unknown split {split!r} "
                             "(expected 'all', 'train' or 'eval')")
        if split == "all":
            if eval_fraction:
                raise ValueError(
                    "eval_fraction requires split='train' or 'eval' "
                    "(split='all' would silently leak the holdout into "
                    "training)")
            return 0, total
        if not 0.0 < eval_fraction < 1.0:
            raise ValueError(
                f"split={split!r} needs 0 < eval_fraction < 1, "
                f"got {eval_fraction}")
        n_eval = max(1, int(total * eval_fraction))
        if n_eval >= total:
            raise ValueError(
                f"eval_fraction {eval_fraction} leaves no training windows "
                f"(total {total})")
        return (total - n_eval, n_eval) if split == "eval" \
            else (0, total - n_eval)

    def num_split_sequences(self, seq_len: int, split: str = "all",
                            eval_fraction: float = 0.0) -> int:
        """Windows per epoch in a holdout split (see _split_bounds)."""
        return self._split_bounds(
            self.num_sequences(seq_len), split, eval_fraction)[1]

    def _window_index(self, seq_len: int):
        """(names, cum) for O(num_shards) global-window-index decoding."""
        counts = [s["n_tokens"] // seq_len for s in self.manifest["shards"]]
        names = [s["file"] for s in self.manifest["shards"]]
        cum = np.cumsum([0] + counts)  # cum[i] = first global index of shard i
        if int(cum[-1]) == 0:
            raise ValueError(
                f"seq_len {seq_len} longer than every shard "
                f"(max {max(s['n_tokens'] for s in self.manifest['shards'])})")
        return names, cum

    def sequences(
        self,
        seq_len: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        reader: str = "auto",
        start_window: int = 0,
        split: str = "all",
        eval_fraction: float = 0.0,
    ) -> Iterator[np.ndarray]:
        """Yield [seq_len] int32 windows; shuffle permutes the global window
        order each epoch.

        Window bookkeeping is O(num_shards) (a global window index decodes
        to (shard, offset) through a cumulative count table; no per-window
        tuple list), and reads touch only the windows actually yielded.
        With ``shuffle=True`` each epoch still materializes one
        rng.permutation(num_windows) int64 array — O(num_windows) MEMORY
        (~800 MB at 100M windows).  For corpora past that scale, plug a
        block- or Feistel-style streaming shuffle in here; unshuffled
        streams stay O(num_shards) end to end.

        ``reader``: "mmap" reads through numpy memory maps (page faults
        hold the GIL); "native" streams windows through the C++ loader
        (k8s_tpu_torch/native/dataloader.py — reads on C++ threads,
        GIL-free); "auto" picks native when the toolchain built it, else
        mmap.  Both yield identical streams.

        ``split``/``eval_fraction``: holdout evaluation — "eval" is the
        stable last slice of the unshuffled global window order, "train"
        the complementary prefix (see _split_bounds); shuffle/seed/
        start_window all operate WITHIN the chosen split.
        """
        if reader not in ("auto", "mmap", "native"):
            raise ValueError(f"unknown reader {reader!r}")
        if reader == "auto":
            from k8s_tpu_torch.native import dataloader as native_dl

            reader = "native" if native_dl.available() else "mmap"
        names, _ = self._window_index(seq_len)
        windows = self._windows(seq_len, shuffle, seed, epochs, start_window,
                                split, eval_fraction)
        if reader == "native":
            yield from self._read_native(names, seq_len, windows)
            return
        for shard_i, start in windows:
            yield np.asarray(
                self._shard(names[shard_i])[start:start + seq_len],
                dtype=np.int32)

    def _windows(self, seq_len: int, shuffle: bool, seed: int,
                 epochs: Optional[int], start_window: int, split: str,
                 eval_fraction: float) -> Iterator[tuple[int, int]]:
        """(shard index, first token) of each window of the stream, in
        order: what both readers read."""
        names, cum = self._window_index(seq_len)
        base, total = self._split_bounds(int(cum[-1]), split, eval_fraction)
        rng = np.random.default_rng(seed)
        epoch, offset = self._fast_forward(rng, total, start_window, shuffle)
        while epochs is None or epoch < epochs:
            order = rng.permutation(total) if shuffle else range(total)
            for i in order[offset:]:
                i = base + int(i)
                shard_i = int(np.searchsorted(cum, i, side="right")) - 1
                yield shard_i, (i - int(cum[shard_i])) * seq_len
            offset = 0
            epoch += 1

    @staticmethod
    def _fast_forward(rng, total: int, start_window: int, shuffle: bool):
        """Advance the stream position to ``start_window`` (flat index over
        the multi-epoch stream) without reading anything: whole skipped
        epochs burn one permutation draw each so shuffle determinism is
        preserved."""
        if start_window < 0:
            raise ValueError(f"start_window must be >= 0, got {start_window}")
        epoch, offset = divmod(start_window, total)
        if shuffle:
            for _ in range(epoch):
                rng.permutation(total)
        return epoch, offset

    def _read_native(self, names: list, seq_len: int,
                     windows: Iterator[tuple[int, int]]
                     ) -> Iterator[np.ndarray]:
        """The C++-reader stream: the same windows, in the same order, as
        the mmap reader's.

        Checksums stay LAZY (matching the class docstring's no-startup-
        stall contract): a shard is hashed the first time one of its
        windows is submitted, not at registration.  The reader (and its
        threads) is closed when this generator stops.
        """
        from k8s_tpu_torch.native.dataloader import NativeWindowReader

        dtype = np.dtype(self.manifest["dtype"])
        paths = [os.path.join(self.data_dir, n) for n in names]
        # npy payload starts after the header: size - n_tokens * itemsize
        data_off = [
            os.path.getsize(p) - s["n_tokens"] * dtype.itemsize
            for p, s in zip(paths, self.manifest["shards"])
        ]

        def descriptors():
            for shard_i, start in windows:
                self._check_shard(names[shard_i])  # lazy, once each
                yield shard_i, data_off[shard_i] + start * dtype.itemsize

        with NativeWindowReader(paths, seq_len * dtype.itemsize) as r:
            for raw in r.stream(descriptors()):
                yield np.frombuffer(raw, dtype=dtype).astype(np.int32)

    def batches(
        self,
        batch_size: int,
        seq_len: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        split: str = "all",
        eval_fraction: float = 0.0,
    ) -> "BatchStream":
        """(tokens, tokens) [B, L] pairs — the (inputs, targets) shape
        train.fit consumes for next-token prediction (lm_loss shifts
        internally).  Incomplete trailing batches are dropped.

        Returns a BatchStream: an iterator that additionally supports
        ``skip(n)`` BEFORE consumption — an index jump over the first n
        batches with no disk reads, which is how train.fit fast-forwards
        the stream on checkpoint resume.

        ``split``/``eval_fraction`` select the holdout partition (see
        sequences); batch accounting (skip bounds, the batch_size guard)
        is against the SPLIT's window count.
        """
        n = self.num_split_sequences(seq_len, split, eval_fraction)
        if n < batch_size:
            raise ValueError(
                f"dataset split {split!r} has {n} windows of "
                f"{seq_len}, need >= batch_size {batch_size}")
        return BatchStream(self, batch_size, seq_len, shuffle=shuffle,
                           seed=seed, epochs=epochs, split=split,
                           eval_fraction=eval_fraction)


class BatchStream:
    """Iterator over token batches with a pre-consumption ``skip(n)``.

    The skip advances the deterministic window order WITHOUT touching the
    shards (the permutation is recomputed per epoch from the seed), so
    resuming at step 100k costs index arithmetic, not 100k batch reads.
    """

    def __init__(self, ds: "TokenDataset", batch_size: int, seq_len: int,
                 *, shuffle: bool, seed: int, epochs: Optional[int],
                 split: str = "all", eval_fraction: float = 0.0):
        self._ds = ds
        self._batch_size = batch_size
        self._seq_len = seq_len
        self._shuffle = shuffle
        self._seed = seed
        self._epochs = epochs
        self._split = split
        self._eval_fraction = eval_fraction
        self._skip_windows = 0
        self._iter = None

    def skip(self, n_batches: int) -> None:
        if self._iter is not None:
            raise RuntimeError("skip() must be called before consumption")
        self._skip_windows += int(n_batches) * self._batch_size
        # Bounded streams validate the jump target eagerly: silently
        # skipping past the end would make iteration yield nothing and a
        # resumed fit() "complete" zero steps, while the drain fallback
        # raises for the same condition — the two paths must agree.
        if self._epochs is not None:
            total_windows = self._ds.num_split_sequences(
                self._seq_len, self._split, self._eval_fraction
            ) * self._epochs
            usable = (total_windows // self._batch_size) * self._batch_size
            # strictly greater: skipping EXACTLY to the end is the
            # completed-run resume (fit's documented no-op path), matching
            # the drain fallback, which only fails when a next() is missing
            if self._skip_windows > usable:
                raise ValueError(
                    f"skip({n_batches}) jumps past the stream: "
                    f"{usable // self._batch_size} batches available over "
                    f"{self._epochs} epoch(s)")

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        if self._iter is None:
            self._iter = self._ds.sequences(
                self._seq_len, shuffle=self._shuffle, seed=self._seed,
                epochs=self._epochs, start_window=self._skip_windows,
                split=self._split, eval_fraction=self._eval_fraction)
        rows = []
        for seq in self._iter:
            rows.append(seq)
            if len(rows) == self._batch_size:
                break
        if len(rows) < self._batch_size:
            raise StopIteration
        batch = np.stack(rows)
        return batch, batch


def write_text_corpus(out_dir: str, texts: Sequence[str | bytes], *,
                      shard_tokens: int = 1 << 16) -> dict:
    """Byte-tokenize real text into a shard directory (fixtures for tests
    and examples; vocab is fixed at 256)."""
    stream = np.concatenate([encode_bytes(t) for t in texts])
    return write_token_shards(out_dir, stream, shard_tokens=shard_tokens,
                              vocab_size=256)
