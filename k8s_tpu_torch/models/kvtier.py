"""Tiered KV memory: the host-RAM spill tier beneath the engine's device
block pool, and the block-chain fingerprints shared by the spill tier,
the kvxfer dedup handshake and the fleet prefix index.  The port's own
copy of ``k8s_tpu/models/kvtier.py`` (numpy and the stdlib only).

The pool (models/placement.py) lives on the device: when its free list
dries, the radix tree evicts its least-recently-hit leaves.  With the
spill tier on, eviction becomes demotion:

- **Demote**: the engine gathers the victim leaf's block through the
  ``gather_blocks`` seam migration exports ride (a copy on the host),
  int8-quantizes float K/V leaves through the one ``quantize_kv`` it
  passes in (int8 pools and their scale leaves store as they are), and
  parks the payload here keyed by the leaf's cumulative chain
  fingerprint.
- **Promote**: on a prefix-tree miss whose chain fingerprint is
  resident, the engine allocates fresh pool blocks, grafts the decoded
  payload back through ``graft_blocks`` and re-inserts the tree nodes;
  the attaching request sees an ordinary tree hit.

Which leaves quantize is the reference's rule exactly: a ``k``/``v`` leaf
whose numpy dtype is a floating type.  numpy has no bfloat16 of its own
(the reference's comes from ml_dtypes, which numpy does not count as
floating), so a bf16 pool spills raw and bit-exact in both packages, and
only f32/f16 pools round-trip through int8.  On the host the port keeps a
bf16 leaf as its raw 2-byte patterns in the one-field record dtype
:data:`BF16`: it keeps its identity (the wire names it ``"bfloat16"``,
as the reference writes it), is never mistaken for a float, and needs no
ml_dtypes.

The tier is bounded (``K8S_TPU_SERVE_SPILL_MB``, default 0 = off) with
its own LRU over host bytes.  It holds host copies only, never a pool
block reference, so ``debug_check_blocks`` accounting is unchanged.

Chain fingerprints: the cumulative fingerprint at block ``k`` equals the
router's ``fingerprint_tokens(tokens, block_size, k + 1)``
(``k8s_tpu/router/ring.py``), so the router's affinity keys, the spill
tier's keys, the dedup offers and the fleet index agree on which bytes a
fingerprint names.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Optional

import numpy as np

DEFAULT_SPILL_MB = 0

# A bf16 array on the host: its raw bit patterns, one record field wide.
BF16 = np.dtype([("bfloat16", "<u2")])


def dtype_name(dtype) -> str:
    """The wire's name of a host dtype (``"bfloat16"`` for :data:`BF16`,
    numpy's name otherwise)."""
    dtype = np.dtype(dtype)
    return "bfloat16" if dtype == BF16 else str(dtype)


def dtype_of(name: str) -> np.dtype:
    """Inverse of :func:`dtype_name`: ``"bfloat16"`` is :data:`BF16`, any
    other name is numpy's."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def env_spill_mb() -> int:
    """Host-RAM spill budget in MiB (``K8S_TPU_SERVE_SPILL_MB``,
    default 0 = spill tier off: evicted leaves are dropped)."""
    raw = os.environ.get("K8S_TPU_SERVE_SPILL_MB", "").strip()
    if not raw:
        return DEFAULT_SPILL_MB
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"K8S_TPU_SERVE_SPILL_MB must be an integer, got {raw!r}")
    if val < 0:
        raise ValueError(
            f"K8S_TPU_SERVE_SPILL_MB must be >= 0, got {val}")
    return val


def chain_fingerprints(tokens, block_size: int,
                       max_blocks: Optional[int] = None) -> list[str]:
    """Cumulative chain fingerprint at every full-block boundary of
    ``tokens``: entry ``k`` covers blocks ``0..k`` and equals the
    router's ``fingerprint_tokens(tokens, block_size, k + 1)``.  One
    hasher, snapshotted per boundary, so a whole chain costs one pass
    over its tokens."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    n_full = len(tokens) // block_size
    if max_blocks is not None:
        n_full = min(n_full, max(0, max_blocks))
    h = hashlib.sha1()
    h.update(f"{block_size}:".encode())
    out: list[str] = []
    for k in range(n_full):
        for t in tokens[k * block_size:(k + 1) * block_size]:
            h.update(f"{int(t)},".encode())
        out.append(h.hexdigest())
    return out


def _is_kv_leaf(path: str, dtype) -> bool:
    """Float K/V leaves quantize on demote; everything else (int8 K/V,
    their scale leaves, bf16 K/V) stores as it is.  The test the
    server's ``_wire_blocks`` applies too."""
    return path.rsplit("/", 1)[-1] in ("k", "v") and (
        np.issubdtype(np.dtype(dtype), np.floating))


def encode_payload(flat: dict, quantize_kv) -> tuple[dict, int]:
    """Pack one gathered block's flat host leaves ``{path: array[bs,
    ...]}`` into a spill payload: float K/V leaves become ``(q int8,
    scale f32)`` through ``quantize_kv`` (passed in, returning anything
    numpy reads); other leaves are stored as they are.  Returns
    ``(payload, nbytes)``."""
    payload: dict[str, tuple] = {}
    nbytes = 0
    for path, arr in flat.items():
        if _is_kv_leaf(path, arr.dtype):
            q, scale = quantize_kv(arr)
            q = np.asarray(q, np.int8)
            scale = np.asarray(scale, np.float32)
            payload[path] = ("q8", q, scale)
            nbytes += q.nbytes + scale.nbytes
        else:
            host = np.asarray(arr)
            payload[path] = ("raw", host)
            nbytes += host.nbytes
    return payload, nbytes


def decode_payload(payload: dict) -> dict:
    """Inverse of :func:`encode_payload`: flat ``{path: array}`` ready
    for the graft.  Dequantization is the wire's expression
    (``q.astype(f32) * scale[..., None]``); the graft casts to each pool
    leaf's dtype, so int8 and bf16 pools receive their stored bytes."""
    out: dict[str, np.ndarray] = {}
    for path, packed in payload.items():
        if packed[0] == "q8":
            _, q, scale = packed
            out[path] = q.astype(np.float32) * scale[..., None]
        else:
            out[path] = packed[1]
    return out


class SpillEntry:
    __slots__ = ("fingerprint", "tokens", "payload", "nbytes")

    def __init__(self, fingerprint: str, tokens: tuple, payload: dict,
                 nbytes: int):
        self.fingerprint = fingerprint  # cumulative chain fp at this block
        self.tokens = tokens            # this block's token run (len == bs)
        self.payload = payload          # {path: ("q8", q, scale) | ("raw", a)}
        self.nbytes = nbytes


class SpillTier:
    """Byte-budgeted host LRU over demoted blocks, keyed by cumulative
    chain fingerprint.  Every mutation happens on the engine thread;
    readers on other threads (the fleet index metric, the dedup probe)
    only take GIL-atomic snapshots through :meth:`fingerprints` and
    membership tests."""

    def __init__(self, budget_bytes: int):
        if budget_bytes < 0:
            raise ValueError(
                f"spill budget must be >= 0, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._entries: "OrderedDict[str, SpillEntry]" = OrderedDict()
        self._bytes = 0
        # lifetime counters (engine stats() and the serving metrics)
        self.spilled_blocks = 0
        self.promoted_blocks = 0
        self.spill_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._entries

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def put(self, fingerprint: str, tokens: tuple, payload: dict,
            nbytes: int) -> bool:
        """Admit one demoted block, evicting the LRU tail until the
        budget holds.  A payload larger than the whole budget is refused
        (False).  Re-admitting a resident fingerprint only refreshes its
        LRU position: a chain fingerprint's content is immutable."""
        if fingerprint in self._entries:
            self._entries.move_to_end(fingerprint)
            return True
        if nbytes > self.budget_bytes:
            return False
        while self._bytes + nbytes > self.budget_bytes and self._entries:
            _, victim = self._entries.popitem(last=False)
            self._bytes -= victim.nbytes
            self.spill_evictions += 1
        self._entries[fingerprint] = SpillEntry(
            fingerprint, tuple(tokens), payload, nbytes)
        self._bytes += nbytes
        self.spilled_blocks += 1
        return True

    def touch(self, fingerprint: str) -> bool:
        """True, with an LRU refresh, when the fingerprint is already
        resident (a re-demote needs no gather and no quantize)."""
        if fingerprint in self._entries:
            self._entries.move_to_end(fingerprint)
            return True
        return False

    def get(self, fingerprint: str) -> Optional[SpillEntry]:
        """LRU-refreshing lookup that counts a promotion; the entry stays
        resident, so the next demote of the same chain is a pure
        tree-reference drop."""
        entry = self._entries.get(fingerprint)
        if entry is not None:
            self._entries.move_to_end(fingerprint)
            self.promoted_blocks += 1
        return entry

    def peek(self, fingerprint: str) -> Optional[SpillEntry]:
        """Lookup without LRU refresh or promote accounting."""
        return self._entries.get(fingerprint)

    def fingerprints(self) -> list[str]:
        """Resident chain fingerprints, LRU to MRU (a GIL-atomic
        snapshot, safe off the engine thread)."""
        return list(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0
