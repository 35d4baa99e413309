"""Host-side bookkeeping for the engine's block-granular KV cache:
a refcounted block allocator and a radix-style prefix tree over
block-sized token runs (models/engine.py is the only consumer).

The port's own copy of ``k8s_tpu/models/kvblocks.py`` (stdlib only, so
it is copied rather than imported); keep the two in step:
``tests/test_torch_paged.py`` drives both through the same randomized
operations.

The DEVICE side — one pooled pytree of ``[num_blocks, block_size, ...]``
leaves per cache tensor, gathered into per-request views by block
tables — lives in the engine; this module owns the invariants:

- **Refcounts.**  Every reference to a block holds exactly one count: a
  slot's block table entry, or a prefix-tree node.  ``release`` returns
  the block to the free list only at zero — retiring a request can
  never free a block another slot (or the tree) still references.
- **Null block.**  Block 0 is reserved and never allocated: block-table
  padding points at it, and the batched step routes inactive rows'
  stray writes into it (position -1, so nothing ever attends it).
- **Radix tree.**  Nodes are block-sized token runs; a child either
  matches the next ``block_size`` prompt tokens exactly (attach the
  whole block by reference) or shares a proper prefix with them (the
  DIVERGENCE block: the engine copy-on-writes it and prefills only the
  unshared remainder).  Matching is capped so at least one prompt token
  is always prefilled privately — the engine needs the last prompt
  position's logits, and recomputing one token is cheaper than any
  scheme for resurrecting them from a shared block.
- **Eviction.**  The tree is a cache: when the free list runs dry the
  engine evicts least-recently-hit LEAF nodes (dropping only the
  tree's reference — a block a live slot still uses survives until
  that slot retires).  With ``num_blocks >= 1 + slots * blocks_per_row``
  allocation therefore always succeeds.

All mutation happens on the single engine thread; nothing here locks.
"""

from __future__ import annotations

from collections import deque
from typing import Optional


class BlockPool:
    """Refcounted free-list allocator over ``num_blocks`` device blocks
    (block 0 reserved as the null block)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"pool needs >= 2 blocks (null + one usable), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(1, num_blocks))
        self._ref = [0] * num_blocks

    def alloc(self) -> Optional[int]:
        """Pop a free block at refcount 1, or None when the free list is
        empty (the caller evicts tree leaves and retries)."""
        if not self._free:
            return None
        idx = self._free.popleft()
        self._ref[idx] = 1
        return idx

    def retain(self, idx: int) -> None:
        if idx <= 0 or self._ref[idx] < 1:
            raise AssertionError(f"retain of dead/null block {idx}")
        self._ref[idx] += 1

    def release(self, idx: int) -> bool:
        """Drop one reference; True when the block was actually freed."""
        if idx <= 0 or self._ref[idx] < 1:
            raise AssertionError(f"release of dead/null block {idx}")
        self._ref[idx] -= 1
        if self._ref[idx] == 0:
            self._free.append(idx)
            return True
        return False

    def refcount(self, idx: int) -> int:
        return self._ref[idx]

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Live blocks excluding the null block."""
        return self.num_blocks - 1 - len(self._free)


class PrefixNode:
    __slots__ = ("tokens", "block", "parent", "children", "last_hit")

    def __init__(self, tokens: tuple, block: int,
                 parent: Optional["PrefixNode"]):
        self.tokens = tokens          # the block's token run (len == bs)
        self.block = block            # pool block holding its K/V
        self.parent = parent
        self.children: dict[tuple, PrefixNode] = {}
        self.last_hit = 0


def chain_tokens(node: PrefixNode) -> list[int]:
    """The full token chain a node's block terminates — its run plus
    every ancestor's, root-first.  The reference's spill tier keys
    demoted blocks by the chain's cumulative fingerprint, and the chain
    is only reachable through ``parent`` links, so demotion reads it
    BEFORE the node detaches."""
    runs: list[tuple] = []
    cur: Optional[PrefixNode] = node
    while cur is not None and cur.parent is not None:
        runs.append(cur.tokens)
        cur = cur.parent
    out: list[int] = []
    for run in reversed(runs):
        out.extend(run)
    return out


class PrefixTree:
    """Radix tree over block-sized token-id runs.  The root is a
    sentinel (no tokens, no block); every real node pins one pool block
    with one reference (taken by the engine at insert, dropped at
    evict)."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.root = PrefixNode((), 0, None)
        self._clock = 0
        self.nodes = 0
        # lifetime leaf evictions (pool-pressure signal: the engine's
        # stats() and the request recorder's evict phase both read it)
        self.evictions = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, ids, max_tokens: int
              ) -> tuple[list[PrefixNode], Optional[tuple[PrefixNode, int]]]:
        """Longest cached prefix of ``ids`` using at most ``max_tokens``
        tokens: ``(full_nodes, partial)`` where ``full_nodes`` are
        whole-block matches in order and ``partial`` is ``(node, j)``
        for a divergence block sharing its first ``j`` (< block_size)
        tokens — the engine copy-on-writes that one.
        """
        bs = self.block_size
        ids = [int(t) for t in ids]
        now = self._tick()
        cur = self.root
        full: list[PrefixNode] = []
        while (len(full) + 1) * bs <= max_tokens:
            run = tuple(ids[len(full) * bs:(len(full) + 1) * bs])
            child = cur.children.get(run)
            if child is None:
                break
            child.last_hit = now
            full.append(child)
            cur = child
        base = len(full) * bs
        budget = max_tokens - base
        best: Optional[tuple[PrefixNode, int]] = None
        if budget >= 1:
            rest = ids[base:base + bs]
            for child in cur.children.values():
                j = 0
                for a, b in zip(child.tokens, rest):
                    if a != b:
                        break
                    j += 1
                j = min(j, budget)
                if j >= 1 and (best is None or j > best[1]):
                    best = (child, j)
            if best is not None:
                best[0].last_hit = now
        return full, best

    def insert(self, matched: list[PrefixNode], ids, blocks: list[int],
               ) -> list[PrefixNode]:
        """Extend the matched path with nodes for the remaining full
        blocks of ``ids``; ``blocks[i]`` is the pool block holding block
        ``i``'s K/V (the inserting request's table).  Returns the NEW
        nodes — the caller retains one pool reference per new node.
        Already-present runs are reused, never duplicated."""
        bs = self.block_size
        ids = [int(t) for t in ids]
        n_full = len(ids) // bs
        now = self._tick()
        cur = self.root
        for node in matched:
            cur = node
        created: list[PrefixNode] = []
        for i in range(len(matched), n_full):
            run = tuple(ids[i * bs:(i + 1) * bs])
            child = cur.children.get(run)
            if child is None:
                child = PrefixNode(run, blocks[i], cur)
                cur.children[run] = child
                self.nodes += 1
                created.append(child)
            child.last_hit = now
            cur = child
        return created

    def graft(self, ids, blocks: list[int]) -> list[PrefixNode]:
        """Import seam (disaggregated serving): insert a MIGRATED
        prompt's full-block runs so a prefix that was prefilled on
        another pod is immediately shareable here — ``blocks[i]`` is the
        LOCAL pool
        block the i-th run was grafted into.  Match-then-insert with the
        engine's exact budget (the last prompt token stays private), so
        runs already cached locally are reused, never duplicated.
        Returns the NEW nodes; the caller retains one pool reference
        per new node, exactly like :meth:`insert`."""
        matched, _partial = self.match(ids, max(0, len(ids) - 1))
        return self.insert(matched, ids, blocks)

    def evict_leaf(self, pinned=None) -> Optional["PrefixNode"]:
        """Remove the least-recently-hit LEAF node and return it (the
        caller drops the tree's pool reference — and, with the
        reference's spill tier, demotes the node's content first,
        reconstructing its chain via :func:`chain_tokens` while
        ``node.parent`` is still wired).  ``pinned(block) -> bool`` marks blocks other
        holders (live slots) still reference: evicting those frees
        nothing AND loses a hot cache entry, so they are skipped —
        their pins drop when the holding request retires.  The walk is
        O(nodes) per call; nodes are bounded by the pool size (tens to
        hundreds), so no separate LRU structure is kept."""
        best: Optional[PrefixNode] = None

        def walk(node: PrefixNode) -> None:
            nonlocal best
            for child in node.children.values():
                if child.children:
                    walk(child)
                elif (pinned is None or not pinned(child.block)) and (
                        best is None or child.last_hit < best.last_hit):
                    best = child

        walk(self.root)
        if best is None:
            return None
        del best.parent.children[best.tokens]
        self.nodes -= 1
        self.evictions += 1
        return best

    def evict_one(self, pinned=None) -> Optional[int]:
        """Block-id convenience over :meth:`evict_leaf` (the pre-spill
        call shape: evict means the block's content dies)."""
        node = self.evict_leaf(pinned)
        return None if node is None else node.block

    def clear(self) -> list[int]:
        """Drop every node; returns their block ids for deref."""
        out: list[int] = []

        def walk(node: PrefixNode) -> None:
            for child in node.children.values():
                out.append(child.block)
                walk(child)

        walk(self.root)
        self.root.children = {}
        self.nodes = 0
        return out
