"""Block-paged KV cache bookkeeping: the host-side block allocator, the
per-sequence block tables over the arena, the shared-prefix radix index
and its host-RAM spill tier.

Copy of ``paddlefleetx_tpu/core/paged_cache.py`` (pure host Python; the
port keeps its own copy rather than importing the JAX package).  A sequence owns a BLOCK TABLE (logical block j -> arena block
id) into a preallocated arena of fixed-size blocks; the arena itself
(``PagedPools``) lives in ``models/gpt/generation.py`` and the kernel
that reads it is ``ops/decode_attention.paged_decode_attention``.

  - **block 0 is the null block**: never allocated, never freed.  Padded
    table entries, inactive batch rows and a chunk's pad slots point at
    it, so a fixed-shape step always has a safe write target.
  - **loud exhaustion, never corruption**: ``alloc`` raises
    :class:`BlockPoolExhausted` when the pool cannot satisfy a request,
    ``free`` raises on an over-free or an out-of-range id.
  - **refcounted blocks**: one physical block can back the same prompt
    prefix in many rows' tables (:class:`PrefixIndex`); evicted prefix
    blocks can demote to host RAM (:class:`PrefixSpillStore`) and come
    back on a later match.  The spill store holds numpy arrays or CPU
    tensors alike (the engine hands it CPU tensors: numpy has no
    bfloat16).

The KV-handoff codec (``pack_handoff`` / ``unpack_handoff`` /
``check_handoff_meta``, JAX ``:726-855``) writes the JAX package's PFXH1
format byte for byte, so a payload crosses between the two packages'
replicas: float32, float16 and int8 arrays as numpy writes them, and a
bfloat16 tensor's raw 2-byte words under the dtype string the JAX codec
writes for bfloat16 (``<V2``: numpy has no bfloat16).

Knob, parsed loudly as in the JAX package:

  PFX_KV_BLOCK   block size in cache slots (default 16; positive
                 multiple of 8)
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_DEFAULT_KV_BLOCK = 16

NULL_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """Not enough free KV blocks for the request (scheduler: stay queued)."""


def kv_block_size(block: int = 0) -> int:
    """Resolve the paged-cache block size: explicit arg, else
    PFX_KV_BLOCK, else 16.  Must be a positive multiple of 8; invalid
    values raise at setup."""
    raw = os.environ.get("PFX_KV_BLOCK") or "0"
    try:
        env = int(raw)
    except ValueError:
        raise ValueError(
            f"PFX_KV_BLOCK={raw!r} is not an integer; pass a positive "
            "multiple of 8 (e.g. 16) or unset it"
        ) from None
    force = int(block) or env or _DEFAULT_KV_BLOCK
    if force < 8 or force % 8:
        raise ValueError(
            f"kv block size {force} must be a positive multiple of 8 "
            "(block arg / PFX_KV_BLOCK)"
        )
    return force


def blocks_for(tokens: int, block: int) -> int:
    """Blocks needed to hold ``tokens`` cache slots."""
    if tokens < 0:
        raise ValueError(f"tokens must be >= 0, got {tokens}")
    return -(-int(tokens) // int(block))


class BlockAllocator:
    """Fixed-size block pool bookkeeping (ids 1..num_blocks-1; 0 = null).

    Free blocks are handed out lowest-id-first (`defrag` keeps the free
    list sorted), which keeps live allocations packed toward the front of
    the arena — helpful DMA locality, and `fragmentation()` stays an
    honest metric instead of an artifact of churn order.

    Blocks are REFCOUNTED so one physical block can back the same prefix
    in many rows' tables (shared-prefix KV reuse, docs/serving.md):
    ``alloc`` hands blocks out at refcount 1, ``share`` takes one more
    reference per caller, and ``free`` drops one reference — the block
    returns to the pool only at refcount 0, so evicting a cached prefix
    can never reclaim a block a live row still reads.  ``used_count``
    counts PHYSICAL blocks (each once, regardless of refcount): arena
    occupancy and byte gauges must never be inflated by sharing.
    """

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 usable + the null block), got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(1, self.num_blocks))
        self._ref: Dict[int, int] = {}

    # -- queries --------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        """Physical blocks currently allocated — each counted ONCE no
        matter how many tables reference it."""
        return len(self._ref)

    def refcount(self, block: int) -> int:
        """References held on ``block`` (0 = free)."""
        if not (0 < block < self.num_blocks):
            raise ValueError(
                f"block id {block} out of range (1..{self.num_blocks - 1})"
            )
        return self._ref.get(block, 0)

    def fragmentation(self) -> float:
        """1 - (largest contiguous free run / free blocks): 0.0 when the
        free space is one run (or empty), approaching 1.0 when it is
        shattered into single blocks."""
        if not self._free:
            return 0.0
        runs, best, cur = sorted(self._free), 1, 1
        for a, b in zip(runs, runs[1:]):
            cur = cur + 1 if b == a + 1 else 1
            best = max(best, cur)
        return 1.0 - best / len(self._free)

    # -- alloc/free -----------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks; raises :class:`BlockPoolExhausted` (with
        the shortfall named) when the pool cannot satisfy the request —
        the caller keeps the request queued rather than corrupting."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"KV block pool exhausted: need {n}, have {len(self._free)} "
                f"free of {self.num_blocks - 1} usable"
            )
        self._free.sort()
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._ref[b] = 1
        return out

    def share(self, blocks) -> None:
        """Take ONE additional reference on each block (prefix sharing:
        the caller's table now also points at it).  LOUD on the null
        block, an out-of-range id, or a block that is not currently
        allocated — sharing a free block would alias it against the next
        ``alloc``.  Atomic: a failing call takes no references."""
        blocks = list(blocks)
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("cannot share the null block (id 0)")
            if not (0 < b < self.num_blocks):
                raise ValueError(
                    f"block id {b} out of range (1..{self.num_blocks - 1})"
                )
            if b not in self._ref:
                raise ValueError(
                    f"cannot share free block {b} (not currently allocated)"
                )
        for b in blocks:
            self._ref[b] += 1

    def free(self, blocks) -> None:
        """Drop one reference per block; a block returns to the pool only
        when its last reference drops.  LOUD on an over-free (more frees
        than references), the null block, or an out-of-range id: any of
        those means two sequences believe they own one reference —
        silent acceptance would corrupt both caches.  A duplicate id
        within ONE call is rejected outright (a single table never holds
        a block twice, so it is always a bookkeeping bug)."""
        blocks = list(blocks)
        seen: set = set()
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("cannot free the null block (id 0)")
            if not (0 < b < self.num_blocks):
                raise ValueError(
                    f"block id {b} out of range (1..{self.num_blocks - 1})"
                )
            if b not in self._ref or b in seen:
                raise ValueError(
                    f"double free of block {b} (not currently allocated)"
                )
            seen.add(b)
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)

    def defrag(self) -> None:
        """Sort the free list so future allocations are as contiguous as
        possible.  With uniform blocks behind a table indirection this is
        purely a locality/telemetry nicety — correctness never depends
        on it."""
        self._free.sort()


# ---------------------------------------------------------------------------
# Shared-prefix radix index (prefix KV reuse, docs/serving.md)
#
# At serving scale most prompts open with a shared system/few-shot
# prefix whose KV is bit-identical across requests.  The index maps
# BLOCK-ALIGNED token runs to the arena blocks that already hold their
# KV: a radix trie whose edges are one full block's token run apiece
# (SGLang's RadixAttention idea restated over this arena), plus
# PARTIAL leaf runs (< block tokens — a prompt's unaligned tail) that a
# new row can reuse via COPY-ON-WRITE when it diverges mid-block.  The
# index holds ONE allocator reference per cached block; rows that match
# take their own reference (`BlockAllocator.share`), so eviction — LRU,
# leaf-first, under a block budget — only ever drops the index's
# reference and can never reclaim a block a live row still reads.
# ---------------------------------------------------------------------------


class _PrefixNode:
    """One cached block: ``tokens`` is the block's token run (len ==
    block size for trie-edge nodes; shorter for partial leaves, which
    never have children), ``block_id`` the arena block holding its KV."""

    __slots__ = ("tokens", "block_id", "children", "parent", "last_used")

    def __init__(self, tokens: tuple, block_id: int, parent) -> None:
        self.tokens = tokens
        self.block_id = int(block_id)
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixIndex:
    """Radix prefix index over one :class:`BlockAllocator`.

    ``budget_blocks`` caps how many arena blocks the index may pin
    (0 disables the index outright: lookups miss, publishes no-op).
    All methods are host-side bookkeeping; the device-side block COPY a
    COW match requires is the engine's job
    (`core/continuous_batching.py`)."""

    def __init__(self, allocator: BlockAllocator, block: int,
                 budget_blocks: int = 0) -> None:
        if budget_blocks < 0:
            raise ValueError(
                f"prefix budget must be >= 0 blocks, got {budget_blocks}"
            )
        self.allocator = allocator
        self.block = int(block)
        self.budget = int(budget_blocks)
        self.root: Dict[tuple, _PrefixNode] = {}
        # identity set (nodes hash by identity): membership + size only,
        # never ordered iteration — LRU order lives in last_used
        self._nodes: set = set()
        self._tick = 0
        # authoritative reuse counters (the scheduler's /healthz reads
        # them).  hits/misses/hit_tokens move in record_lookup(), which
        # the engine calls only AFTER the admission actually succeeded —
        # a match() whose admission then fails allocation must not count
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "hit_tokens": 0, "evictions": 0,
        }
        # spill tier hook (docs/serving.md "KV lifecycle"): when set, an
        # LRU eviction of a FULL block offers (full_token_path, block_id)
        # to the hook BEFORE the allocator reference drops, so the owner
        # can demote the block's KV to host RAM instead of losing it.
        # The hook must never veto the eviction — graceful degradation
        # is the contract, so a failing hook is swallowed here (the
        # engine counts its own discards loudly).
        self.spill_hook: Optional[Callable[[tuple, int], None]] = None

    @property
    def enabled(self) -> bool:
        return self.budget > 0

    def cached_blocks(self) -> int:
        """Arena blocks the index currently pins (one per node)."""
        return len(self._nodes)

    def reclaimable_blocks(self) -> int:
        """Cached blocks ONLY the index references — evicting the whole
        index would return exactly these to the pool (blocks also shared
        by live rows stay allocated until those rows release).

        Safe to call from metrics/health scrape threads while the
        scheduler thread publishes/evicts: the ``list()`` snapshot is a
        single C-level copy (atomic under the GIL — a Python-level
        generator over the live set would crash on concurrent
        add/discard), and ``refcount`` reads fall back to 0 for a block
        freed mid-scan — the count is a momentarily-stale gauge, never
        an exception."""
        nodes = list(self._nodes)
        return sum(
            1 for n in nodes
            if self.allocator.refcount(n.block_id) == 1
        )

    def _bump(self, node: _PrefixNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- lookup ---------------------------------------------------------
    def match(self, tokens) -> Tuple[List[int], Optional[Tuple[int, int]], int]:
        """Longest cached prefix of ``tokens``: returns
        ``(shared_blocks, cow, matched)`` where ``shared_blocks`` are the
        full-block ids to map into the new row's table (caller must
        `share()` them before anything can evict), ``cow`` is an optional
        ``(src_block_id, matched_tokens_in_block)`` pair for a mid-block
        divergence — the caller copies ``src`` into a private block and
        overwrites it from the divergence slot on — and ``matched`` is
        the total matched token count.  Capped at ``len(tokens) - 1``:
        at least one suffix token always recomputes, because admission
        needs the last prompt token's logits.

        Leaves the hit/miss stats UNTOUCHED — the caller invokes
        :meth:`record_lookup` once the admission actually lands, so an
        allocation failure between match and admit is never counted."""
        tokens = [int(t) for t in tokens]
        limit = len(tokens) - 1  # leave >= 1 token to recompute
        children = self.root
        shared: List[int] = []
        m = 0
        while m + self.block <= limit:
            child = children.get(tuple(tokens[m:m + self.block]))
            if child is None:
                break
            self._bump(child)
            shared.append(child.block_id)
            m += self.block
            children = child.children
        # mid-block divergence: the best partial overlap among this
        # node's children (full edges AND partial leaves) is worth a COW
        # copy — the row reuses `overlap` slots of prefix KV and
        # overwrites its private copy from the divergence slot on
        best_j, best_node = 0, None
        for key, child in children.items():
            j = 0
            cap = min(len(key), limit - m)
            while j < cap and key[j] == tokens[m + j]:
                j += 1
            if j > best_j:
                best_j, best_node = j, child
        cow = None
        if best_j > 0:
            self._bump(best_node)
            cow = (best_node.block_id, best_j)
            m += best_j
        return shared, cow, m

    def record_lookup(self, matched: int) -> None:
        """Commit one admission's hit/miss accounting (called by the
        engine AFTER the admission succeeded)."""
        if matched:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += int(matched)
        else:
            self.stats["misses"] += 1

    # -- publish --------------------------------------------------------
    def publish(self, tokens, table) -> int:
        """Insert a finished row's prompt prefix into the index:
        ``table[i]`` holds the KV of tokens ``[i*block, (i+1)*block)``
        (the row's first blocks — prompt layout is unpadded).  Full
        blocks become trie edges; an unaligned tail becomes a partial
        leaf.  Existing nodes are LRU-bumped, new ones take one
        allocator reference each.  Returns newly cached block count;
        evicts LRU leaves past ``budget_blocks`` afterwards."""
        if not self.enabled:
            return 0
        tokens = [int(t) for t in tokens]
        table = list(table)
        children = self.root
        parent: Optional[_PrefixNode] = None
        added = 0
        nfull = len(tokens) // self.block
        for i in range(nfull):
            run = tuple(tokens[i * self.block:(i + 1) * self.block])
            node = children.get(run)
            if node is None:
                node = _PrefixNode(run, table[i], parent)
                self.allocator.share([node.block_id])
                children[run] = node
                self._nodes.add(node)
                added += 1
            self._bump(node)
            children = node.children
            parent = node
        tail = tuple(tokens[nfull * self.block:])
        if tail and nfull < len(table):
            node = children.get(tail)
            if node is None:
                node = _PrefixNode(tail, table[nfull], parent)
                self.allocator.share([node.block_id])
                children[tail] = node
                self._nodes.add(node)
                added += 1
            self._bump(node)
        self.evict_to_budget()
        return added

    # -- structural inserts (spill readmit / migration adoption) --------
    @staticmethod
    def node_path(node: _PrefixNode) -> tuple:
        """Full token path from the root down to (and including) ``node``
        — the spill/migration key for the block it pins."""
        runs = []
        while node is not None:
            runs.append(node.tokens)
            node = node.parent
        return tuple(t for run in reversed(runs) for t in run)

    def insert_block(self, path_tokens, block_id: int) -> None:
        """Insert ONE full cached block whose token path is
        ``path_tokens`` (length a positive multiple of ``block``),
        TAKING OVER the caller's allocator reference on ``block_id`` —
        unlike :meth:`publish`, no extra ``share`` happens, so the
        caller must hand in a block it owns (freshly allocated and
        scattered by the spill-readmit / migration-adoption paths).
        LOUD when the ancestor chain is not cached or the path is
        already present: either means the caller raced its own
        bookkeeping, and silently adopting would leak the reference."""
        tokens = tuple(int(t) for t in path_tokens)
        if not tokens or len(tokens) % self.block:
            raise ValueError(
                f"insert_block path length {len(tokens)} is not a "
                f"positive multiple of block {self.block}"
            )
        children = self.root
        parent: Optional[_PrefixNode] = None
        depth = len(tokens) // self.block
        for i in range(depth - 1):
            run = tuple(tokens[i * self.block:(i + 1) * self.block])
            node = children.get(run)
            if node is None:
                raise ValueError(
                    "insert_block ancestor chain not cached at depth "
                    f"{i} (insert parents first)"
                )
            children = node.children
            parent = node
        run = tuple(tokens[(depth - 1) * self.block:])
        if run in children:
            raise ValueError("insert_block path already cached")
        node = _PrefixNode(run, block_id, parent)
        children[run] = node
        self._nodes.add(node)
        self._bump(node)

    def has_path(self, path_tokens) -> bool:
        """True when the exact full-block path is already cached (the
        migration receiver's idempotence check); bumps LRU on hit."""
        tokens = tuple(int(t) for t in path_tokens)
        if not tokens or len(tokens) % self.block:
            return False
        children = self.root
        node = None
        for i in range(len(tokens) // self.block):
            node = children.get(tuple(tokens[i * self.block:(i + 1) * self.block]))
            if node is None:
                return False
            children = node.children
        self._bump(node)
        return True

    def digest(self, top: int = 32) -> List[int]:
        """Compact advertisement of the hottest cached prefixes: crc32
        path hashes of the most-recently-used full-block nodes, newest
        first (prefix-affinity routing reads this off /healthz).  Safe
        from scrape threads for the same reason as
        :meth:`reclaimable_blocks` — the ``list()`` snapshot is atomic
        and parent chains on a node evicted mid-walk stay readable (a
        momentarily-stale hash, never an exception)."""
        nodes = list(self._nodes)
        nodes.sort(key=lambda n: n.last_used, reverse=True)
        out: List[int] = []
        for n in nodes:
            if len(n.tokens) != self.block:
                continue  # partial leaves are COW material, not routable
            out.append(prefix_path_hash(self.node_path(n)))
            if len(out) >= top:
                break
        return out

    # -- eviction -------------------------------------------------------
    def _evict_node(self, node: _PrefixNode) -> None:
        siblings = node.parent.children if node.parent else self.root
        del siblings[node.tokens]
        self._nodes.discard(node)
        if self.spill_hook is not None and len(node.tokens) == self.block:
            try:
                self.spill_hook(self.node_path(node), node.block_id)
            except Exception:  # noqa: BLE001 — spill failure never blocks
                pass           # eviction; the engine counts discards
        self.allocator.free([node.block_id])
        self.stats["evictions"] += 1

    def _evict_lru_leaves(self, done) -> int:
        """LRU leaf-first bulk eviction until ``done()``.  One heap over
        the current leaves + lazy re-push of parents that become leaves:
        O(evicted · log n), never the O(n²) rescan a full-index pressure
        eviction would otherwise cost inside the scheduler's admission
        path.  Single-threaded with its callers, so last_used cannot
        move mid-walk."""
        heap = [
            (n.last_used, id(n), n) for n in self._nodes if not n.children
        ]
        heapq.heapify(heap)
        count = 0
        while heap and not done():
            _, _, node = heapq.heappop(heap)
            if node not in self._nodes or node.children:
                continue  # stale entry
            parent = node.parent
            self._evict_node(node)
            count += 1
            if parent is not None and not parent.children \
                    and parent in self._nodes:
                heapq.heappush(
                    heap, (parent.last_used, id(parent), parent)
                )
        return count

    def evict_to_budget(self) -> int:
        """LRU leaf-first eviction down to ``budget_blocks``."""
        return self._evict_lru_leaves(
            lambda: len(self._nodes) <= self.budget
        )

    def evict_for(self, need_free: int) -> int:
        """Drop LRU cached prefixes until the allocator has
        ``need_free`` free blocks (or the index is empty) — the
        admission path calls this BEFORE failing an allocation, so
        unreferenced cached prefixes never starve live traffic.  Blocks
        a live row still shares only lose the index's reference (they
        free later, when the row releases)."""
        return self._evict_lru_leaves(
            lambda: self.allocator.free_count() >= need_free
        )

    def clear(self) -> int:
        """Drop EVERY cached prefix (ArenaReset: a rebuilt arena's pools
        never hold the old blocks' KV, so donation-invalidated blocks
        must never resurface as cache hits).  Not counted as evictions —
        nothing was displaced by traffic.  Free order does not matter
        (each node holds exactly one reference), so this is a single
        O(n) sweep, not the leaf-first eviction walk."""
        n = len(self._nodes)
        for node in self._nodes:
            self.allocator.free([node.block_id])
        self._nodes = set()
        self.root = {}
        return n


# ---------------------------------------------------------------------------
# Host-RAM spill tier + prefix digests (docs/serving.md "KV lifecycle")
#
# When the radix index evicts a block under LRU pressure, the KV it
# holds is still bit-correct — recomputing it later burns prefill FLOPs
# for nothing.  The spill store keeps a bounded host-RAM copy (gathered
# off-device by the engine via `gather_kv_blocks`, int8 scale planes
# included) keyed by the block's FULL token path; a later prefix match
# that runs past the on-device trie readmits from here instead of
# recomputing.  Graceful degradation is the contract: a checksum
# mismatch, budget pressure, or any readmit failure silently falls back
# to recompute behind a loud counter — never a failed request.
# ---------------------------------------------------------------------------


def _contiguous(a):
    """A C-contiguous host copy or view: numpy arrays and CPU tensors."""
    if isinstance(a, torch.Tensor):
        return a.contiguous()
    return np.ascontiguousarray(a)


def _raw_bytes(a) -> bytes:
    """The raw bytes of a contiguous numpy array or CPU tensor of any
    dtype (bfloat16, which numpy cannot hold, and float16 blocks alike are
    read as bytes, so the CRC sees every bit)."""
    if isinstance(a, torch.Tensor):
        return a.reshape(-1).view(torch.uint8).numpy().tobytes()
    return a.tobytes()


def prefix_path_hash(tokens) -> int:
    """Stable crc32 of a token path — the unit of the prefix digest
    `/healthz` advertises and the router matches against.  uint32
    little-endian byte layout so every replica and the router agree."""
    return zlib.crc32(
        np.asarray(list(tokens), dtype=np.uint32).tobytes()
    )


def prefix_digest_hashes(tokens, block: int) -> List[int]:
    """All block-aligned prefix hashes of a prompt, shortest first —
    what the router computes for an incoming request and intersects
    with each replica's advertised :meth:`PrefixIndex.digest`."""
    tokens = [int(t) for t in tokens]
    return [
        prefix_path_hash(tokens[:j * block])
        for j in range(1, len(tokens) // block + 1)
    ]


class PrefixSpillStore:
    """Bounded host-RAM store of evicted prefix blocks.

    Entries are keyed by the block's full token path and carry the
    block's gathered arrays (k/v, plus int8 scale planes when the arena
    quantizes) with a crc32 over the raw bytes; :meth:`get` verifies the
    checksum on every read and drops a torn entry rather than ever
    handing corrupt KV back to the arena.  ``budget_bytes`` caps the
    store (0 disables it); admission past the budget LRU-evicts, and an
    entry that alone exceeds the budget is refused outright — both
    counted in ``stats['discards']`` (the loud half of the graceful-
    degradation contract).  Single-threaded with the scheduler like the
    index it shadows."""

    def __init__(self, budget_bytes: int = 0) -> None:
        if budget_bytes < 0:
            raise ValueError(
                f"spill budget must be >= 0 bytes, got {budget_bytes}"
            )
        self.budget = int(budget_bytes)
        self._entries: "collections.OrderedDict[tuple, Dict[str, Any]]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self.stats: Dict[str, int] = {
            "spills": 0, "readmits": 0, "discards": 0,
        }

    @property
    def enabled(self) -> bool:
        return self.budget > 0

    def __len__(self) -> int:
        return len(self._entries)

    def bytes_used(self) -> int:
        return self._bytes

    @staticmethod
    def _crc(arrays: Dict[str, Any]) -> int:
        crc = 0
        for name in sorted(arrays):
            crc = zlib.crc32(_raw_bytes(arrays[name]), crc)
        return crc

    def put(self, key, arrays: Dict[str, Any]) -> bool:
        """Admit one evicted block's host copy (numpy arrays or CPU
        tensors); returns True when the entry landed.  A re-put of an
        existing key replaces it."""
        if not self.enabled:
            return False
        key = tuple(int(t) for t in key)
        arrs = {n: _contiguous(a) for n, a in arrays.items()}
        nbytes = int(sum(a.nbytes for a in arrs.values()))
        if nbytes > self.budget:
            self.stats["discards"] += 1
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old["nbytes"]
        while self._bytes + nbytes > self.budget and self._entries:
            _, lru = self._entries.popitem(last=False)
            self._bytes -= lru["nbytes"]
            self.stats["discards"] += 1
        self._entries[key] = {
            "arrays": arrs, "nbytes": nbytes, "crc": self._crc(arrs),
        }
        self._bytes += nbytes
        self.stats["spills"] += 1
        return True

    def get(self, key) -> Optional[Dict[str, Any]]:
        """Checksum-verified read; a corrupt entry is dropped (counted)
        and ``None`` returned — the caller recomputes.  A hit bumps
        LRU but leaves the entry resident (``pop`` removes it once the
        block is back on device)."""
        key = tuple(int(t) for t in key)
        entry = self._entries.get(key)
        if entry is None:
            return None
        if self._crc(entry["arrays"]) != entry["crc"]:
            self.discard(key)
            return None
        self._entries.move_to_end(key)
        return entry["arrays"]

    def pop(self, key) -> None:
        """Remove a successfully-readmitted entry (counted as a
        readmit, not a discard)."""
        key = tuple(int(t) for t in key)
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= entry["nbytes"]
            self.stats["readmits"] += 1

    def discard(self, key) -> None:
        """Drop an entry that failed verification or whose readmit
        failed — the loud-counter half of graceful degradation."""
        key = tuple(int(t) for t in key)
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= entry["nbytes"]
            self.stats["discards"] += 1

    def tear(self, key) -> bool:
        """Flip the bits of an entry's first payload byte in place, as a
        torn host copy would read (the ``spill_corrupt`` drill): the next
        :meth:`get` fails the checksum and discards it.  False when the
        key is not resident."""
        entry = self._entries.get(tuple(int(t) for t in key))
        if entry is None:
            return False
        a = entry["arrays"][sorted(entry["arrays"])[0]]
        raw = a.reshape(-1).view(torch.uint8) if isinstance(a, torch.Tensor) else a.reshape(-1).view(np.uint8)
        raw[0] ^= 0xFF
        return True

    def clear(self) -> int:
        """Invalidate EVERYTHING (ArenaReset: spilled copies of a dead
        arena's blocks must never readmit).  Not counted as discards —
        nothing was displaced by pressure."""
        n = len(self._entries)
        self._entries.clear()
        self._bytes = 0
        return n


# ---------------------------------------------------------------------------
# KV-handoff payload codec (disaggregated prefill/decode serving)
#
# A prefill replica exports one row's prefilled arena blocks and row state
# as one binary payload; the router hands it to a decode replica, which
# adopts the blocks into its own arena and decodes on.  Compact header plus
# raw buffers (handoff bytes are a measured metric):
#
#   magic "PFXH1" | uint32 LE header length | JSON header | raw array bytes
#
# The header's "meta" carries the row state (prompt ids, lengths, decode
# budget) and the compatibility signature (block size, kv dtype, pool
# shape) that `check_handoff_meta` validates loudly on the adopting side;
# "arrays" lists name, numpy dtype string and shape in payload order.
# ---------------------------------------------------------------------------

HANDOFF_MAGIC = b"PFXH1"

# the dtype string the JAX codec writes for a bfloat16 array (ml_dtypes'
# bfloat16 is a 2-byte void to numpy); the port writes the same for a
# bfloat16 tensor's raw words
BF16_WIRE_DTYPE = "<V2"


def _wire_array(arr) -> Tuple[str, Tuple[int, ...], bytes]:
    """(dtype string, shape, raw C-order bytes) of a numpy array or a CPU
    tensor: a bfloat16 tensor goes as its raw 2-byte words under
    :data:`BF16_WIRE_DTYPE`, any other tensor as the numpy array it views."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16_WIRE_DTYPE, tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    a = np.ascontiguousarray(arr)
    return a.dtype.str, tuple(a.shape), a.tobytes()


def pack_handoff(meta: Dict[str, Any], arrays: Dict[str, Any]) -> bytes:
    """Serialize (meta, named arrays) into one handoff payload.  Arrays
    (numpy arrays or CPU tensors) go as C-contiguous raw bytes; the header
    records name, dtype and shape in order, so :func:`unpack_handoff`
    round-trips bit for bit.  The same float32 / int8 arrays and meta give
    the JAX codec's bytes."""
    specs = []
    chunks = []
    for name, arr in arrays.items():
        dtype, shape, raw = _wire_array(arr)
        specs.append({"name": name, "dtype": dtype, "shape": list(shape)})
        chunks.append(raw)
    header = json.dumps({"meta": meta, "arrays": specs}, separators=(",", ":")).encode()
    return b"".join([HANDOFF_MAGIC, struct.pack("<I", len(header)), header, *chunks])


def unpack_handoff(data: bytes) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Parse a handoff payload back into (meta, numpy arrays; a bfloat16
    array stays a 2-byte void array until :func:`handoff_tensor` reads it
    into a bfloat16 arena).  Loud on a bad magic, a truncated header or
    array section, trailing bytes or a malformed header: a torn payload
    must never be adopted."""
    if data[:5] != HANDOFF_MAGIC:
        raise ValueError(f"not a KV-handoff payload (magic {data[:5]!r}, want {HANDOFF_MAGIC!r})")
    if len(data) < 9:
        raise ValueError("truncated KV-handoff payload (no header length)")
    (hlen,) = struct.unpack("<I", data[5:9])
    if len(data) < 9 + hlen:
        raise ValueError(f"truncated KV-handoff payload (header wants {hlen} bytes, "
                         f"{len(data) - 9} present)")
    try:
        header = json.loads(data[9:9 + hlen])
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt KV-handoff header: {e}") from None
    if not isinstance(header, dict) or not isinstance(header.get("arrays"), list) \
            or "meta" not in header:
        raise ValueError("corrupt KV-handoff header: want an object with meta and arrays")
    arrays: Dict[str, np.ndarray] = {}
    off = 9 + hlen
    for spec in header["arrays"]:
        try:
            name = str(spec["name"])
            dt = np.dtype(spec["dtype"])
            shape = tuple(int(s) for s in spec["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"corrupt KV-handoff array spec {spec!r:.80}: {e}") from None
        if dt.kind == "V" and dt.itemsize != 2:
            raise ValueError(f"KV-handoff array {name!r} has void dtype {dt.str!r}: only "
                             f"2-byte words ({BF16_WIRE_DTYPE}, bfloat16) are understood")
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if off + nbytes > len(data):
            raise ValueError(f"truncated KV-handoff payload: array {name!r} wants {nbytes} "
                             f"bytes past offset {off}, {len(data) - off} present")
        arrays[name] = np.frombuffer(data, dtype=dt, count=nbytes // dt.itemsize,
                                     offset=off).reshape(shape)
        off += nbytes
    if off != len(data):
        raise ValueError(f"KV-handoff payload has {len(data) - off} trailing bytes past the "
                         "declared arrays")
    return header["meta"], arrays


def handoff_tensor(arr, dtype: torch.dtype, name: str = "array") -> torch.Tensor:
    """A payload array as a CPU tensor of the arena's ``dtype``: a 2-byte
    void array (the bfloat16 wire type) is read as bfloat16 bits, only
    into a bfloat16 arena; any other array must already carry ``dtype``.
    A mismatch raises: mistyped bytes never reach an arena."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
    else:
        a = np.ascontiguousarray(arr)
        if a.dtype.kind == "V":
            if a.dtype.itemsize != 2 or dtype != torch.bfloat16:
                raise ValueError(f"handoff {name} dtype {a.dtype.str} (bfloat16 words) != arena "
                                 f"{dtype}")
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        t = torch.from_numpy(a.copy())
    if t.dtype != dtype:
        raise ValueError(f"handoff {name} dtype {t.dtype} != arena {dtype}")
    return t


def check_handoff_meta(meta: Dict[str, Any], *, block: int, kv_dtype: str,
                       pool_sig: List[int]) -> None:
    """Validate a payload's compatibility signature against the adopting
    arena, naming every mismatch.  ``pool_sig`` is [layers, heads, block,
    head_dim] (the arena shape minus num_blocks, which may differ between
    replicas).  Each field coerces under its own guard, so a malformed
    value lands as a named problem, never a bare TypeError."""
    problems = []
    if not isinstance(meta, dict):
        raise ValueError(f"KV-handoff meta must be an object, got {type(meta).__name__}")
    try:
        if int(meta.get("block", -1)) != int(block):
            problems.append(f"block size {meta.get('block')} != arena block {block}")
    except (TypeError, ValueError):
        problems.append(f"block size {meta.get('block')!r} is not an integer")
    if str(meta.get("kv_dtype", "")) != str(kv_dtype):
        problems.append(f"kv dtype {meta.get('kv_dtype')!r} != arena dtype {kv_dtype!r}")
    try:
        sig = [int(x) for x in meta.get("pool_sig", [])]
    except (TypeError, ValueError):
        sig = None
        problems.append(f"pool_sig {meta.get('pool_sig')!r} is not a list of integers")
    if sig is not None and sig != [int(x) for x in pool_sig]:
        problems.append(f"pool shape {meta.get('pool_sig')} != arena {list(pool_sig)}")
    if problems:
        raise ValueError(
            "KV-handoff payload incompatible with this arena: " + "; ".join(problems)
            + " (prefill and decode replicas must share Model config, PFX_KV_BLOCK, and "
            "kv_dtype)"
        )


class PagedCacheManager:
    """Per-sequence block tables over one :class:`BlockAllocator`.

    A sequence reserves its WHOLE capacity (prompt + decode budget) at
    admission: growth never fails mid-decode, the table is static for the
    row's lifetime, and the scheduler's compile-shape bucket (table
    width) only changes at admit/evict boundaries.

    ``prefix_blocks`` > 0 enables the shared-prefix radix index
    (:class:`PrefixIndex`): admission can map already-cached prefix
    blocks into a new row's table as SHARED (refcounted) entries, and an
    allocation that would otherwise fail first evicts unreferenced
    cached prefixes.
    """

    def __init__(self, num_blocks: int, block: int = 0,
                 prefix_blocks: int = 0, spill_bytes: int = 0) -> None:
        self.block = kv_block_size(block)
        self.allocator = BlockAllocator(num_blocks)
        self.prefix = PrefixIndex(self.allocator, self.block, prefix_blocks)
        # host-RAM demotion tier for LRU-evicted prefix blocks
        # (--prefix-spill-bytes; 0 = off).  The engine wires
        # prefix.spill_hook to feed it and owns the readmit path.
        self.spill = PrefixSpillStore(spill_bytes)
        self._tables: Dict[int, List[int]] = {}

    def available_blocks(self) -> int:
        """Blocks an admission can actually obtain: free now, plus
        cached-prefix blocks nothing but the index references (those
        evict on demand).  O(cached nodes) — callers on the per-
        iteration hot path should try :meth:`can_admit`'s free-count
        short-circuit first."""
        return self.allocator.free_count() + self.prefix.reclaimable_blocks()

    def can_admit(self, tokens: int) -> bool:
        need = blocks_for(tokens, self.block)
        if need <= self.allocator.free_count():
            return True  # skip the O(cached-nodes) reclaimable scan
        return need <= self.available_blocks()

    def admit(self, seq_id: int, tokens: int,
              shared: Optional[List[int]] = None) -> List[int]:
        """Allocate ``ceil(tokens / block)`` blocks for a new sequence.

        ``shared`` (prefix-hit admission) lists already-cached blocks to
        map as the row's FIRST table entries: the row takes one
        reference on each (so a later index eviction cannot reclaim
        them) and only the remainder is freshly allocated.  If the free
        pool cannot cover the remainder, unreferenced cached prefixes
        are evicted first; :class:`BlockPoolExhausted` only raises once
        the index has nothing left to give — and then atomically (the
        shared references are returned)."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already admitted")
        shared = list(shared or [])
        need = blocks_for(tokens, self.block) - len(shared)
        if need < 0:
            raise ValueError(
                f"{len(shared)} shared blocks exceed the "
                f"{blocks_for(tokens, self.block)}-block capacity"
            )
        # reference the shared blocks FIRST: the evict-for-room pass
        # below may drop these very nodes from the index, and the row's
        # reference is what keeps their KV alive through that
        self.allocator.share(shared)
        if need > self.allocator.free_count():
            self.prefix.evict_for(need)
        try:
            fresh = self.allocator.alloc(need) if need else []
        except BlockPoolExhausted:
            self.allocator.free(shared)
            raise
        table = shared + fresh
        self._tables[seq_id] = table
        return list(table)

    def release(self, seq_id: int) -> None:
        """Free a finished/evicted sequence's blocks (loud on unknown id)."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise ValueError(f"sequence {seq_id} has no allocation")
        self.allocator.free(table)

    def stats(self) -> Dict[str, float]:
        # kv_blocks_used counts PHYSICAL blocks (allocator refcounts
        # dedupe sharing): occupancy can never exceed the arena no
        # matter how many rows share a prefix
        return {
            "kv_blocks_used": self.allocator.used_count(),
            "kv_blocks_free": self.allocator.free_count(),
            "kv_block_size": self.block,
            "live_sequences": len(self._tables),
            "fragmentation": round(self.allocator.fragmentation(), 4),
            "prefix_cached_blocks": self.prefix.cached_blocks(),
            "prefix_spill_bytes": self.spill.bytes_used(),
            "prefix_spill_entries": len(self.spill),
        }
