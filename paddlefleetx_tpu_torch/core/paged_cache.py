"""Block-paged KV cache bookkeeping: the host-side block allocator and the
per-sequence block tables over the arena.

Copy of ``paddlefleetx_tpu/core/paged_cache.py:52-136,858-972`` (pure
host Python; the port keeps its own copy rather than importing the JAX
package).  A sequence owns a BLOCK TABLE (logical block j -> arena block
id) into a preallocated arena of fixed-size blocks; the arena itself
(``PagedPools``) lives in ``models/gpt/generation.py`` and the kernel
that reads it is ``ops/decode_attention.paged_decode_attention``.

  - **block 0 is the null block**: never allocated, never freed.  Padded
    table entries and inactive batch rows point at it, so a fixed-shape
    decode step always has a safe write/gather target.
  - **loud exhaustion, never corruption**: ``alloc`` raises
    :class:`BlockPoolExhausted` when the pool cannot satisfy a request,
    ``free`` raises on a double free or an out-of-range id.

Not ported yet (each refused where it is asked for): the shared-prefix
radix index (``prefix_blocks > 0``) with the block refcounts it needs,
its host-RAM spill tier (``spill_bytes > 0``) and the KV handoff
pack/unpack.

Knob, parsed loudly as in the JAX package:

  PFX_KV_BLOCK   block size in cache slots (default 16; positive
                 multiple of 8)
"""

from __future__ import annotations

import os
from typing import Dict, List

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

    Free blocks are handed out lowest-id-first, so live allocations stay
    packed toward the front of the arena and the same admit/release
    sequence gives the same block ids as the JAX allocator."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 usable + the null block), got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(1, self.num_blocks))
        self._used: set = set()

    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        return len(self._used)

    def fragmentation(self) -> float:
        """1 - (largest contiguous free run / free blocks)."""
        if not self._free:
            return 0.0
        runs, best, cur = sorted(self._free), 1, 1
        for a, b in zip(runs, runs[1:]):
            cur = cur + 1 if b == a + 1 else 1
            best = max(best, cur)
        return 1.0 - best / len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks, lowest ids first; raises
        :class:`BlockPoolExhausted` naming the shortfall."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"KV block pool exhausted: need {n}, have {len(self._free)} "
                f"free of {self.num_blocks - 1} usable"
            )
        self._free.sort()
        out, self._free = self._free[:n], self._free[n:]
        self._used.update(out)
        return out

    def free(self, blocks) -> None:
        """Return blocks to the pool; loud (and atomic) on the null block,
        an out-of-range id, a block that is not allocated or a duplicate
        id within one call: any of those means two sequences believe they
        own one block."""
        blocks = list(blocks)
        seen: set = set()
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("cannot free the null block (id 0)")
            if not (0 < b < self.num_blocks):
                raise ValueError(f"block id {b} out of range (1..{self.num_blocks - 1})")
            if b not in self._used or b in seen:
                raise ValueError(f"double free of block {b} (not currently allocated)")
            seen.add(b)
        self._used.difference_update(blocks)
        self._free.extend(blocks)


class PagedCacheManager:
    """Per-sequence block tables over one :class:`BlockAllocator`.

    A sequence reserves its WHOLE capacity (prompt + decode budget) at
    admission: growth never fails mid-decode and the table is static for
    the row's lifetime.  ``prefix_blocks`` and ``spill_bytes`` (the
    prefix cache and its spill tier) must be 0: they are not ported."""

    def __init__(self, num_blocks: int, block: int = 0,
                 prefix_blocks: int = 0, spill_bytes: int = 0) -> None:
        if prefix_blocks or spill_bytes:
            raise NotImplementedError(
                "the shared-prefix cache (prefix_blocks) and its spill tier "
                "(spill_bytes) are not ported to the PyTorch paged cache yet"
            )
        self.block = kv_block_size(block)
        self.allocator = BlockAllocator(num_blocks)
        self._tables: Dict[int, List[int]] = {}

    def can_admit(self, tokens: int) -> bool:
        return blocks_for(tokens, self.block) <= self.allocator.free_count()

    def admit(self, seq_id: int, tokens: int) -> List[int]:
        """Allocate ``ceil(tokens / block)`` blocks for a new sequence."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already admitted")
        table = self.allocator.alloc(blocks_for(tokens, self.block))
        self._tables[seq_id] = table
        return list(table)

    def release(self, seq_id: int) -> None:
        """Free a finished/evicted sequence's blocks (loud on unknown id)."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise ValueError(f"sequence {seq_id} has no allocation")
        self.allocator.free(table)

    def stats(self) -> Dict[str, float]:
        return {
            "kv_blocks_used": self.allocator.used_count(),
            "kv_blocks_free": self.allocator.free_count(),
            "kv_block_size": self.block,
            "live_sequences": len(self._tables),
            "fragmentation": round(self.allocator.fragmentation(), 4),
        }
