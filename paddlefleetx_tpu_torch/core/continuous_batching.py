"""Continuous batching: iteration-level scheduling over a paged KV cache.

Counterpart of ``paddlefleetx_tpu/core/continuous_batching.py``.  The
decode STEP is the scheduling unit: at every step boundary the running
batch can admit new rows (prefill-on-admit) and retire finished or
expired ones; each row owns a block table into a shared arena
(``core/paged_cache.py``), so admission allocates blocks, eviction frees
them, and no row pays another row's length.

  - :class:`PagedDecodeEngine`: the device side.  Owns the arena
    (``PagedPools``, written in place), the per-slot row state (host
    numpy mirrors of positions, budgets and activity; pending logits and
    repetition counts on the device) and runs one fixed-capacity step
    at a time.  Each step uploads the block tables and the row state as
    one int32 array, runs ``models/gpt/generation.decode_step`` (the
    paged attention kernel on the card, its plain version on the CPU)
    and reads back the sampled tokens and the new activity in one copy.
    With speculation on (``Generation.speculative.draft_k``), each step
    is one draft-verify iteration instead (``decode_step_spec``): the
    host drafts k tokens a row from its own history (n-gram lookup), the
    step verifies them at t = k + 1 and commits 1 to k + 1 tokens a row.
  - :class:`ContinuousScheduler`: the host side, with the admission
    surface of ``core/request_queue.RequestQueue`` (bounded ``submit``
    -> QueueFull/QueueClosed, deadlines, ``try_remove``, graceful
    ``close``/``join`` drain), so ``tools/serve.py`` swaps schedulers
    behind ``--scheduler``.  One thread, one iteration per decode step:
    shed expired waiting entries, evict expired active rows mid-decode,
    admit from the queue head (FCFS) while slots and blocks allow, step.

Greedy outputs are token-identical to the coalescing path and to the
JAX engine, with or without speculation.  The stepping is synchronous:
the JAX scheduler's dispatch-ahead decode and its ``PFX_SCHED_QUANTUM``
are not ported, and neither variable is read here.  Not ported either,
and refused where asked for: the prefix cache and its spill tier,
chunked prefill, KV handoff, tenancy and preemption, streaming, the
decision log and the goodput ledgers.  No CUDA graphs yet: the
``stats["traces"]`` count of distinct step and prefill shapes is what a
later capture would key on.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddlefleetx_tpu_torch.core.paged_cache import (
    NULL_BLOCK,
    BlockPoolExhausted,
    PagedCacheManager,
    blocks_for,
    kv_block_size,
)
from paddlefleetx_tpu_torch.core.request_queue import (
    DeadlineExceeded,
    QueueClosed,
    QueueFull,
    RequestFuture,
)
from paddlefleetx_tpu_torch.models.gpt.generation import (
    PagedRows,
    bucket_len,
    decode_step,
    decode_step_spec,
    init_paged_pools,
    paged_prefill,
)
from paddlefleetx_tpu_torch.ops.decode_attention import kv_cache_dtype
from paddlefleetx_tpu_torch.ops.speculative import (
    NGRAM_WINDOW,
    SpecConfig,
    ngram_propose_host,
)
from paddlefleetx_tpu_torch.utils.log import logger


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ArenaReset(RuntimeError):
    """A prefill or decode step failed mid-write and the arena was
    rebuilt: every row that was live died with it.  ``dead_rows`` lets
    the scheduler fail exactly the affected requests; the original
    failure is chained as ``__cause__``."""

    def __init__(self, msg: str, dead_rows: List["_Row"]) -> None:
        super().__init__(msg)
        self.dead_rows = dead_rows


@dataclasses.dataclass(eq=False)
class _Row:
    """One active decode row (slot) in the running batch."""

    seq_id: int
    entry: Optional["_CBEntry"]
    row_idx: int  # index into the entry's prompts
    prompt_ids: List[int]  # the speculative drafter reads prompt + tokens
    table: List[int]
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)


@dataclasses.dataclass(eq=False)
class _CBEntry:
    """One admitted client request (1..n prompts, answered atomically)."""

    prompts: List[List[int]]
    max_new: int
    deadline: Optional[float]
    future: RequestFuture
    enqueued_at: float
    next_row: int = 0  # rows [0, next_row) admitted so far
    done_rows: int = 0
    results: List[Optional[List[int]]] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.results = [None] * len(self.prompts)


class PagedDecodeEngine:
    """Device-side continuous-batching engine over a ``GenerationServer``'s
    model, device and generation config.  Host code drives it one decode
    step at a time (``admit`` / ``step`` / ``release``).

    A failure inside a prefill or a step may leave the arena half
    written: :meth:`reset` rebuilds it and the caller fails the rows that
    were live (:class:`ArenaReset`), as the JAX engine does after a
    failed donating dispatch."""

    def __init__(self, server, *, max_batch: int = 8, block: int = 0,
                 num_blocks: int = 0, spec="auto", kv_dtype: str = "",
                 prefix_cache_blocks: int = 0, prefill_chunk: int = 0,
                 prefix_spill_bytes: int = 0) -> None:
        # speculation: "auto" inherits the server's parsed
        # Generation.speculative (one parse site, so both schedulers agree
        # on one config); a SpecConfig overrides, None turns it off
        if spec == "auto":
            spec = server.spec
        if spec is not None and not isinstance(spec, SpecConfig):
            raise ValueError(f"spec must be a SpecConfig or None, got {spec!r}")
        if prefix_cache_blocks or prefix_spill_bytes:
            raise NotImplementedError(
                "the shared-prefix cache (prefix_cache_blocks) and its spill tier "
                "(prefix_spill_bytes) are not ported to the PyTorch port yet"
            )
        if prefill_chunk:
            raise NotImplementedError(
                "chunked prefill (prefill_chunk) is not ported to the PyTorch "
                "port yet; prompts prefill whole on admission"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.server = server
        self.spec = spec
        self.draft_k = spec.draft_k if spec is not None else 0
        self.model = server.model
        self.mcfg = server.module.config
        self.gen = server.gen
        self.device = server.device
        self.bucket = server.bucket
        self.block = kv_block_size(block)
        self.kv_dtype = kv_cache_dtype(kv_dtype) if kv_dtype else server.kv_dtype
        self.context = int(self.mcfg.max_position_embeddings)
        self.max_row_blocks = blocks_for(self.context + self.draft_k, self.block)
        self.capacity = int(max_batch)
        if num_blocks <= 0:
            num_blocks = self.capacity * self.max_row_blocks + 1
        self.cache = PagedCacheManager(num_blocks, self.block)
        self.pools = init_paged_pools(self.mcfg, num_blocks, self.block, self.device,
                                      kv_dtype=self.kv_dtype)
        B, vocab = self.capacity, int(self.mcfg.vocab_size)
        self._logits = torch.zeros((B, vocab), dtype=torch.float32, device=self.device)
        self._counts = torch.zeros((B, vocab), dtype=torch.int32, device=self.device)
        self._reject = torch.full((B,), -1, dtype=torch.int32, device=self.device)
        self.positions = np.zeros((B,), np.int32)
        self.gen_steps = np.zeros((B,), np.int32)
        self.max_news = np.zeros((B,), np.int32)
        self.forced_steps = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.slots: List[Optional[_Row]] = [None] * B
        self._seq_counter = 0
        self._warmup = False  # warmup steps are not traffic: no spec stats
        # distinct (capacity, table width) step shapes and (prompt bucket,
        # prefill blocks) shapes run so far: the JAX engine's compile
        # families, and what a CUDA-graph capture would key on
        self._shapes: set = set()
        self.stats: Dict[str, Any] = {
            "traces": 0, "steps": 0, "prefills": 0, "prefill_tokens": 0,
            "mid_decode_admits": 0, "spec_proposed": 0, "spec_accepted": 0,
            "spec_accept_rate": 0.0,
        }

    # -- capacity queries ----------------------------------------------
    def row_capacity_tokens(self, prompt_len: int, max_new: int) -> int:
        """Cache slots a row reserves: its full decode budget (clamped to
        the context room, as admit() clamps it) plus at least the prefill
        bucket width, whose pad junk lands in the row's own blocks.  With
        speculation on, ``draft_k`` slack slots take the verify chunk's
        rejected tail past the budget: a chunk slot past a row's table
        would clamp onto the table's last entry, a real slot of the row."""
        P = bucket_len(prompt_len, self.bucket)
        limit = self.context - P
        return max(prompt_len + min(max_new, max(1, limit)) + self.draft_k, P)

    def free_slots(self) -> int:
        return sum(1 for r in self.slots if r is None)

    def active_rows(self) -> int:
        return int(self.active.sum())

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return self.free_slots() > 0 and self.cache.can_admit(
            self.row_capacity_tokens(prompt_len, max_new)
        )

    def validate_request(self, prompt_len: int, max_new: int) -> None:
        """Reject (loudly, before admission) a row that could never fit."""
        need = blocks_for(self.row_capacity_tokens(prompt_len, max_new), self.block)
        usable = self.cache.allocator.num_blocks - 1
        if need > usable:
            raise ValueError(
                f"request needs {need} KV blocks but the pool has {usable}; "
                f"raise --kv-blocks or lower max_tokens"
            )

    def _note_shape(self, key: tuple) -> None:
        if key not in self._shapes:
            self._shapes.add(key)
            self.stats["traces"] = len(self._shapes)

    # -- admission -----------------------------------------------------
    @torch.inference_mode()
    def admit(self, prompt_ids: Sequence[int], max_new: int,
              entry: Optional[_CBEntry] = None, row_idx: int = 0) -> int:
        """Allocate blocks and a batch slot and prefill the prompt into the
        arena; returns the slot.  Raises :class:`BlockPoolExhausted` /
        RuntimeError("no free slot") when full (check :meth:`can_admit`
        first) and :class:`ArenaReset` when the prefill fails."""
        prompt_ids = [int(t) for t in prompt_ids]
        plen = len(prompt_ids)
        if plen < 1:
            raise ValueError("prompt must be non-empty")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        P = bucket_len(plen, self.bucket)
        limit = self.context - P
        if limit < 1:
            raise ValueError(
                f"prompt bucket {P} leaves no decode room in context {self.context}"
            )
        # the coalescing path trims an over-budget request to the context
        # room (core/serving.plan_decode); deliver the identical count
        max_new = min(int(max_new), limit)
        slot = next((i for i, r in enumerate(self.slots) if r is None), None)
        if slot is None:
            raise RuntimeError("no free slot in the running batch")
        self._seq_counter += 1
        seq_id = self._seq_counter
        table = self.cache.admit(seq_id, self.row_capacity_tokens(plen, max_new))
        # the prefill writes the bucket's PB blocks (pad junk included);
        # the reservation always covers at least the bucket width
        PB = blocks_for(P, self.block)
        prompt = torch.full((1, P), self.gen.pad_token_id, dtype=torch.int64)
        prompt[0, :plen] = torch.tensor(prompt_ids, dtype=torch.int64)
        try:
            last, counts = paged_prefill(
                self.model, prompt.to(self.device), plen, self.pools, table[:PB]
            )
            self._logits[slot] = last
            self._counts[slot] = counts
        except BaseException as exc:
            self.cache.release(seq_id)
            dead = self.reset()
            raise ArenaReset(
                f"prefill failed ({type(exc).__name__}: {exc}); arena reset", dead
            ) from exc
        self._note_shape(("prefill", P, PB))
        if bool((self.active & (self.gen_steps > 0)).any()):
            self.stats["mid_decode_admits"] += 1
        self.positions[slot] = plen
        self.gen_steps[slot] = 0
        self.max_news[slot] = max_new
        # forced EOS fires where the coalescing path fires it: the bucketed
        # run end of core/serving.plan_decode, not the raw budget
        self.forced_steps[slot] = min(-(-max_new // 32) * 32, limit) - 1
        self.active[slot] = True
        self._reject[slot] = -1
        self.slots[slot] = _Row(
            seq_id=seq_id, entry=entry, row_idx=row_idx, prompt_ids=prompt_ids, table=table,
        )
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += plen
        return slot

    def table_width_bucket(self) -> int:
        widest = max((len(r.table) for r in self.slots if r is not None), default=1)
        return min(_pow2_at_least(widest), _pow2_at_least(self.max_row_blocks))

    # -- stepping --------------------------------------------------------
    def _host_drafts(self) -> np.ndarray:
        """Self-draft every active row from its prompt and tokens on the
        host: the n-gram lookup proposes k + 1 tokens; proposal[0] guesses
        the pending token the step samples first, proposals[1:] are the
        drafts of the verify chunk.  The lookup never scans past
        NGRAM_WINDOW, so it gets only that tail (plus the needle and draft
        slack): no copy of a row's whole history per step."""
        k, n = self.spec.draft_k, self.spec.ngram
        need = NGRAM_WINDOW + n + k + 2
        out = np.zeros((self.capacity, k), np.int32)
        for i, r in enumerate(self.slots):
            if r is not None and self.active[i]:
                if len(r.tokens) >= need:
                    seq = r.tokens[-need:]
                else:
                    seq = r.prompt_ids[-(need - len(r.tokens)):] + r.tokens
                out[i] = ngram_propose_host(seq, k + 1, n=n)[1:]
        return out

    @torch.inference_mode()
    def step(self) -> List[int]:
        """Run ONE decode step for every active row (speculative: one
        draft-verify iteration, committing 1 to draft_k + 1 tokens a row);
        returns the slots that finished (their tokens are complete:
        release them with :meth:`release`).  A row finishes on EOS or on
        its budget inside the committed window, never past it.  Raises
        :class:`ArenaReset` when the step fails."""
        if not self.active.any():
            return []
        B = self.capacity
        M = self.table_width_bucket()
        k = self.draft_k
        was_active = self.active.copy()
        # one host -> device copy per step: the null-padded block tables,
        # the five per-row int32 state rows and the drafts, as int32 views
        # of one array
        flat = np.full((B * M + 5 * B + B * k,), NULL_BLOCK, np.int32)
        tables = flat[:B * M].reshape(B, M)
        for i, r in enumerate(self.slots):
            if r is not None:
                tables[i, : len(r.table)] = r.table
        flat[B * M:B * M + 5 * B] = np.concatenate([
            self.positions, self.gen_steps, self.max_news, self.forced_steps,
            self.active.astype(np.int32),
        ])
        if k:
            flat[B * M + 5 * B:] = self._host_drafts().reshape(-1)
        try:
            nb = self.cache.allocator.num_blocks
            if tables.min() < 0 or tables.max() >= nb:  # the kernel trusts its tables
                raise RuntimeError(f"block table entry outside [0, {nb}): {tables.tolist()}")
            dev_flat = torch.from_numpy(flat).to(self.device)
            st = dev_flat[B * M:B * M + 5 * B].view(5, B)
            rows = PagedRows(
                logits=self._logits, counts=self._counts, positions=st[0], gen_steps=st[1],
                max_news=st[2], active=st[4].bool(), forced_steps=st[3],
                reject=self._reject if k else None,
            )
            dev_tables = dev_flat[:B * M].view(B, M)
            if k:
                window, ncommit, rows2 = decode_step_spec(
                    self.model, self.pools, dev_tables, rows,
                    dev_flat[B * M + 5 * B:].view(B, k), self.gen,
                    generator=self.server.generator,
                )
                self._reject = rows2.reject
            else:
                nxt, rows2 = decode_step(
                    self.model, self.pools, dev_tables, rows, self.gen,
                    generator=self.server.generator,
                )
                window, ncommit = nxt[:, None], rows.active.long()
            self._logits = rows2.logits
            self._counts = rows2.counts
            out = torch.cat([window.long(), ncommit.long()[:, None],
                             rows2.active.long()[:, None]], dim=1).cpu().numpy()
        except BaseException as exc:
            dead = self.reset()
            raise ArenaReset(
                f"decode step failed ({type(exc).__name__}: {exc}); arena reset", dead
            ) from exc
        self._note_shape(("step", B, M))
        self.stats["steps"] += 1
        ncommit = out[:, -2].astype(np.int32)
        new_active = out[:, -1].astype(bool)
        self.positions[was_active] += ncommit[was_active]
        self.gen_steps[was_active] += ncommit[was_active]
        self.active[was_active] = new_active[was_active]
        finished: List[int] = []
        for i, r in enumerate(self.slots):
            if r is None or not was_active[i]:
                continue
            for tok in out[i, :ncommit[i]].tolist():
                if tok != self.gen.eos_token_id:
                    r.tokens.append(tok)
            if not new_active[i]:
                finished.append(i)
        n_act = int(was_active.sum())
        if k and n_act and not self._warmup:
            self.stats["spec_proposed"] += k * n_act
            self.stats["spec_accepted"] += int(ncommit[was_active].sum()) - n_act
            self.stats["spec_accept_rate"] = (
                self.stats["spec_accepted"] / self.stats["spec_proposed"])
        return finished

    def release(self, slot: int) -> None:
        """Return a finished/evicted row's blocks to the pool and clear its
        batch slot (loud on an empty slot)."""
        row = self.slots[slot]
        if row is None:
            raise ValueError(f"slot {slot} is already empty")
        self.cache.release(row.seq_id)
        self.slots[slot] = None
        self.active[slot] = False
        self.positions[slot] = 0
        self.gen_steps[slot] = 0
        self.max_news[slot] = 0
        self.forced_steps[slot] = 0

    def reset(self) -> List[_Row]:
        """Rebuild the arena after a failed prefill or step; returns the
        rows that were live (the caller fails their requests)."""
        dead = [r for r in self.slots if r is not None]
        for r in dead:
            self.cache.release(r.seq_id)
        self.slots = [None] * self.capacity
        self.active[:] = False
        self.positions[:] = 0
        self.gen_steps[:] = 0
        self.max_news[:] = 0
        self.forced_steps[:] = 0
        self.pools = init_paged_pools(
            self.mcfg, self.cache.allocator.num_blocks, self.block, self.device,
            kv_dtype=self.kv_dtype,
        )
        self._logits = torch.zeros_like(self._logits)
        self._counts = torch.zeros_like(self._counts)
        self._reject = torch.full_like(self._reject, -1)
        return dead

    def warmup(self, prompt_lens: Sequence[int]) -> Dict[str, float]:
        """Run one admission and one step per prompt bucket before traffic
        (builds the kernels on the card; with speculation on, the step is
        the t = draft_k + 1 verify); fails loudly naming the bucket."""
        per: Dict[str, float] = {}
        self._warmup = True
        try:
            for n in prompt_lens:
                t0 = time.time()
                try:
                    slot = self.admit([1] * int(n), max_new=self.gen.max_dec_len)
                    self.step()
                    if self.slots[slot] is not None:
                        self.release(slot)
                except Exception as exc:
                    raise RuntimeError(
                        f"continuous warmup failed at bucket {n} (warmed so far: "
                        f"{sorted(per) or 'none'}): {type(exc).__name__}: {exc}"
                    ) from exc
                per[str(int(n))] = round(time.time() - t0, 3)
                logger.info(
                    f"continuous warmup: prompt bucket {n} ran in {per[str(int(n))]:.2f}s")
        finally:
            self._warmup = False
        return per


class ContinuousScheduler:
    """Iteration-level scheduler with the ``RequestQueue`` admission
    surface: single tenant, FCFS.

    ``submit`` -> bounded waiting queue (QueueFull / QueueClosed exactly
    like RequestQueue); the scheduler thread loops one decode step per
    iteration: shed expired waiting entries, evict expired ACTIVE rows
    mid-decode (blocks freed at once), admit from the queue head while
    slots and blocks allow (prefill-on-admit), then step the batch."""

    kind = "continuous"

    def __init__(self, engine: PagedDecodeEngine, *, max_depth: int = 64,
                 name: str = "serve-cb") -> None:
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.engine = engine
        self.max_depth = int(max_depth)
        self.name = name
        self._entries: List[_CBEntry] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._busy_since: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        # the RequestQueue keys that apply (no coalescing: rows join the
        # running batch instead) plus the continuous-only counters
        self.stats = {
            "submitted": 0, "completed": 0, "batches": 0,
            "shed_deadline": 0, "rejected_full": 0, "rejected_closed": 0,
            "gen_errors": 0, "evictions": 0, "prefill_admits": 0,
        }

    # -- admission (RequestQueue-compatible surface) --------------------
    def submit(self, prompts: Sequence[Any], max_new_tokens: int, *,
               coalesce_key=None, deadline_s: Optional[float] = None) -> RequestFuture:
        """Admit a request and return its future (``coalesce_key`` is
        accepted for the RequestQueue signature and ignored).  Raises
        ValueError for a prompt that can never fit the arena,
        ``QueueClosed`` when draining and ``QueueFull`` at capacity."""
        if not prompts:
            raise ValueError("prompts must be non-empty")
        for p in prompts:
            self.engine.validate_request(len(p), int(max_new_tokens))
        now = time.monotonic()
        entry = _CBEntry(
            prompts=[list(p) for p in prompts],
            max_new=int(max_new_tokens),
            deadline=now + float(deadline_s) if deadline_s is not None else None,
            future=RequestFuture(),
            enqueued_at=now,
        )
        with self._wake:
            if self._closed:
                self.stats["rejected_closed"] += 1
                raise QueueClosed(f"{self.name} queue is draining")
            if len(self._entries) >= self.max_depth:
                self.stats["rejected_full"] += 1
                raise QueueFull(f"{self.name} queue full ({self.max_depth} waiting)")
            self._entries.append(entry)
            self.stats["submitted"] += 1
            self._wake.notify_all()
        return entry.future

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def busy_seconds(self) -> float:
        with self._lock:
            if self._busy_since is None:
                return 0.0
            return time.monotonic() - self._busy_since

    def stats_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)

    def serving_stats(self) -> Dict[str, Any]:
        """The engine's stats and the arena's occupancy."""
        eng = self.engine
        return {**eng.stats, **eng.cache.stats(), "active_rows": eng.active_rows()}

    def try_remove(self, future: RequestFuture) -> bool:
        """Shed a WAITING entry (no row admitted yet).  An entry already in
        the running batch resolves via mid-decode eviction instead."""
        with self._wake:
            for e in self._entries:
                if e.future is future and e.next_row == 0:
                    self._entries.remove(e)
                    self.stats["shed_deadline"] += 1
                    e.future.set_exception(DeadlineExceeded("deadline exceeded while queued"))
                    return True
        return False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "ContinuousScheduler":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=f"{self.name}-scheduler", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop admitting; admitted entries and live rows still run."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()

    def join(self, timeout: Optional[float] = None) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Close and drain: every admitted entry still runs; False on
        timeout."""
        self.close()
        return self.join(timeout)

    def warmup(self, prompt_lens: Sequence[int]) -> Dict[str, float]:
        return self.engine.warmup(prompt_lens)

    # -- scheduler loop -------------------------------------------------
    def _has_live_rows(self) -> bool:
        return any(r is not None for r in self.engine.slots)

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._entries and not self._has_live_rows():
                    if self._closed:
                        return  # drained
                    self._wake.wait()
                self._busy_since = time.monotonic()
            try:
                self._iterate()
            finally:
                with self._lock:
                    self._busy_since = None

    def _shed_locked(self, entry: _CBEntry) -> None:
        self.stats["shed_deadline"] += 1
        waited = time.monotonic() - entry.enqueued_at
        logger.warning(f"{self.name}: shed expired request after {waited:.2f}s queued")
        entry.future.set_exception(
            DeadlineExceeded(f"deadline exceeded after {waited:.2f}s queued")
        )

    def _evict_entry(self, entry: _CBEntry, reason: str) -> None:
        """Mid-decode eviction: free every admitted row of the entry and
        resolve its future; the blocks return to the pool at once."""
        eng = self.engine
        n = 0
        for i, r in enumerate(eng.slots):
            if r is not None and r.entry is entry:
                eng.release(i)
                n += 1
        with self._lock:
            self.stats["evictions"] += n
            self.stats["shed_deadline"] += 1
        waited = time.monotonic() - entry.enqueued_at
        logger.warning(
            f"{self.name}: evicted {n} mid-decode row(s) of an expired request "
            f"after {waited:.2f}s ({reason})"
        )
        if not entry.future.done():
            entry.future.set_exception(
                DeadlineExceeded(f"deadline exceeded after {waited:.2f}s ({reason})")
            )

    def _fail_rows(self, rows, exc: BaseException) -> None:
        for e in {r.entry for r in rows if r.entry is not None}:
            if not e.future.done():
                e.future.set_exception(exc)

    def _iterate(self) -> int:
        """One scheduler iteration; returns the rows it finished."""
        eng = self.engine
        now = time.monotonic()
        admitted: List[tuple] = []
        expired_partial: List[_CBEntry] = []
        with self._wake:
            # shed expired WAITING entries before spending anything; an
            # expired PARTIALLY admitted entry leaves the queue too and is
            # evicted below
            keep: List[_CBEntry] = []
            for e in self._entries:
                if e.deadline is not None and now > e.deadline:
                    if e.next_row == 0:
                        self._shed_locked(e)
                    else:
                        expired_partial.append(e)
                else:
                    keep.append(e)
            self._entries = keep

        # evict expired ACTIVE rows before picking admissions: their slots
        # and blocks serve this same iteration's admissions
        expired = set(expired_partial)
        for r in eng.slots:
            if r is not None and r.entry is not None:
                if r.entry.deadline is not None and now > r.entry.deadline:
                    expired.add(r.entry)
        partial = set(expired_partial)
        for e in expired:
            if not e.future.done():
                self._evict_entry(e, "expired_partial" if e in partial else "mid-decode")

        with self._wake:
            # FCFS admission from the queue head.  Nothing is allocated
            # until the prefill loop below, so the pull accounts for its
            # own picks: a burst larger than the free capacity stays queued
            free_slots = eng.free_slots()
            free_blocks = eng.cache.allocator.free_count()
            self._entries = [e for e in self._entries if not e.future.done()]
            while self._entries:
                head = self._entries[0]
                row_idx = head.next_row
                prompt = head.prompts[row_idx]
                need = blocks_for(eng.row_capacity_tokens(len(prompt), head.max_new),
                                  eng.block)
                if free_slots < 1 or need > free_blocks:
                    break  # head-of-line blocked until rows finish
                free_slots -= 1
                free_blocks -= need
                admitted.append((head, row_idx, prompt))
                head.next_row += 1
                if head.next_row >= len(head.prompts):
                    self._entries.pop(0)

        # prefill-on-admit (outside the lock: device work)
        for entry, row_idx, prompt in admitted:
            if entry.future.done():
                continue  # an earlier row of this entry already failed
            try:
                eng.admit(prompt, entry.max_new, entry=entry, row_idx=row_idx)
                with self._lock:
                    self.stats["prefill_admits"] += 1
            except ArenaReset as exc:
                # the prefill failed: every live row died with the arena
                with self._lock:
                    self.stats["gen_errors"] += 1
                self._fail_rows(exc.dead_rows, exc)
                if not entry.future.done():
                    entry.future.set_exception(exc)
                logger.warning(f"{self.name}: {exc}")
            except (BlockPoolExhausted, RuntimeError, ValueError) as exc:
                # host-side failure before any device work: the arena is
                # intact, fail only this entry (and its admitted rows)
                with self._lock:
                    self.stats["gen_errors"] += 1
                for i, r in enumerate(eng.slots):
                    if r is not None and r.entry is entry:
                        eng.release(i)
                if not entry.future.done():
                    entry.future.set_exception(exc)
                logger.warning(f"{self.name}: admission failed: {type(exc).__name__}: {exc}")

        if not self._has_live_rows():
            return 0
        return self._step_batch()

    def _step_batch(self) -> int:
        """One decode step, then resolve the rows it finished."""
        try:
            finished = self.engine.step()
        except ArenaReset as exc:
            with self._lock:
                self.stats["gen_errors"] += 1
            self._fail_rows(exc.dead_rows, exc)
            logger.warning(f"{self.name}: {exc}")
            return 0
        with self._lock:
            self.stats["batches"] += 1
        return self._finish_rows(finished)

    def _finish_rows(self, finished: List[int]) -> int:
        eng = self.engine
        for slot in finished:
            row = eng.slots[slot]
            entry = row.entry
            eng.release(slot)
            if entry is None:
                continue
            entry.results[row.row_idx] = row.tokens
            entry.done_rows += 1
            if entry.done_rows == len(entry.prompts) and not entry.future.done():
                entry.future.set_result(list(entry.results))
                with self._lock:
                    self.stats["completed"] += 1
        return len(finished)

