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
    one int32 array, runs ``models/gpt/generation.decode_step`` in place
    over static buffers (the paged attention kernel on the card, its plain
    version on the CPU) and reads back the sampled tokens and the new
    activity in one copy.
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
    admit while slots and blocks allow, preempt for a blocked arrival of
    higher priority, step (the scans on quantum boundaries only).

Tenancy (``core/tenancy.py``): the admission pull is a deficit
round-robin across tenant queues (weights from ``tenant_config``; FCFS
within a tenant, one tenant is exactly FCFS).  An arrival that cannot
fit may preempt the lowest-priority active row of strictly lower
priority that has committed ``preempt_min_tokens`` since its last
admission; the ``preempt_storm`` fault forces one such preemption.  A
preempted row publishes its KV-valid prefix to the prefix index (when
the cache is on), frees its slot and blocks, and re-enters its entry at
the front of the queue as a continuation: prompt plus committed tokens,
with the budget that remains.  Its resume is a prefix hit with the cache
on (the suffix past the last published full block runs as a chunk) and a
whole re-prefill with it off; either way greedy tokens equal the
undisturbed run's.  A request's ``stream`` hook sees every step's
commits, with offsets rebased across a preemption so they stay
contiguous.

Two admission paths share the arena.  With no prefix hit and no
``prefill_chunk`` a prompt prefills whole on admission (the contiguous
forward, then a block repack).  With ``prefill_chunk`` set, or when the
shared-prefix cache (``prefix_cache_blocks``) matched part of the
prompt, the row sits decode-inactive while its unmatched suffix streams
into its blocks one chunk per step (``paged_chunk_prefill``: the paged
attention kernel at t = chunk width), oldest admission first, between
the decode steps of the other rows.  Finished rows publish their prompt
blocks to the radix index; a later prompt maps the cached full blocks
into its table as shared entries and copies a partially matched block
(copy-on-write).  With ``prefix_spill_bytes`` an evicted cached block
demotes to host RAM and a later match brings it back instead of
recomputing it.

Greedy outputs are token-identical to the coalescing path and to the
JAX engine, with or without speculation, chunking or prefix hits.

The dispatch path is the JAX engine's.  Under dispatch-ahead
(``PFX_DISPATCH_AHEAD=1``, the scheduler's default) a step stays in
flight: the next one is dispatched, chained on its device-resident row
state, before its tokens are read back, so the host's scheduling work runs
in the device's shadow (speculation and a pending chunk commit first).
Every change of row membership or host row state (admission, eviction,
preemption, a drain) flushes the step in flight first, and a commit folds
its outputs only into the rows it was dispatched with.  ``PFX_SCHED_QUANTUM``
runs the shed, eviction and admission scans on every k-th iteration only.
On the card each decode or verify step is one CUDA graph per (capacity,
table width) (``core/step_graphs.py``, the counterpart of the JAX engine's
compiled step families) over static device buffers, fed from pinned host
buffers and read back through one asynchronous copy whose event the commit
waits on; prefills, chunks, block copies and readmits stay eager and write
the same buffers in place.

Observability (the JAX scheduler's, ``:2014-2160``, ``:2462-2530``,
``:2680-2810``): a sampled per-request trace (``utils/tracing.py``:
admission, queue wait, prefill or prefix hit and chunks, one
``decode_chunk`` event per committed step, preemption, eviction, shed);
a per-iteration decision log (``decision_log``, ``PFX_DECISION_LOG_CAP``
rows, default 4096) whose replay (``utils/tracing.replay_decision_log``)
reproduces the admission, eviction, speculation, prefix, token-ledger and
tenant counters exactly, in commit order, with dispatch-ahead on or off;
the goodput ledgers (scheduler-thread wall seconds in six buckets that
close against the wall by construction, admitted tokens against their
dispositions exactly, per-tenant slot and KV-block seconds), all host
clocks and counts: nothing here waits on the device.  ``debug_state``
(``GET /debug/state``) reads a view the scheduler thread publishes after
each iteration from host mirrors of the row state only (rebuilt live
while the scheduler is parked); with tracing off (``PFX_TRACE_SAMPLE=0``)
and no debug reader yet, the scheduler builds neither rows nor views.
The ``gen_crash`` (an admission) and ``cb_step_hang`` (before a step)
fault sites fire where the JAX scheduler fires them.  Not ported, and
refused where asked for: KV handoff (export/adopt) and prefix migration
(the decision log's ``migrate_adopted`` column reads 0).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
    QUEUE_METRICS,
    DeadlineExceeded,
    QueueClosed,
    QueueFull,
    RequestFuture,
)
from paddlefleetx_tpu_torch.core.tenancy import (
    DEFAULT_TENANT,
    DeficitRoundRobin,
    TenantConfig,
    TenantLabelCap,
    normalize_tenant,
)
from paddlefleetx_tpu_torch.core.step_graphs import StepGraphs
from paddlefleetx_tpu_torch.models.gpt.generation import (
    PagedRows,
    bucket_len,
    decode_step,
    decode_step_spec,
    gather_kv_blocks,
    init_paged_pools,
    paged_chunk_prefill,
    paged_prefill,
    prefix_token_counts,
    scatter_kv_blocks,
)
from paddlefleetx_tpu_torch.ops.decode_attention import (
    kv_cache_dtype,
    paged_scratch_size,
    reserve_split_scratch,
)
from paddlefleetx_tpu_torch.ops.speculative import (
    NGRAM_WINDOW,
    SpecConfig,
    ngram_propose_host,
)
from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.resilience import maybe_fire
from paddlefleetx_tpu_torch.utils.telemetry import StatsView, env_int, get_registry
from paddlefleetx_tpu_torch.utils.tracing import (
    attach_request_trace,
    discard_request_trace,
    get_trace_buffer,
)


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
    max_new: int = 0
    # the request's sampled trace (utils/tracing.TraceContext) or None: the
    # engine stamps the prefill and every committed step onto it
    trace: Any = None
    # prefix reuse / chunked prefill: tokens matched against the prefix
    # index (their KV was mapped shared, never recomputed), prompt tokens
    # still to prefill, the next chunk's first slot, the row's chunk
    # width, and whether prefill finished (only then is the row
    # decode-active and its prefix publishable)
    prefix_hit: int = 0
    pending: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0
    chunk: int = 0
    prefill_done: bool = True

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
    # token streaming: ``stream(row_idx, start, tokens)``, called on the
    # scheduler thread as each step's commits land (start = index of
    # tokens[0] in the row's output so far).  A sink must be fast; one
    # that raises is logged and dropped, the tokens are committed anyway
    stream: Optional[Callable[[int, int, List[int]], Any]] = None
    # tenancy: the fair-share queue the entry waits in and its priority
    # class (higher may preempt lower)
    tenant: str = DEFAULT_TENANT
    priority: int = 0
    # preempt-resume state: the tokens a preempted row had committed
    # (row_idx -> tokens) and the rows waiting to re-enter the batch.  A
    # continuation's prompt is ``prompts[row_idx] + row_prefill[row_idx]``
    # with the budget cut by the committed count, so the resumed greedy
    # decode continues the undisturbed stream; results and stream offsets
    # are rebased onto the committed prefix
    row_prefill: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    requeue_rows: List[int] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.results = [None] * len(self.prompts)

    def emit_stream(self, row_idx: int, start: int, tokens: List[int]) -> None:
        """Push a row's new commits to the stream, ``start`` rebased past
        what the row streamed before a preemption: one monotone index
        across a preempt-resume."""
        base = len(self.row_prefill.get(row_idx, ()))
        self.stream(row_idx, base + start, tokens)

    def finished_tokens(self, row_idx: int, tokens: List[int]) -> List[int]:
        """The row's whole output: the preempt-committed prefix, then the
        tokens decoded since the last resume."""
        pre = self.row_prefill.get(row_idx)
        return (pre + tokens) if pre else tokens


class PagedDecodeEngine:
    """Device-side continuous-batching engine over a ``GenerationServer``'s
    model, device and generation config.  Host code drives it one decode
    step at a time (``admit`` / ``step`` / ``release``).

    A failure inside a prefill, a chunk, a block copy or a step may leave
    the arena half written: :meth:`reset` rebuilds it and the caller
    fails the rows that were live (:class:`ArenaReset`), as the JAX
    engine does after a failed donating dispatch.

    ``graphs``: None (the default) captures each decode / verify step
    shape as a CUDA graph on a CUDA device and steps eagerly on the CPU;
    False steps eagerly on the card too (in-process comparisons only).
    ``dispatch_ahead`` (an attribute, set by :class:`ContinuousScheduler`)
    leaves each step in flight (see :meth:`step`)."""

    def __init__(self, server, *, max_batch: int = 8, block: int = 0,
                 num_blocks: int = 0, spec="auto", kv_dtype: str = "",
                 prefix_cache_blocks: int = 0, prefill_chunk: int = 0,
                 prefix_spill_bytes: int = 0, graphs: Optional[bool] = None) -> None:
        # speculation: "auto" inherits the server's parsed
        # Generation.speculative (one parse site, so both schedulers agree
        # on one config); a SpecConfig overrides, None turns it off
        if spec == "auto":
            spec = server.spec
        if spec is not None and not isinstance(spec, SpecConfig):
            raise ValueError(f"spec must be a SpecConfig or None, got {spec!r}")
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
        # prefix_cache_blocks > 0: finished rows publish their prompt
        # blocks into a radix index later admissions map as shared
        # entries; prefill_chunk > 0 (a block multiple) streams prompts in
        # chunks, one per step; the spill tier shadows the index
        if prefix_cache_blocks < 0:
            raise ValueError(f"prefix_cache_blocks must be >= 0, got {prefix_cache_blocks}")
        if prefill_chunk and (prefill_chunk < self.block or prefill_chunk % self.block):
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be 0 or a positive multiple of the "
                f"KV block size {self.block}"
            )
        if prefix_spill_bytes and not prefix_cache_blocks:
            raise ValueError(
                "prefix_spill_bytes requires prefix_cache_blocks > 0 (the spill tier "
                "shadows the radix index)"
            )
        self.prefill_chunk = int(prefill_chunk)
        self.cache = PagedCacheManager(num_blocks, self.block, prefix_blocks=prefix_cache_blocks,
                                       spill_bytes=prefix_spill_bytes)
        if self.cache.spill.enabled:
            self.cache.prefix.spill_hook = self._spill_block
        self.pools = init_paged_pools(self.mcfg, num_blocks, self.block, self.device,
                                      kv_dtype=self.kv_dtype)
        B, vocab = self.capacity, int(self.mcfg.vocab_size)
        # the step's static device buffers: written in place by prefills,
        # chunks and steps alike, so a captured step reads whatever the
        # eager work before it left there
        self._logits = torch.zeros((B, vocab), dtype=torch.float32, device=self.device)
        self._counts = torch.zeros((B, vocab), dtype=torch.int32, device=self.device)
        self._reject = torch.full((B,), -1, dtype=torch.int32, device=self.device)
        self._init_step_buffers()
        # graphs: one CUDA graph per step shape on a CUDA device (None),
        # never on the CPU; False steps eagerly (in-process comparisons)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.graphs: Optional[StepGraphs] = None
        if graphs:
            self.graphs = StepGraphs(self.device, server.generator)
            # a capture never allocates: size the split-K scratch once for
            # the widest launch the engine makes (the decode step, the
            # verify chunk, and a one-row chunk as wide as the context), so
            # no launch of this engine ever moves it
            heads, hd = int(self.mcfg.num_attention_heads), int(self.mcfg.head_dim)
            need = [paged_scratch_size(b, heads, t, hd, self._max_width, self.block)
                    for b, t in ((B, 1), (B, self.draft_k + 1), (1, self.context))]
            reserve_split_scratch(self.device, max(n[0] for n in need), max(n[1] for n in need))
        # dispatch-ahead (ContinuousScheduler flips it from
        # PFX_DISPATCH_AHEAD; a direct caller of the engine steps synchronously):
        # the dispatched step whose tokens are not read back yet, and when
        # the last commit's results landed (the host-gap clock)
        self.dispatch_ahead = False
        self._inflight: Optional[Dict[str, Any]] = None
        self._t_results: Optional[float] = None
        self.positions = np.zeros((B,), np.int32)
        self.gen_steps = np.zeros((B,), np.int32)
        self.max_news = np.zeros((B,), np.int32)
        self.forced_steps = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.slots: List[Optional[_Row]] = [None] * B
        self._seq_counter = 0
        # spill readmit probes so far: the spill_corrupt fault's step
        self._spill_probes = 0
        # warmup admissions and steps are not traffic: no spec stats, no
        # prefix hits, publishes or spills
        self._warmup = False
        # distinct (capacity, table width) step shapes, (prompt bucket,
        # prefill blocks) prefill shapes, (chunk width, table width) chunk
        # shapes, the block copy and the readmit scatter run so far: the
        # JAX engine's compile families (the step shapes are the CUDA
        # graphs' keys).  "prefill_tokens" counts prompt tokens actually
        # computed (a prefix hit's shared span never enters it);
        # "prefill_chunks" counts chunk dispatches, "interleaved_chunks"
        # those a step ran beside the decode step of other rows;
        # "host_gap_s" / "gap_steps" the host time the device sat idle
        # between one commit's results and the next step's dispatch (a
        # chained dispatch has none; an admission or a chunk in between
        # stops the clock: device work, not a scheduling gap).  The
        # time-ledger accumulators are host wall seconds this thread spent
        # in each phase: "t_device_decode" in a step's dispatch (its upload
        # and graph replay), "t_device_prefill" in every other arena write
        # (prefill, chunk, block copy, readmit), "t_readback" waiting on a
        # commit's copy event, "t_stream_flush" in the stream sinks; the
        # scheduler diffs them per iteration.  "ledger_admitted" counts the
        # tokens committed into scheduler-owned rows (the token ledger's
        # admission side); "migrate_adopted" stays 0 (no prefix migration)
        self._shapes: set = set()
        self.stats: Dict[str, Any] = {
            "traces": 0, "steps": 0, "prefills": 0, "prefill_tokens": 0,
            "prefill_chunks": 0, "interleaved_chunks": 0, "mid_decode_admits": 0,
            "spec_proposed": 0, "spec_accepted": 0, "spec_accept_rate": 0.0,
            "host_gap_s": 0.0, "gap_steps": 0, "migrate_adopted": 0,
            "t_device_decode": 0.0, "t_device_prefill": 0.0, "t_readback": 0.0,
            "t_stream_flush": 0.0, "ledger_admitted": 0,
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

    def _guarded(self, fn: Callable[[], Any], what: str, release_seq: Optional[int] = None,
                 ledger: str = "t_device_prefill"):
        """Run one arena-writing call under the arena contract: on any
        failure the arena may be half written, so release a row not yet
        in ``slots`` (``release_seq``; rows in ``slots`` are released by
        :meth:`reset`), rebuild the arena and raise :class:`ArenaReset`
        with the dead rows.  One spelling for the prefill, chunk, block
        copy, readmit and step writes; the call's host seconds go to the
        ``ledger`` accumulator (a decode step's to ``t_device_decode``)."""
        t0 = time.monotonic()
        try:
            return fn()
        except BaseException as exc:
            if release_seq is not None:
                self.cache.release(release_seq)
            dead = self.reset()
            raise ArenaReset(
                f"{what} failed ({type(exc).__name__}: {exc}); arena reset", dead
            ) from exc
        finally:
            self.stats[ledger] += time.monotonic() - t0

    # -- prefix cache ----------------------------------------------------
    @property
    def prefix_enabled(self) -> bool:
        return self.cache.prefix.enabled

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy arena block ``src`` into ``dst`` in every pool, the int8
        scale planes too (copy-on-write of a partially matched block)."""
        for pool in (self.pools.k, self.pools.v, self.pools.k_scale, self.pools.v_scale):
            if pool is not None:
                pool[:, dst] = pool[:, src]
        self._note_shape(("copy",))

    def _spill_block(self, path: tuple, block_id: int) -> None:
        """The index's eviction hook: demote one evicted FULL block's KV
        to the host spill store before its arena reference drops (the
        block is still referenced while the copy runs; ``clear()``, the
        ArenaReset path, never routes through here).  Warmup evictions
        never spill.  A failure degrades to a plain eviction behind the
        discard counter: spilling is an optimization, never a failure
        mode."""
        spill = self.cache.spill
        if self._warmup or not spill.enabled:
            return
        try:
            spill.put(path, gather_kv_blocks(self.pools, [int(block_id)]))
        except Exception as exc:  # noqa: BLE001 — degrade, never block the eviction
            logger.warning(f"prefix spill failed ({type(exc).__name__}: {exc}); block "
                           "evicted without a host copy")
            spill.stats["discards"] += 1

    def _readmit_spilled(self, prompt_ids: List[int], m: int) -> int:
        """Bring spilled host copies of this prompt's next full blocks
        back into the arena, extending the radix match from ``m`` tokens
        on: each allocates one block, scatters the host copy into it in
        place and inserts the node (the caller matches again, so the
        readmitted blocks go through the normal shared admission and hit
        accounting).  A checksum miss or pool pressure stops the walk (the
        rest recomputes); only :class:`ArenaReset` propagates."""
        spill = self.cache.spill
        limit = len(prompt_ids) - 1  # match's cap: >= 1 token recomputes
        readmitted = 0
        while m + self.block <= limit:
            key = tuple(prompt_ids[:m + self.block])
            self._spill_probes += 1
            # the spill_corrupt drill: the Kth probe finds its host copy
            # torn, and the checksum below discards it (the request
            # recomputes and succeeds)
            if maybe_fire("spill_corrupt", self._spill_probes):
                spill.tear(key)
            arrays = spill.get(key)  # checksum-verified; None = miss
            if arrays is None:
                break
            try:
                fresh = self.cache.allocator.alloc(1)
            except BlockPoolExhausted:
                break  # recompute; the entry waits for calmer pressure
            try:
                self._guarded(lambda: scatter_kv_blocks(self.pools, fresh, arrays),
                              "spill readmit")
            except ArenaReset:
                # reset() released every row and cleared the index; this
                # orphan allocation is ours to return
                self.cache.allocator.free(fresh)
                raise
            self._note_shape(("adopt", 1))
            self.cache.prefix.insert_block(key, fresh[0])
            spill.pop(key)  # back on the device: counted as a readmit
            readmitted += 1
            m += self.block
        if readmitted:
            self.cache.prefix.evict_to_budget()
        return readmitted

    def _prefix_admit(self, prompt_ids: List[int], capacity_tokens: int
                      ) -> Tuple[int, List[int], List[int], Optional[Tuple[int, int]], int]:
        """Radix lookup (with the spill tier's readmits), the block
        reservation, the hit/miss accounting once the reservation landed,
        and the copy-on-write block copy of a mid-block divergence.
        Returns ``(seq_id, table, shared, cow, matched)``.  Warmup
        admissions neither look up nor count."""
        shared: List[int] = []
        cow = None
        m = 0
        lookup = self.prefix_enabled and not self._warmup
        if lookup:
            shared, cow, m = self.cache.prefix.match(prompt_ids)
            # the on-device trie ran dry at a block boundary: promote the
            # spilled copies of the next blocks, then match again
            if (self.cache.spill.enabled and cow is None and len(self.cache.spill)
                    and self._readmit_spilled(prompt_ids, m)):
                shared, cow, m = self.cache.prefix.match(prompt_ids)
        self._seq_counter += 1
        seq_id = self._seq_counter
        table = self.cache.admit(seq_id, capacity_tokens, shared=shared)
        if lookup:
            self.cache.prefix.record_lookup(m)
        if cow is not None:
            # the diverging cached block goes into the row's first PRIVATE
            # block; the suffix prefill overwrites it from the divergence
            # slot on, so the cached original is never touched
            src, dst = cow[0], table[len(shared)]
            self._guarded(lambda: self._copy_block(src, dst), "COW copy", release_seq=seq_id)
        return seq_id, table, shared, cow, m

    # -- admission -----------------------------------------------------
    @torch.inference_mode()
    def admit(self, prompt_ids: Sequence[int], max_new: int,
              entry: Optional[_CBEntry] = None, row_idx: int = 0) -> int:
        """Allocate blocks and a batch slot and prefill the prompt into the
        arena; returns the slot.  Raises :class:`BlockPoolExhausted` /
        RuntimeError("no free slot") when full (check :meth:`can_admit`
        first) and :class:`ArenaReset` when an arena write fails.

        With the prefix cache on, the cached span maps into the row's
        table as shared blocks and only the suffix runs through the
        model, in chunks; with ``prefill_chunk`` set every prompt does.
        Such a row returns mid-prefill (its first chunk ran): the rest
        streams in one chunk per :meth:`step`."""
        # an admission sits between a commit and the next dispatch as
        # device work, not as a scheduling gap: stop the host-gap clock
        self._t_results = None
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
        mid_decode = bool((self.active & (self.gen_steps > 0)).any())
        seq_id, table, shared, cow, m = self._prefix_admit(
            prompt_ids, self.row_capacity_tokens(plen, max_new))
        trace = entry.future.trace if entry is not None else None
        if m == 0 and self.prefill_chunk == 0:
            # no reuse, no chunking: the monolithic prefill writes the
            # bucket's PB blocks (pad junk included); the reservation
            # always covers at least the bucket width
            PB = blocks_for(P, self.block)
            prompt = torch.full((1, P), self.gen.pad_token_id, dtype=torch.int64)
            prompt[0, :plen] = torch.tensor(prompt_ids, dtype=torch.int64)
            t_prefill = time.monotonic()
            last, counts = self._guarded(
                lambda: paged_prefill(self.model, prompt.to(self.device), plen, self.pools,
                                      table[:PB]),
                "prefill", release_seq=seq_id)
            self._logits[slot] = last
            self._counts[slot] = counts
            self._reject[slot] = -1
            self._note_shape(("prefill", P, PB))
            self.stats["prefill_tokens"] += plen
            if trace is not None:
                trace.span("prefill", t0=t_prefill, t1=time.monotonic(), prompt_len=plen,
                           bucket=P, blocks=len(table), slot=slot)
            row = _Row(seq_id=seq_id, entry=entry, row_idx=row_idx, prompt_ids=prompt_ids,
                       table=table, max_new=max_new, trace=trace)
        else:
            # prefix hit or chunked: only the unmatched suffix [m, plen)
            # runs through the model, in chunks.  The row sits
            # decode-INACTIVE until its last chunk lands (a step ignores
            # it), so decode latency stays flat while the prompt streams in
            row = _Row(
                seq_id=seq_id, entry=entry, row_idx=row_idx, prompt_ids=prompt_ids,
                table=table, max_new=max_new, trace=trace, prefix_hit=m,
                pending=prompt_ids[m:], prefill_pos=m,
                chunk=self.prefill_chunk or bucket_len(plen - m, self.bucket),
                prefill_done=False,
            )
            if trace is not None and m:
                trace.event("prefix_hit", slot=slot, hit_tokens=m, shared_blocks=len(shared),
                            cow=cow is not None)
        self.positions[slot] = plen if row.prefill_done else m
        self.gen_steps[slot] = 0
        self.max_news[slot] = max_new
        # forced EOS fires where the coalescing path fires it: the bucketed
        # run end of core/serving.plan_decode, not the raw budget
        self.forced_steps[slot] = min(-(-max_new // 32) * 32, limit) - 1
        self.active[slot] = row.prefill_done
        self.slots[slot] = row
        self.stats["prefills"] += 1
        self.stats["mid_decode_admits"] += int(mid_decode)
        if not row.prefill_done:
            self._tick_prefill(slot)  # the first chunk runs now; the rest ride step()
        return slot

    def _padded_chunk_table(self, table: List[int]) -> np.ndarray:
        """A row's block table padded to the power-of-two width the chunk
        shapes key on, with its LAST block repeated (the JAX engine pads
        with the null block).  A chunk's pad queries sit past its real
        tokens, and the attention kernel visits keys up to the widest
        bound of a tile of queries: past the row's reservation those keys
        now come from the row's own block, masked, never from the null
        block, which the pads' own K/V writes go to (``n_valid``).  The
        real queries' keys are the same either way."""
        M = min(_pow2_at_least(len(table)), _pow2_at_least(self.max_row_blocks))
        tbl = np.full((M,), table[-1], np.int32)
        tbl[: len(table)] = table
        return tbl

    def _run_prefill_chunk(self, chunk: int, tbl: np.ndarray, pos: int,
                           pending: List[int]) -> Tuple[torch.Tensor, int]:
        """Run ONE prefill chunk of width ``chunk`` at slot ``pos`` over the
        padded table ``tbl``: the first ``take`` of ``pending`` are real,
        the rest pads (null-routed).  One host -> device copy: the table,
        the position, the real count and the tokens as one int32 array.
        Returns (the last real token's logits, take); counts nothing
        but the shape (the warmup's null-table chunks are not traffic)."""
        take = min(chunk, len(pending))
        M = len(tbl)
        nb = self.cache.allocator.num_blocks
        if tbl.min() < 0 or tbl.max() >= nb:  # the kernel trusts its tables
            raise RuntimeError(f"block table entry outside [0, {nb}): {tbl.tolist()}")
        flat = np.full((M + 2 + chunk,), self.gen.pad_token_id, np.int32)
        flat[:M] = tbl
        flat[M] = pos
        flat[M + 1] = take
        flat[M + 2:M + 2 + take] = pending[:take]
        dev = torch.from_numpy(flat).to(self.device)
        last = paged_chunk_prefill(
            self.model, dev[M + 2:].long()[None, :], self.pools, dev[:M][None, :],
            dev[M:M + 1], dev[M + 1:M + 2], max(take - 1, 0),
        )
        self._note_shape(("chunk", chunk, M))
        return last, take

    def _tick_prefill(self, slot: int) -> None:
        """Run ONE chunk of a mid-prefill row's prompt suffix.  The final
        chunk seeds the row's pending logits (its last real prompt
        token's), repetition counts and residual mask, and makes it
        decode-active."""
        self._t_results = None  # a chunk between commit and dispatch
        row = self.slots[slot]
        final = min(row.chunk, len(row.pending)) == len(row.pending)
        t0 = time.monotonic()
        # no release_seq: the row sits in slots, so reset() releases it
        last, take = self._guarded(
            lambda: self._run_prefill_chunk(row.chunk, self._padded_chunk_table(row.table),
                                            row.prefill_pos, row.pending),
            "chunk prefill")
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += take
        row.pending = row.pending[take:]
        row.prefill_pos += take
        self.positions[slot] = row.prefill_pos
        if row.trace is not None:
            row.trace.span("prefill_chunk", t0=t0, t1=time.monotonic(), slot=slot, tokens=take,
                           position=row.prefill_pos, final=final)
        if final:
            counts = prefix_token_counts(row.prompt_ids, int(self.mcfg.vocab_size))
            self._logits[slot] = last
            self._counts[slot] = torch.from_numpy(counts).to(self.device)
            self._reject[slot] = -1
            self.positions[slot] = row.prompt_len
            self.active[slot] = True
            row.prefill_done = True

    def table_width_bucket(self) -> int:
        widest = max((len(r.table) for r in self.slots if r is not None), default=1)
        return min(_pow2_at_least(widest), self._max_width)

    # -- the step's buffers ------------------------------------------------
    def _init_step_buffers(self) -> None:
        """The step's static buffers.  Inputs: one int32 device array of
        the five per-row state rows (positions, gen_steps, max_news,
        forced_steps, active), the drafts and the block tables at the
        widest table width (a narrower step views its prefix), and the
        rows' activity as bool; outputs: each row's committed window, its
        count and its activity after the step as one int32 array.  The
        host side: two pinned copies of each (two, so a buffer is not
        rewritten before the copy that reads it ran), each with an event
        recorded after its copy."""
        B, k = self.capacity, self.draft_k
        self._max_width = _pow2_at_least(self.max_row_blocks)
        self._tables_at = 5 * B + B * k
        n_in = self._tables_at + B * self._max_width
        cuda = self.device.type == "cuda"
        self._dev_in = torch.zeros((n_in,), dtype=torch.int32, device=self.device)
        self._state = self._dev_in[:5 * B].view(5, B)
        self._active_dev = torch.zeros((B,), dtype=torch.bool, device=self.device)
        self._out = torch.zeros((B, k + 3), dtype=torch.int32, device=self.device)
        self._host_in = [torch.zeros((n_in,), dtype=torch.int32, pin_memory=cuda)
                         for _ in range(2)]
        self._host_out = [torch.zeros((B, k + 3), dtype=torch.int32, pin_memory=cuda)
                          for _ in range(2)]
        self._in_events = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._out_events = [torch.cuda.Event() if cuda else None for _ in range(2)]
        self._in_turn = self._out_turn = 0

    def _upload(self, M: int, chained: bool) -> None:
        """Copy the step's inputs to the device: the block tables at width
        ``M`` and, unless the step chains on the in-flight step's
        device-resident row state, the host's row state and drafts."""
        B, k = self.capacity, self.draft_k
        i = self._in_turn = 1 - self._in_turn
        if self._in_events[i] is not None:
            self._in_events[i].synchronize()
        host = self._host_in[i]
        flat = host.numpy()
        lo, hi = self._tables_at, self._tables_at + B * M
        tables = flat[lo:hi].reshape(B, M)
        tables.fill(NULL_BLOCK)
        for r_i, r in enumerate(self.slots):
            if r is not None:
                tables[r_i, : len(r.table)] = r.table
        nb = self.cache.allocator.num_blocks
        if tables.min() < 0 or tables.max() >= nb:  # the kernel trusts its tables
            raise RuntimeError(f"block table entry outside [0, {nb}): {tables.tolist()}")
        if not chained:
            flat[:5 * B] = np.concatenate([
                self.positions, self.gen_steps, self.max_news, self.forced_steps,
                self.active.astype(np.int32),
            ])
            if k:
                flat[5 * B:lo] = self._host_drafts().reshape(-1)
            lo = 0
        self._dev_in[lo:hi].copy_(host[lo:hi], non_blocking=True)
        if not chained:
            self._active_dev.copy_(self._state[4])
        if self._in_events[i] is not None:
            self._in_events[i].record()

    def _run_step(self, M: int) -> None:
        """ONE decode (or verify) step over the static buffers: the paged
        forward reads its inputs from them and writes the next row state,
        the pending logits, the counts and the residual mask back in place,
        and the committed window, its count and the activity into ``_out``.
        Eager on the CPU and for ``graphs=False``; captured and replayed
        otherwise."""
        B, k = self.capacity, self.draft_k
        st = self._state
        tables = self._dev_in[self._tables_at:self._tables_at + B * M].view(B, M)
        rows = PagedRows(
            logits=self._logits, counts=self._counts, positions=st[0], gen_steps=st[1],
            max_news=st[2], active=self._active_dev, forced_steps=st[3],
            reject=self._reject if k else None,
        )
        if k:
            drafts = self._dev_in[5 * B:self._tables_at].view(B, k)
            window, ncommit, _ = decode_step_spec(
                self.model, self.pools, tables, rows, drafts, self.gen,
                generator=self.server.generator, inplace=True,
            )
        else:
            ncommit = self._active_dev.to(torch.int32)
            nxt, _ = decode_step(self.model, self.pools, tables, rows, self.gen,
                                 generator=self.server.generator, inplace=True)
            window = nxt[:, None]
        self._out.copy_(torch.cat([window.to(torch.int32), ncommit.to(torch.int32)[:, None],
                                   self._active_dev.to(torch.int32)[:, None]], dim=1))

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
        """Run at most ONE pending prefill chunk (the oldest admission's:
        a long prompt streams in across steps while the batch keeps
        decoding), then ONE decode step for every active row (speculative:
        one draft-verify iteration, committing 1 to draft_k + 1 tokens a
        row); returns the slots that finished (their tokens are complete:
        release them with :meth:`release`).  A row finishes on EOS or on
        its budget inside the committed window, never past it.  Raises
        :class:`ArenaReset` when an arena write fails.

        Synchronous (the default): dispatch and commit in one call.  With
        ``dispatch_ahead`` the step stays IN FLIGHT: the next call
        dispatches the next step before it reads this one's tokens back,
        chained on its device-resident positions, gen_steps and activity
        when nothing is pending and speculation is off (speculation drafts
        from committed tokens, a pending chunk needs the host tick: both
        commit first).  The finished slots returned are then the committed
        (previous) step's.  A caller that changes row membership or host
        row state (admit, release, preempt, evict) calls :meth:`flush`
        first."""
        pending = [i for i, r in enumerate(self.slots) if r is not None and not r.prefill_done]
        if (self.dispatch_ahead and self._inflight is not None and self.spec is None
                and not pending and self.active.any()):
            prev, self._inflight = self._inflight, None
            nxt = self._dispatch(chained=True)
            # stashed before the commit: a failed commit resets the arena,
            # and reset() drops the chained step too
            self._inflight = nxt
            finished = self._commit(prev)
            # the chained step's rows are the committed step's survivors:
            # a later commit never re-finishes a slot released now
            nxt["was_active"] = self.active.copy()
            return finished
        finished = self.flush()
        if pending:
            self.stats["interleaved_chunks"] += bool(self.active.any())
            self._tick_prefill(min(pending, key=lambda i: self.slots[i].seq_id))
        if not self.active.any():
            return finished
        fl = self._dispatch(chained=False)
        fl["was_active"] = self.active.copy()
        self._inflight = fl
        if self.dispatch_ahead:
            return finished
        return finished + self.flush()

    @property
    def has_inflight(self) -> bool:
        """True while a dispatched step's tokens are not read back yet
        (dispatch-ahead only)."""
        return self._inflight is not None

    def _dispatch(self, chained: bool) -> Dict[str, Any]:
        """Upload the inputs, run one step (a graph replay on the card)
        and queue the copy of its outputs to pinned host memory; returns
        the in-flight record :meth:`_commit` reads (the caller fills in
        ``was_active``).  A failure resets the arena."""
        B, k = self.capacity, self.draft_k
        M = self.table_width_bucket()
        key = ("verify", B, M, k) if k else ("step", B, M)
        if self._t_results is not None and not chained:
            self.stats["host_gap_s"] += max(0.0, time.monotonic() - self._t_results)
            self.stats["gap_steps"] += 1

        def run():
            self._upload(M, chained)
            if self.graphs is not None:
                self.graphs.run(key, lambda: self._run_step(M))
            else:
                self._run_step(M)
            j = self._out_turn = 1 - self._out_turn
            self._host_out[j].copy_(self._out, non_blocking=True)
            if self._out_events[j] is not None:
                self._out_events[j].record()
            return j

        j = self._guarded(run, "decode step", ledger="t_device_decode")
        self._note_shape(key)
        return {"out": j, "rows": list(self.slots), "k": k, "was_active": None}

    def flush(self) -> List[int]:
        """Commit the in-flight step, if any; returns the slots it
        finished.  The flush the dispatch-ahead contract asks for before
        any change of row membership or host row state: the commit's merge
        protects only rows that join or leave after the dispatch."""
        if self._inflight is None:
            return []
        prev, self._inflight = self._inflight, None
        return self._commit(prev)

    def _commit(self, fl: Dict[str, Any]) -> List[int]:
        """Wait for one dispatched step's outputs and fold them into the
        host state: the decode path's only wait on the device.  The step's
        device errors surface here, so any failure resets the arena, and
        the :class:`ArenaReset` carries every live row, those admitted
        while the step was in flight included (the ``cb_commit_crash``
        fault fires here)."""
        j = fl["out"]
        t_rb = time.monotonic()
        try:
            at = int(self.stats["steps"]) + 1
            if maybe_fire("cb_commit_crash", at):
                raise RuntimeError(f"PFX_FAULT: injected cb_commit_crash at step {at}")
            if self._out_events[j] is not None:
                self._out_events[j].synchronize()
            out = self._host_out[j].numpy().copy()
        except BaseException as exc:
            # the failed wait is readback; the reset after it host work
            self.stats["t_readback"] += time.monotonic() - t_rb
            dead = self.reset()
            raise ArenaReset(
                f"decode step failed ({type(exc).__name__}: {exc}); arena reset", dead
            ) from exc
        self.stats["t_readback"] += time.monotonic() - t_rb
        self._t_results = time.monotonic()
        self.stats["steps"] += 1
        was_active = fl["was_active"]
        ncommit = out[:, -2]
        new_active = out[:, -1].astype(bool)
        # merge, never overwrite: rows that joined or left after the
        # dispatch were not part of it, and their host state wins
        self.positions[was_active] += ncommit[was_active]
        self.gen_steps[was_active] += ncommit[was_active]
        self.active[was_active] = new_active[was_active]
        finished: List[int] = []
        t_chunk = time.monotonic()
        for i, r in enumerate(fl["rows"]):
            if r is None or not was_active[i]:
                continue
            committed = int(ncommit[i])
            start = len(r.tokens)  # a speculative step may commit several
            for tok in out[i, :committed].tolist():
                if tok != self.gen.eos_token_id:
                    r.tokens.append(tok)
            if r.entry is not None:
                # token ledger: commits into scheduler-owned rows are
                # admitted tokens (EOS never appends, so never enters)
                self.stats["ledger_admitted"] += len(r.tokens) - start
            if (len(r.tokens) > start and not self._warmup and r.entry is not None
                    and r.entry.stream is not None):
                t_sf = time.monotonic()
                try:
                    r.entry.emit_stream(r.row_idx, start, r.tokens[start:])
                except Exception as exc:  # noqa: BLE001 — a sink never kills the batch
                    logger.warning(f"stream sink failed for seq {r.seq_id}: "
                                   f"{type(exc).__name__}: {exc}")
                finally:
                    self.stats["t_stream_flush"] += time.monotonic() - t_sf
            if r.trace is not None:
                # one event a committed step: counts, never token values
                r.trace.event("decode_chunk", t=t_chunk, slot=i, committed=committed,
                              accepted=committed - 1 if self.spec else 0,
                              position=int(self.positions[i]))
            if not new_active[i]:
                finished.append(i)
        n_act = int(was_active.sum())
        if fl["k"] and n_act and not self._warmup:
            self.stats["spec_proposed"] += fl["k"] * n_act
            self.stats["spec_accepted"] += int(ncommit[was_active].sum()) - n_act
            self.stats["spec_accept_rate"] = (
                self.stats["spec_accepted"] / self.stats["spec_proposed"])
        return finished

    def release(self, slot: int) -> None:
        """Return a finished/evicted row's blocks to the pool and clear its
        batch slot (loud on an empty slot).  With the prefix cache on, a
        row whose prefill finished publishes its prompt blocks first (the
        index takes its own references, so they outlive the row under the
        LRU budget); a row still mid-prefill never publishes: its blocks
        are only partly written."""
        row = self.slots[slot]
        if row is None:
            raise ValueError(f"slot {slot} is already empty")
        if self.prefix_enabled and not self._warmup and row.prefill_done:
            self.cache.prefix.publish(row.prompt_ids, row.table)
        self.cache.release(row.seq_id)
        self.slots[slot] = None
        self.active[slot] = False
        self.positions[slot] = 0
        self.gen_steps[slot] = 0
        self.max_news[slot] = 0
        self.forced_steps[slot] = 0

    def preempt_row(self, slot: int) -> List[int]:
        """Evict a decode-active row for a priority preemption and return
        the tokens it committed (the scheduler requeues the row as a
        continuation: paused, not killed).  With the prefix cache on, the
        row's KV-valid prefix (the prompt and the ``positions -
        prompt_len`` committed tokens whose KV is written) is published
        first, so the continuation's prefill is a prefix hit."""
        row = self.slots[slot]
        if row is None:
            raise ValueError(f"slot {slot} is empty")
        if not row.prefill_done:
            raise ValueError(
                f"slot {slot} is mid-chunked-prefill; only decode-active "
                "rows are preemptible"
            )
        committed = list(row.tokens)
        if self.prefix_enabled and not self._warmup:
            kv_valid = max(0, int(self.positions[slot]) - row.prompt_len)
            self.cache.prefix.publish(row.prompt_ids + committed[:kv_valid], row.table)
        self.cache.release(row.seq_id)
        self.slots[slot] = None
        self.active[slot] = False
        self.positions[slot] = 0
        self.gen_steps[slot] = 0
        self.max_news[slot] = 0
        self.forced_steps[slot] = 0
        return committed

    def prefill_export(self, *args, **kwargs):
        raise NotImplementedError(
            "the KV handoff (prefill_export / adopt) and prefix migration "
            "(export_hot_prefixes / adopt_prefixes) are not ported to the PyTorch port yet"
        )

    adopt = export_hot_prefixes = adopt_prefixes = prefill_export

    def reset(self) -> List[_Row]:
        """Rebuild the arena after a failed arena write; returns the rows
        that were live (the caller fails their requests).  The rebuilt
        pools hold none of the old blocks' KV, so the prefix index and the
        spill store empty in the same breath: a dead arena's KV must never
        come back as a hit or a readmit (``clear()`` frees directly, so
        nothing spills here).  A step in flight chains on the failed one:
        it is dropped, never committed.  The pools and the step's buffers
        are zeroed in place: the captured graphs hold their addresses (the
        sm90 kernels' too), so they stay valid for the rebuilt arena."""
        dead = [r for r in self.slots if r is not None]
        self._inflight = None
        self._t_results = None
        for r in dead:
            self.cache.release(r.seq_id)
        self.cache.prefix.clear()
        self.cache.spill.clear()
        self.slots = [None] * self.capacity
        self.active[:] = False
        self.positions[:] = 0
        self.gen_steps[:] = 0
        self.max_news[:] = 0
        self.forced_steps[:] = 0
        for buf in (self.pools.k, self.pools.v, self.pools.k_scale, self.pools.v_scale,
                    self._logits, self._counts, self._dev_in, self._active_dev, self._out):
            if buf is not None:
                buf.zero_()
        self._reject.fill_(-1)
        return dead

    def _warm_copy_family(self) -> None:
        """The copy-on-write block copy once, as a null-block self-copy
        (a no-op on the arena)."""
        self._guarded(lambda: self._copy_block(NULL_BLOCK, NULL_BLOCK), "COW copy warmup")

    def _warm_chunk_family(self, n: int) -> None:
        """The chunks a prefix hit at prompt bucket ``n`` runs its suffix
        through (needed only when ``prefill_chunk`` is off: a chunked
        engine's warmup admission already runs chunks): the one-quantum
        suffix and the full-bucket one, at the table width a bucket-``n``
        row takes, over a null table with ``n_valid`` 0, so nothing
        touches a real block."""
        blocks = blocks_for(self.row_capacity_tokens(int(n), self.gen.max_dec_len), self.block)
        tbl = np.full((min(_pow2_at_least(blocks), _pow2_at_least(self.max_row_blocks)),),
                      NULL_BLOCK, np.int32)
        for t in sorted({self.bucket, bucket_len(int(n), self.bucket)}):
            self._guarded(lambda: self._run_prefill_chunk(t, tbl, 0, []), "chunk warmup")

    @torch.inference_mode()
    def warmup(self, prompt_lens: Sequence[int]) -> Dict[str, float]:
        """Run one admission and one step per prompt bucket before traffic
        (builds the kernels on the card; with speculation on, the step is
        the t = draft_k + 1 verify; with chunking, every chunk of the
        warmup prompt runs), and with the prefix cache on the block copy
        and the chunks a hit's suffix takes; fails loudly naming the
        bucket."""
        per: Dict[str, float] = {}
        self._warmup = True
        # warmup steps, inspects and releases one slot at a time: it runs
        # synchronous whatever the dispatch-ahead setting
        ahead, self.dispatch_ahead = self.dispatch_ahead, False
        try:
            if self.prefix_enabled:
                self._warm_copy_family()
            for n in prompt_lens:
                t0 = time.time()
                try:
                    if self.prefix_enabled and self.prefill_chunk == 0:
                        self._warm_chunk_family(int(n))
                    slot = self.admit([1] * int(n), max_new=self.gen.max_dec_len)
                    while self.slots[slot] is not None and not self.slots[slot].prefill_done:
                        self.step()
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
            self.dispatch_ahead = ahead
        return per


class ContinuousScheduler:
    """Iteration-level scheduler with the ``RequestQueue`` admission
    surface, weighted-fair across tenants, with priority preemption.

    ``submit`` -> bounded waiting queue (QueueFull / QueueClosed exactly
    like RequestQueue); the scheduler thread loops one decode step per
    iteration: shed expired waiting entries, evict expired ACTIVE rows
    mid-decode (blocks freed at once), admit the weighted-fair pick's
    oldest unit while slots and blocks (free, or cached and reclaimable)
    allow (prefill-on-admit, or its first chunk), preempt for a blocked
    arrival of higher priority (or once at a ``preempt_storm`` fire),
    then step the batch (at most one pending chunk, then the decode
    step).  ``dispatch_ahead`` / ``quantum`` (None: ``PFX_DISPATCH_AHEAD``,
    default 1, and ``PFX_SCHED_QUANTUM``, default 1) keep a step in flight
    across iterations and run the scans on every ``quantum``-th iteration;
    the step in flight is committed before an eviction, an admission, a
    preemption, when the batch empties and at the drain."""

    kind = "continuous"

    def __init__(self, engine: PagedDecodeEngine, *, max_depth: int = 64,
                 name: str = "serve-cb", dispatch_ahead: Optional[bool] = None,
                 quantum: Optional[int] = None, tenant_config: Optional[TenantConfig] = None,
                 preempt_min_tokens: int = 8) -> None:
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if preempt_min_tokens < 1:
            raise ValueError(f"preempt_min_tokens must be >= 1, got {preempt_min_tokens}")
        self.engine = engine
        self.max_depth = int(max_depth)
        self.name = name
        # the admission pull: a deficit round-robin across tenant queues
        # (FCFS within a tenant); a victim must have committed
        # preempt_min_tokens since its last admission (the minimum-progress
        # floor that keeps preemption from thrashing)
        self.tenant_config = tenant_config or TenantConfig()
        self._fair = DeficitRoundRobin(self.tenant_config.weight)
        self._tenant_labels = TenantLabelCap(seed=self.tenant_config.known_tenants())
        self.preempt_min_tokens = int(preempt_min_tokens)
        # dispatch-ahead decode and the k-step scheduling quantum, as the
        # JAX scheduler reads them: PFX_DISPATCH_AHEAD (default 1; 0 is the
        # loud synchronous fallback.  The JAX parse refuses 0 as below its
        # minimum of 1, so there only the argument reaches the fallback)
        # and PFX_SCHED_QUANTUM=k, the shed, eviction and admission scans
        # on every k-th iteration only.  The scheduler owns the knob: a
        # direct caller of the engine keeps synchronous steps
        if dispatch_ahead is None:
            dispatch_ahead = env_int("PFX_DISPATCH_AHEAD", 1, minimum=0) != 0
        self.dispatch_ahead = bool(dispatch_ahead)
        engine.dispatch_ahead = self.dispatch_ahead
        if not self.dispatch_ahead:
            logger.warning(f"{name}: PFX_DISPATCH_AHEAD=0 — synchronous decode stepping; host "
                           "scheduling no longer overlaps device compute")
        self.quantum = env_int("PFX_SCHED_QUANTUM", 1) if quantum is None else int(quantum)
        if self.quantum < 1:
            raise ValueError(f"PFX_SCHED_QUANTUM must be >= 1, got {self.quantum}")
        # rows admitted and preempted per tenant label (scheduler thread
        # only; the same sites bump the labelled registry counters)
        self._tenant_admitted: Dict[str, int] = {}
        self._tenant_preempted: Dict[str, int] = {}
        self._iter_counter = 0
        self._entries: List[_CBEntry] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._busy_since: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        # the PFX_FAULT indices: row admissions (gen_crash) and steps
        # (cb_step_hang), as the JAX scheduler counts them
        self._req_counter = 0
        self._step_counter = 0
        # the decision log: one row per iteration while tracing is on
        # (PFX_TRACE_SAMPLE > 0), accounted in commit order, bounded
        self.decision_log: deque = deque(maxlen=env_int("PFX_DECISION_LOG_CAP", 4096))
        # the time ledger: every scheduler-thread wall second in exactly
        # one bucket.  idle is stamped in _run's wait, the device,
        # readback and stream buckets are diffed off the engine's
        # accumulators in _iterate, and host_sched is the residual, so the
        # sum closes against _sched_wall_s by construction
        self._time_ledger: Dict[str, float] = {
            "device_decode": 0.0, "device_prefill": 0.0, "host_sched": 0.0,
            "readback": 0.0, "stream_flush": 0.0, "idle": 0.0,
        }
        self._sched_wall_s = 0.0
        # the token ledger over admitted (committed) tokens: admitted ==
        # delivered + evicted_lost + preempt_refunded + shed_after_admit +
        # the tokens on live rows, exactly, at every iteration boundary
        self._tok_ledger: Dict[str, int] = {
            "admitted": 0, "delivered": 0, "evicted_lost": 0,
            "preempt_refunded": 0, "shed_after_admit": 0,
        }
        self._ledger_admit_base = 0
        # per-tenant-label slot seconds and KV-block seconds, accrued over
        # each iteration for every live row
        self._tenant_occ: Dict[str, Dict[str, float]] = {}
        # the engine view debug_state() reads, published by the scheduler
        # thread after each iteration; with tracing off it is rebuilt only
        # once a debug reader has asked (the first call latches interest)
        self._debug_requested = False
        # the RequestQueue keys that apply (no coalescing: rows join the
        # running batch instead) plus the continuous-only counters, under
        # the JAX scheduler's registry names; "preemptions" stays local
        # (pfx_tenant_preemptions_total is its labelled form)
        self.stats = StatsView({
            **{k: m for k, m in QUEUE_METRICS.items() if not k.startswith("coalesced")},
            "evictions": "pfx_request_evictions_total",
            "prefill_admits": "pfx_prefill_admits_total",
            "preemptions": None,
        })
        self._debug_engine: Dict[str, Any] = self._engine_debug_view()
        get_registry().register_collector(self)

    def collect(self):
        """Registry collector: queue depth and busy seconds, the batch's
        occupancy and the arena's blocks, the engine's speculation, prefix
        and spill counters, and the waiting entries per tenant label."""
        eng = self.engine
        cstats = eng.cache.stats()
        pfx, spill = eng.cache.prefix.stats, eng.cache.spill.stats
        prop = float(eng.stats["spec_proposed"])
        out = [
            ("pfx_queue_depth", {}, float(self.depth())),
            ("pfx_queue_busy_seconds", {}, self.busy_seconds()),
            ("pfx_batch_occupancy", {}, eng.active_rows() / max(1, eng.capacity)),
            ("pfx_kv_blocks_used", {}, float(cstats["kv_blocks_used"])),
            ("pfx_kv_blocks_free", {}, float(cstats["kv_blocks_free"])),
            ("pfx_kv_blocks_available", {}, float(eng.cache.available_blocks())),
            ("pfx_prefix_cached_blocks", {}, float(cstats["prefix_cached_blocks"])),
            ("pfx_prefix_spill_bytes", {}, float(cstats["prefix_spill_bytes"])),
            ("pfx_prefix_spill_entries", {}, float(cstats["prefix_spill_entries"])),
            ("pfx_prefix_hits_total", {}, float(pfx["hits"])),
            ("pfx_prefix_misses_total", {}, float(pfx["misses"])),
            ("pfx_prefix_hit_tokens_total", {}, float(pfx["hit_tokens"])),
            ("pfx_prefix_evictions_total", {}, float(pfx["evictions"])),
            ("pfx_prefill_chunks_total", {}, float(eng.stats["prefill_chunks"])),
            ("pfx_prefix_spills_total", {}, float(spill["spills"])),
            ("pfx_prefix_readmits_total", {}, float(spill["readmits"])),
            ("pfx_prefix_spill_discards_total", {}, float(spill["discards"])),
            ("pfx_spec_proposed_total", {}, prop),
            ("pfx_spec_accepted_total", {}, float(eng.stats["spec_accepted"])),
        ]
        if eng.spec is not None:
            out.append(("pfx_spec_accept_rate", {},
                        float(eng.stats["spec_accepted"]) / prop if prop else 0.0))
        # the goodput ledgers: the time buckets close against the wall
        # (within 1%), the token dispositions against admitted exactly once
        # in flight reads 0; the host gap overlaps the buckets
        for b, v in sorted(self._time_ledger.items()):
            out.append(("pfx_sched_time_seconds_total", {"bucket": b}, round(v, 6)))
        out.append(("pfx_sched_wall_seconds_total", {}, round(self._sched_wall_s, 6)))
        out.append(("pfx_sched_host_gap_seconds_total", {},
                    round(float(eng.stats["host_gap_s"]), 6)))
        for d, v in sorted(self._tok_ledger.items()):
            out.append(("pfx_token_ledger_total", {"disposition": d}, float(v)))
        out.append(("pfx_token_ledger_in_flight", {}, float(self._ledger_in_flight())))
        for lab, occ in sorted(dict(self._tenant_occ).items()):
            out.append(("pfx_tenant_slot_seconds_total", {"tenant": lab},
                        round(occ["slot_s"], 6)))
            out.append(("pfx_tenant_kv_block_seconds_total", {"tenant": lab},
                        round(occ["kv_block_s"], 6)))
        per_tenant: Dict[str, int] = {}
        with self._lock:
            for e in self._entries:
                lab = self._tenant_labels.label(e.tenant)
                per_tenant[lab] = per_tenant.get(lab, 0) + 1
        for lab, n in sorted(per_tenant.items()):
            out.append(("pfx_tenant_queue_depth", {"tenant": lab}, float(n)))
        return out

    # -- admission (RequestQueue-compatible surface) --------------------
    def submit(self, prompts: Sequence[Any], max_new_tokens: int, *,
               coalesce_key=None, deadline_s: Optional[float] = None,
               stream: Optional[Callable[[int, int, List[int]], Any]] = None,
               tenant: Optional[str] = None, priority: int = 0) -> RequestFuture:
        """Admit a request and return its future (``coalesce_key`` is
        accepted for the RequestQueue signature and ignored).  ``stream``
        (optional) is called on the scheduler thread as tokens commit
        (see :class:`_CBEntry`); ``tenant`` / ``priority`` place the entry
        in its fair-share queue and priority class.  Raises ValueError for
        a prompt that can never fit the arena, ``QueueClosed`` when
        draining and ``QueueFull`` at capacity."""
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
            stream=stream,
            tenant=normalize_tenant(tenant),
            priority=int(priority),
        )
        entry.future.times["enqueued"] = now
        # attached before the entry is visible to the scheduler thread, or
        # a fast pickup would miss the prefill span
        attach_request_trace(entry.future, t0=now, scheduler=self.name,
                             prompts=len(entry.prompts), max_new=entry.max_new)
        try:
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
        except (QueueClosed, QueueFull):
            discard_request_trace(entry.future)  # never admitted
            raise
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
        """The engine's stats (``prefill_chunks``, ``prefill_tokens``:
        prompt tokens computed, a prefix hit's span excluded), the arena's
        occupancy (``prefix_cached_blocks``, ``prefix_spill_bytes``,
        ``prefix_spill_entries`` among it), and the prefix index's and the
        spill store's counters: ``prefix`` {hits, misses, hit_tokens,
        evictions}, ``spill`` {spills, readmits, discards}; the dispatch
        path's ``dispatch_ahead``, ``quantum``, ``inflight``, the host gap
        (``host_gap_s`` over ``gap_steps``) and the CUDA graphs (``graphs``
        captured, ``graph_replays``, ``graph_capture_s``; 0 when off)."""
        eng = self.engine
        graphs = (eng.graphs.stats if eng.graphs is not None
                  else {"graphs": 0, "graph_replays": 0, "graph_capture_s": 0.0})
        return {**eng.stats, **eng.cache.stats(), "active_rows": eng.active_rows(),
                "prefix": dict(eng.cache.prefix.stats), "spill": dict(eng.cache.spill.stats),
                "dispatch_ahead": eng.dispatch_ahead, "quantum": self.quantum,
                "inflight": eng.has_inflight, **graphs}

    def try_remove(self, future: RequestFuture) -> bool:
        """Shed a WAITING entry (no row admitted yet).  An entry already in
        the running batch resolves via mid-decode eviction instead."""
        with self._wake:
            for e in self._entries:
                if e.future is future and e.next_row == 0:
                    self._entries.remove(e)
                    self.stats["shed_deadline"] += 1
                    if e.future.trace is not None:
                        e.future.trace.event("shed", reason="handler_timeout")
                    e.future.set_exception(DeadlineExceeded("deadline exceeded while queued"))
                    return True
        return False

    # -- goodput ledgers --------------------------------------------------
    def _fold_admitted(self) -> None:
        """Fold the engine's commit-site admitted-token count into the
        ledger: right after any step or flush that can commit and before
        its rows are resolved or failed, so no disposition outruns
        admission."""
        cur = int(self.engine.stats["ledger_admitted"])
        if cur != self._ledger_admit_base:
            self._tok_ledger["admitted"] += cur - self._ledger_admit_base
            self._ledger_admit_base = cur

    @staticmethod
    def _row_on_books(row: _Row) -> int:
        """A live row's tokens on the books: its commits since its last
        admission plus the resume prefix it re-admitted."""
        if row.entry is None:
            return 0
        return len(row.tokens) + len(row.entry.row_prefill.get(row.row_idx, ()))

    def _ledger_in_flight(self) -> int:
        """Admitted tokens without a disposition yet (on live rows)."""
        return sum(self._row_on_books(r) for r in self.engine.slots if r is not None)

    def time_ledger(self) -> Dict[str, Any]:
        """The time ledger: seconds per bucket and the wall they close
        against."""
        return {"buckets": dict(self._time_ledger), "wall_s": self._sched_wall_s}

    def token_ledger(self) -> Dict[str, int]:
        """The token ledger and the live in-flight count: ``admitted ==
        delivered + evicted_lost + preempt_refunded + shed_after_admit +
        in_flight`` at iteration boundaries."""
        out = dict(self._tok_ledger)
        out["in_flight"] = self._ledger_in_flight()
        return out

    # -- live introspection (GET /debug/state) --------------------------
    def _engine_debug_view(self) -> Dict[str, Any]:
        """The engine half of :meth:`debug_state`, built on the scheduler
        thread (or while it is parked) from host state only: the row
        mirrors, the arena's books, the shapes run so far.  Lengths and
        counts, never token ids; no device tensor is read."""
        eng = self.engine
        rows = []
        for i, r in enumerate(eng.slots):
            if r is None:
                continue
            rows.append({
                "slot": i, "seq_id": r.seq_id, "prompt_len": r.prompt_len,
                "max_new": r.max_new, "position": int(eng.positions[i]),
                "gen_step": int(eng.gen_steps[i]), "tokens_out": len(r.tokens),
                "blocks": len(r.table), "active": bool(eng.active[i]),
                "prefix_hit_tokens": r.prefix_hit, "prefill_pending": len(r.pending),
            })
        families: Dict[str, int] = {}
        for key in list(eng._shapes):
            families[key[0]] = families.get(key[0], 0) + 1
        view: Dict[str, Any] = {
            # the iteration this view reflects: staleness is visible
            "as_of_iter": self._iter_counter,
            "batch": {
                "capacity": eng.capacity,
                "active_rows": eng.active_rows(),
                "occupancy": round(eng.active_rows() / max(1, eng.capacity), 4),
                "width_bucket": eng.table_width_bucket(),
                "rows": rows,
            },
            "arena": eng.cache.stats(),
            "overlap": {
                "dispatch_ahead": bool(eng.dispatch_ahead),
                "quantum": self.quantum,
                "inflight": eng.has_inflight,
                "host_gap_s": round(float(eng.stats["host_gap_s"]), 6),
                "gap_steps": int(eng.stats["gap_steps"]),
            },
            # the JAX engine's compiled families are the port's step shapes
            # (the CUDA graphs' keys), prefill and chunk shapes
            "compiled": {
                "prefill_families": families.get("prefill", 0),
                "step_families": families.get("step", 0) + families.get("verify", 0),
                "chunk_families": families.get("chunk", 0),
                "traces": int(eng.stats["traces"]),
            },
            # the ledgers from the same build as the rows above, so the
            # token equation holds exactly within this view
            "goodput": {
                "time_s": {k: round(v, 6) for k, v in self._time_ledger.items()},
                "wall_s": round(self._sched_wall_s, 6),
                "tokens": dict(self._tok_ledger),
                "tokens_in_flight": self._ledger_in_flight(),
                "tenant_occupancy": {
                    lab: {"slot_s": round(occ["slot_s"], 6),
                          "kv_block_s": round(occ["kv_block_s"], 6)}
                    for lab, occ in sorted(self._tenant_occ.items())
                },
            },
        }
        if eng.prefix_enabled or eng.prefill_chunk:
            pfx, spill = eng.cache.prefix, eng.cache.spill
            view["prefix_cache"] = {
                "enabled": eng.prefix_enabled,
                "budget_blocks": pfx.budget,
                "cached_blocks": pfx.cached_blocks(),
                "hits": int(pfx.stats["hits"]),
                "misses": int(pfx.stats["misses"]),
                "hit_tokens": int(pfx.stats["hit_tokens"]),
                "evictions": int(pfx.stats["evictions"]),
                "prefill_chunk": eng.prefill_chunk,
                "prefill_chunks": int(eng.stats["prefill_chunks"]),
                "prefill_tokens": int(eng.stats["prefill_tokens"]),
                "spill_budget_bytes": spill.budget,
                "spill_bytes": spill.bytes_used(),
                "spill_entries": len(spill),
                "spills": int(spill.stats["spills"]),
                "readmits": int(spill.stats["readmits"]),
                "spill_discards": int(spill.stats["discards"]),
                "migrate_adopted": int(eng.stats["migrate_adopted"]),
            }
        if eng.spec is not None:
            prop, acc = int(eng.stats["spec_proposed"]), int(eng.stats["spec_accepted"])
            view["spec"] = {"draft_k": eng.spec.draft_k, "proposed": prop, "accepted": acc,
                            "accept_rate": round(acc / prop, 4) if prop else 0.0}
        return view

    def _publish_debug(self) -> None:
        # one reference assignment: a reader gets the old or the new view
        self._debug_engine = self._engine_debug_view()

    def debug_state(self) -> Dict[str, Any]:
        """``GET /debug/state``: the waiting queue (under this scheduler's
        lock, briefly) and the engine view.  While an iteration runs the
        view is the one published at the last iteration's end (the HTTP
        thread never touches live engine state); while the scheduler is
        parked (``_busy_since`` None under the lock, and it cannot start
        an iteration without the lock) the view is rebuilt here.  A parked
        scheduler has no step in flight: the batch's last step is
        committed when it empties, dispatch-ahead or not."""
        self._debug_requested = True
        now = time.monotonic()
        with self._lock:
            waiting = [
                {
                    "age_s": round(now - e.enqueued_at, 4),
                    "prompts": len(e.prompts),
                    "admitted_rows": e.next_row,
                    "max_new": e.max_new,
                    "deadline_in_s": (round(e.deadline - now, 4)
                                      if e.deadline is not None else None),
                    "tenant": e.tenant,
                    "priority": e.priority,
                    "requeued_rows": len(e.requeue_rows),
                }
                for e in self._entries
            ]
            tenant_admitted = dict(self._tenant_admitted)
            tenant_preempted = dict(self._tenant_preempted)
            closed = self._closed
            busy = now - self._busy_since if self._busy_since is not None else 0.0
            decisions = list(self.decision_log)  # appended under this lock
            if self._busy_since is None:
                self._publish_debug()
        # per label (the top-k fold), so the keys match the counters
        tenants: Dict[str, Dict[str, Any]] = {}
        for w in waiting:
            lab = self._tenant_labels.label(w["tenant"])
            t = tenants.setdefault(lab, {"waiting": 0, "admitted_rows": 0})
            t["waiting"] += 1
        for lab, n in tenant_admitted.items():
            tenants.setdefault(lab, {"waiting": 0})["admitted_rows"] = n
        for lab, n in tenant_preempted.items():
            tenants.setdefault(lab, {"waiting": 0})["preempted_rows"] = n
        return {
            "scheduler": "continuous",
            "depth": len(waiting),
            "waiting": waiting,
            "tenants": tenants,
            "preempt_min_tokens": self.preempt_min_tokens,
            "busy_s": round(busy, 4),
            "closed": closed,
            "iterations": self._iter_counter,
            "decisions": decisions,
            **self._debug_engine,
        }

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
        per = self.engine.warmup(prompt_lens)
        self._publish_debug()  # /debug/state sees the warmed shapes
        return per

    # -- scheduler loop -------------------------------------------------
    def _has_live_rows(self) -> bool:
        return any(r is not None for r in self.engine.slots)

    def _run(self) -> None:
        while True:
            t_wait0 = time.monotonic()
            with self._wake:
                while not self._entries and not self._has_live_rows() and not self._closed:
                    self._wake.wait()
                drained = not self._entries and not self._has_live_rows()
                if not drained:
                    t_busy0 = time.monotonic()
                    self._busy_since = t_busy0
                    # the parked wait is idle: with each iteration's own
                    # duration, the ledger covers this thread's whole wall
                    self._time_ledger["idle"] += t_busy0 - t_wait0
                    self._sched_wall_s += t_busy0 - t_wait0
            if drained:
                # closed and empty: commit a step still in flight (its rows
                # all finished), so the drain leaves nothing on the device
                self._flush_engine()
                return
            try:
                self._iterate()
            finally:
                with self._lock:
                    self._busy_since = None

    def _shed_locked(self, entry: _CBEntry) -> None:
        self.stats["shed_deadline"] += 1
        waited = time.monotonic() - entry.enqueued_at
        logger.warning(f"{self.name}: shed expired request after {waited:.2f}s queued")
        if entry.future.trace is not None:
            entry.future.trace.event("shed", reason="expired_in_queue")
        entry.future.set_exception(
            DeadlineExceeded(f"deadline exceeded after {waited:.2f}s queued")
        )

    def _evict_entry(self, entry: _CBEntry, reason: str) -> None:
        """Mid-decode eviction: free every admitted row of the entry and
        resolve its future; the blocks return to the pool at once.  The
        rows' tokens on the books leave the token ledger as
        ``shed_after_admit`` (an entry that expired partly admitted) or
        ``evicted_lost``."""
        eng = self.engine
        disposition = "shed_after_admit" if reason == "expired_partial" else "evicted_lost"
        n = 0
        for i, r in enumerate(eng.slots):
            if r is not None and r.entry is entry:
                self._tok_ledger[disposition] += self._row_on_books(r)
                eng.release(i)
                n += 1
        with self._lock:
            self.stats["evictions"] += n
            self.stats["shed_deadline"] += 1
        if entry.future.trace is not None:
            entry.future.trace.event("evicted", rows=n, reason=reason)
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
        # the rows died with their tokens on the books: evicted_lost (the
        # commits that landed before the failure are folded in first)
        self._fold_admitted()
        for r in rows:
            self._tok_ledger["evicted_lost"] += self._row_on_books(r)
        for e in {r.entry for r in rows if r.entry is not None}:
            if not e.future.done():
                e.future.set_exception(exc)

    def _iterate(self) -> int:
        """One scheduler iteration; returns the rows it finished.  Its wall
        seconds go to the time ledger (the engine's phase accumulators'
        deltas, host_sched the rest), its live rows' occupancy to their
        tenants, and, while tracing is on, one decision-log row of counter
        deltas (baseline-diffed, so an admission before a failure still
        lands).  All of it after the step's dispatch: in the device's
        shadow under dispatch-ahead, and none of it reads the device."""
        eng = self.engine
        trace_on = get_trace_buffer().enabled
        if trace_on:
            base = (self._decision_counters(), eng.cache.allocator.free_count(),
                    dict(self._tenant_admitted), dict(self._tenant_preempted),
                    dict(self._tok_ledger))
        t_iter0 = time.monotonic()
        acc0 = {k: float(eng.stats[k]) for k in
                ("t_device_decode", "t_device_prefill", "t_readback", "t_stream_flush")}
        n_finished = 0
        try:
            n_finished = self._iterate_inner()
            return n_finished
        finally:
            self._fold_admitted()
            dur = time.monotonic() - t_iter0
            d = {k: float(eng.stats[k]) - v for k, v in acc0.items()}
            led = self._time_ledger
            led["device_decode"] += d["t_device_decode"]
            led["device_prefill"] += d["t_device_prefill"]
            led["readback"] += d["t_readback"]
            led["stream_flush"] += d["t_stream_flush"]
            led["host_sched"] += max(0.0, dur - sum(d.values()))
            self._sched_wall_s += dur
            # every live row held its slot and blocks for the iteration
            for r in eng.slots:
                if r is not None and r.entry is not None:
                    lab = self._tenant_labels.label(r.entry.tenant)
                    occ = self._tenant_occ.setdefault(lab, {"slot_s": 0.0, "kv_block_s": 0.0})
                    occ["slot_s"] += dur
                    occ["kv_block_s"] += len(r.table) * dur
            self._iter_counter += 1
            if trace_on:
                self._log_decision(*base, n_finished)
            if trace_on or self._debug_requested:
                self._publish_debug()

    def _decision_counters(self) -> Dict[str, int]:
        """The counters a decision-log row diffs, under its column names."""
        eng = self.engine
        pfx, spill = eng.cache.prefix.stats, eng.cache.spill.stats
        return {
            "admitted": int(self.stats["prefill_admits"]),
            "evicted": int(self.stats["evictions"]),
            "shed": int(self.stats["shed_deadline"]),
            "spec_proposed": int(eng.stats["spec_proposed"]),
            "spec_accepted": int(eng.stats["spec_accepted"]),
            "prefix_hits": int(pfx["hits"]),
            "prefix_hit_tokens": int(pfx["hit_tokens"]),
            "prefix_evictions": int(pfx["evictions"]),
            "chunks": int(eng.stats["prefill_chunks"]),
            "spills": int(spill["spills"]),
            "readmits": int(spill["readmits"]),
            "spill_discards": int(spill["discards"]),
            "migrate_adopted": int(eng.stats["migrate_adopted"]),
        }

    def _log_decision(self, base, blocks_free0, tadmit0, tpre0, tok0, n_finished) -> None:
        """Append this iteration's decision-log row (the JAX columns)."""
        eng = self.engine
        now = self._decision_counters()
        free = eng.cache.allocator.free_count()
        row = {
            "iter": self._iter_counter,
            "t": round(time.monotonic(), 6),
            **{k: v - base[k] for k, v in now.items()},
            # informational (not replayed): 0 when the step raised
            "finished": n_finished,
            "active": eng.active_rows(),
            "width_bucket": eng.table_width_bucket(),
            "blocks_free": free,
            "blocks_delta": free - blocks_free0,
        }
        for k in ("admitted", "delivered", "evicted_lost", "preempt_refunded",
                  "shed_after_admit"):
            row[f"tok_{k}"] = self._tok_ledger[k] - tok0[k]
        tenants_row = {lab: n - tadmit0.get(lab, 0) for lab, n in self._tenant_admitted.items()
                       if n - tadmit0.get(lab, 0)}
        preempted_row = {lab: n - tpre0.get(lab, 0)
                         for lab, n in self._tenant_preempted.items() if n - tpre0.get(lab, 0)}
        row["preempted"] = sum(preempted_row.values())
        if tenants_row:
            row["tenants"] = tenants_row
        if preempted_row:
            row["preempted_tenants"] = preempted_row
        with self._lock:
            self.decision_log.append(row)

    def _iterate_inner(self) -> int:
        eng = self.engine
        now = time.monotonic()
        n_finished = 0
        # the k-step scheduling quantum: the shed, eviction and admission
        # scans below run on quantum boundaries only.  An iteration with no
        # live row always scans: waiting entries admit now, never after k
        # empty spins
        boundary = (self.quantum <= 1 or self._iter_counter % self.quantum == 0
                    or not self._has_live_rows())
        if not boundary:
            return self._step_batch()
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
        if expired:
            # row membership is about to change: commit the step in flight
            # first, so evicted rows' last tokens land before their blocks
            # return
            n_finished += self._flush_engine()
        partial = set(expired_partial)
        for e in expired:
            if not e.future.done():  # the flushed step may have completed it
                self._evict_entry(e, "expired_partial" if e in partial else "mid-decode")

        with self._wake:
            waiting = bool(self._entries)
        if waiting:
            # admission sees the slots and blocks the step in flight frees
            n_finished += self._flush_engine()

        reserved_blocks = 0
        blocked: Optional[tuple] = None
        with self._wake:
            # the weighted-fair pull: each pick serves the chosen tenant's
            # oldest unit (a preempted row waiting to resume before any
            # fresh row) and charges one deficit.  Nothing is allocated
            # until the prefill loop below, so the pull accounts for its
            # own picks: a burst larger than the free capacity stays queued
            free_slots = eng.free_slots()
            free_blocks = eng.cache.allocator.free_count()
            # cached-prefix blocks only the index references evict on
            # demand inside admit: count them in lazily (the scan is
            # O(cached blocks); an iteration the free pool covers skips it)
            reclaim_counted = False
            self._entries = [e for e in self._entries if not e.future.done()]
            while self._entries:
                backlog: Dict[str, int] = {}
                for e in self._entries:
                    backlog[e.tenant] = backlog.get(e.tenant, 0) + 1
                pick = self._fair.pick(backlog)
                head = next(e for e in self._entries if e.tenant == pick)
                row_idx, prompt, mx, resumed = self._next_unit(head)
                need = blocks_for(eng.row_capacity_tokens(len(prompt), mx), eng.block)
                if need > free_blocks and not reclaim_counted:
                    free_blocks += eng.cache.prefix.reclaimable_blocks()
                    reclaim_counted = True
                if free_slots < 1 or need > free_blocks:
                    # head-of-line blocked until rows finish: the priority
                    # preemption candidate below
                    blocked = (head, row_idx, prompt, mx, resumed, need)
                    break
                free_slots -= 1
                free_blocks -= need
                reserved_blocks += need
                self._take_unit_locked(head, row_idx, prompt, mx, resumed, admitted)

        # priority preemption (outside the lock: engine work).  A blocked
        # arrival of strictly higher priority than the lowest-priority
        # active row may seat itself by preempting that row;
        # preempt_storm:K forces one preemption at iteration K with no
        # arrival.  Victims must be past the minimum-progress floor, and a
        # preempted row is requeued as a continuation, never killed.  The
        # step in flight is committed before the first victim goes, and the
        # victim is picked again on the committed state.
        storm = maybe_fire("preempt_storm", self._iter_counter + 1)
        want = blocked if blocked is not None and not blocked[0].future.done() else None
        if want is not None or storm:
            flushed = False
            fits = False
            for _ in range(eng.capacity + 1):
                if want is not None:
                    need = want[5]
                    free_s = eng.free_slots() - len(admitted)
                    free_b = eng.cache.allocator.free_count() - reserved_blocks
                    if need > free_b:
                        free_b += eng.cache.prefix.reclaimable_blocks()
                    if free_s >= 1 and need <= free_b:
                        fits = True
                        break
                # before the flush a row's committed count lags the step in
                # flight by one token: the pre-flush probe takes that slack,
                # so the flush (which costs the overlap) runs only when a
                # victim is at least plausibly eligible
                victim = self._pick_victim(want[0].priority if want is not None else None,
                                           progress_slack=0 if flushed else 1)
                if victim is None:
                    break
                if not flushed:
                    n_finished += self._flush_engine()
                    flushed = True
                    continue  # the flush may have finished the victim
                self._preempt_slot(victim)
                if want is None:
                    break  # a storm fire: exactly one forced preemption
            if want is not None and fits:
                # seat the preemptor now: it earned the freed capacity (no
                # second fair pick: priority cuts across fairness, and its
                # tenant's deficit is still charged)
                with self._wake:
                    if not want[0].future.done():
                        self._take_unit_locked(*want[:5], admitted)

        # prefill-on-admit (outside the lock: device work)
        for entry, row_idx, prompt, mx, resumed in admitted:
            if entry.future.done():
                continue  # an earlier row of this entry already failed
            self._req_counter += 1
            try:
                maybe_fire("gen_crash", self._req_counter)
                eng.admit(prompt, mx, entry=entry, row_idx=row_idx)
                if resumed:
                    # a resume re-admits the prefix its preemption refunded
                    self._tok_ledger["admitted"] += len(entry.row_prefill.get(row_idx, ()))
                self.stats["prefill_admits"] += 1
                lab = self._tenant_labels.label(entry.tenant)
                self._tenant_admitted[lab] = self._tenant_admitted.get(lab, 0) + 1
                get_registry().counter("pfx_tenant_admitted_total", tenant=lab).inc()
            except ArenaReset as exc:
                # the prefill failed: every live row died with the arena
                self.stats["gen_errors"] += 1
                self._fail_rows(exc.dead_rows, exc)
                if not entry.future.done():
                    entry.future.set_exception(exc)
                logger.warning(f"{self.name}: {exc}")
            except (BlockPoolExhausted, RuntimeError, ValueError) as exc:
                # host-side failure before any device work: the arena is
                # intact, fail only this entry (and its admitted rows, whose
                # tokens on the books are lost)
                self.stats["gen_errors"] += 1
                for i, r in enumerate(eng.slots):
                    if r is not None and r.entry is entry:
                        self._tok_ledger["evicted_lost"] += self._row_on_books(r)
                        eng.release(i)
                if not entry.future.done():
                    entry.future.set_exception(exc)
                logger.warning(f"{self.name}: admission failed: {type(exc).__name__}: {exc}")

        return n_finished + self._step_batch()

    def _take_unit_locked(self, head: _CBEntry, row_idx: int, prompt: List[int], mx: int,
                          resumed: bool, admitted: List[tuple]) -> None:
        """Book one picked unit for this iteration's admissions: charge
        its tenant, stamp its pickup, advance the entry, and drop the entry
        from the queue once every row of it is admitted."""
        self._fair.charge(head.tenant)
        t_pick = time.monotonic()
        head.future.times.setdefault("picked", t_pick)
        if head.future.trace is not None and head.next_row == 0 and not resumed:
            head.future.trace.span("queue_wait", t0=head.enqueued_at, t1=t_pick)
        admitted.append((head, row_idx, prompt, mx, resumed))
        if resumed:
            head.requeue_rows.pop(0)
        else:
            head.next_row += 1
        if (head.next_row >= len(head.prompts) and not head.requeue_rows
                and head in self._entries):
            self._entries.remove(head)

    def _next_unit(self, head: _CBEntry) -> tuple:
        """The entry's next admissible unit, ``(row_idx, prompt, max_new,
        resumed)``.  A preempted row waiting to resume goes before any
        fresh row: its prompt is the original prompt plus every committed
        token (mostly a prefix hit with the cache on), its budget what
        remains."""
        if head.requeue_rows:
            row_idx = head.requeue_rows[0]
            committed = head.row_prefill.get(row_idx, [])
            return (row_idx, head.prompts[row_idx] + committed,
                    head.max_new - len(committed), True)
        return head.next_row, head.prompts[head.next_row], head.max_new, False

    def _pick_victim(self, below_priority: Optional[int],
                     progress_slack: int = 0) -> Optional[int]:
        """The slot of the lowest-priority row eligible for preemption, or
        None: decode-active with its prefill done, its entry live, at
        least ``preempt_min_tokens`` committed since its last admission
        (less ``progress_slack``; a resumed victim re-earns eligibility)
        and, unless ``below_priority`` is None (the preempt_storm drill),
        strictly below the preemptor's priority.  Ties: the lowest slot."""
        eng = self.engine
        best: Optional[int] = None
        for i, r in enumerate(eng.slots):
            if r is None or r.entry is None or r.entry.future.done():
                continue
            if not r.prefill_done or not bool(eng.active[i]):
                continue
            if len(r.tokens) + progress_slack < self.preempt_min_tokens:
                continue
            if below_priority is not None and r.entry.priority >= below_priority:
                continue
            if best is None or (r.entry.priority, i) < (eng.slots[best].entry.priority, best):
                best = i
        return best

    def _preempt_slot(self, slot: int) -> None:
        """Preempt one active row and requeue it as a continuation: the
        engine publishes its KV-valid prefix and frees the slot, the
        committed tokens join the entry's resume state, and the entry
        re-enters the queue at the FRONT (it already waited its turn)."""
        eng = self.engine
        row = eng.slots[slot]
        entry = row.entry
        committed = eng.preempt_row(slot)
        entry.row_prefill[row.row_idx] = entry.row_prefill.get(row.row_idx, []) + committed
        entry.requeue_rows.append(row.row_idx)
        # the row's whole on-book amount leaves as a refund; its resume
        # re-admits it, so the books close across any preempt-resume chain
        self._tok_ledger["preempt_refunded"] += len(entry.row_prefill[row.row_idx])
        self.stats["preemptions"] += 1
        lab = self._tenant_labels.label(entry.tenant)
        self._tenant_preempted[lab] = self._tenant_preempted.get(lab, 0) + 1
        get_registry().counter("pfx_tenant_preemptions_total", tenant=lab).inc()
        if row.trace is not None:
            row.trace.event("preempted", slot=slot, committed=len(committed),
                            total_committed=len(entry.row_prefill[row.row_idx]))
        logger.info(f"{self.name}: preempted slot {slot} (tenant {entry.tenant}, priority "
                    f"{entry.priority}) after {len(committed)} committed token(s); requeued "
                    "as a continuation")
        with self._wake:
            if entry not in self._entries:
                self._entries.insert(0, entry)
            self._wake.notify_all()

    def _step_batch(self) -> int:
        """One decode step (dispatch, and commit unless it stays in
        flight), then resolve the rows the committed step finished."""
        if not self._has_live_rows():
            return 0
        eng = self.engine
        self._step_counter += 1
        maybe_fire("cb_step_hang", self._step_counter)
        try:
            finished = eng.step()
            if eng.has_inflight and all(r is None or i in finished
                                        for i, r in enumerate(eng.slots)):
                # the batch empties: commit the step still in flight (it
                # has no row left) before the last answers go out, so an
                # idle engine has nothing on the device and its committed
                # steps match the launches counted (the JAX engine leaves
                # it to the next flush)
                finished += eng.flush()
        except ArenaReset as exc:
            with self._lock:
                self.stats["gen_errors"] += 1
            self._fail_rows(exc.dead_rows, exc)
            logger.warning(f"{self.name}: {exc}")
            return 0
        self._fold_admitted()  # before _finish_rows can deliver them
        with self._lock:
            self.stats["batches"] += 1
        return self._finish_rows(finished)

    def _flush_engine(self) -> int:
        """Commit the engine's step in flight (a no-op when there is none)
        and resolve the rows it finished: the flush that must come before
        any change of row membership."""
        if not self.engine.has_inflight:
            return 0
        try:
            finished = self.engine.flush()
        except ArenaReset as exc:
            with self._lock:
                self.stats["gen_errors"] += 1
            self._fail_rows(exc.dead_rows, exc)
            logger.warning(f"{self.name}: {exc}")
            return 0
        self._fold_admitted()  # before _finish_rows can deliver them
        return self._finish_rows(finished)

    def _finish_rows(self, finished: List[int]) -> int:
        eng = self.engine
        reg = get_registry()
        for slot in finished:
            row = eng.slots[slot]
            entry = row.entry
            eng.release(slot)
            if entry is None:
                continue
            entry.results[row.row_idx] = entry.finished_tokens(row.row_idx, row.tokens)
            # the whole output (resume prefix included) is delivered
            self._tok_ledger["delivered"] += len(entry.results[row.row_idx])
            entry.done_rows += 1
            if entry.done_rows == len(entry.prompts) and not entry.future.done():
                entry.future.set_result(list(entry.results))
                self.stats["completed"] += 1
                reg.counter("pfx_serving_requests_total").inc()
                reg.counter("pfx_serving_tokens_out_total").inc(
                    sum(len(t) for t in entry.results))
        return len(finished)

