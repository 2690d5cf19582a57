"""Admission-controlled serving request queue: bounded depth, deadlines,
coalescing and graceful drain.

Single-tenant counterpart of ``paddlefleetx_tpu/core/request_queue.py``
(tenancy, deep-dive tracing and ``debug_state`` come later):

  - **bounded admission**: ``submit`` raises :class:`QueueFull` at
    capacity (HTTP 429) and :class:`QueueClosed` while draining (HTTP 503);
  - **deadlines**: expired entries are shed with :class:`DeadlineExceeded`
    (HTTP 503) before a decode is spent on them, and a waiter that gives
    up can ``try_remove`` its entry;
  - **coalescing**: one scheduler thread merges waiting entries with an
    equal ``coalesce_key`` (same prompt bucket and decode bucket) into one
    batched runner call, up to ``max_coalesce`` prompts; each request's
    rows are trimmed back to its own ``max_new_tokens``;
  - **graceful drain**: ``close`` stops admission while admitted entries
    still run; ``join`` waits for the scheduler to finish them.

The runner is ``runner(prompts, max_new_tokens) -> rows`` (one row per
prompt, in order).  Coordination is plain ``threading``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

from paddlefleetx_tpu_torch.utils.log import logger


class QueueFull(RuntimeError):
    """Admission rejected: the bounded queue is at capacity (HTTP 429)."""


class QueueClosed(RuntimeError):
    """Admission rejected: the queue is draining or shut down (HTTP 503)."""


class DeadlineExceeded(RuntimeError):
    """The request expired before a decode was spent on it (HTTP 503)."""


class RequestFuture:
    """One-shot future resolved once by the scheduler thread."""

    __slots__ = ("_event", "_value", "_exc")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Wait for resolution; raises ``TimeoutError`` while still pending
        after ``timeout`` (pair with ``RequestQueue.try_remove``)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclass
class _Entry:
    """One admitted request (a client-side batch stays atomic)."""

    prompts: List[Any]
    max_new_tokens: int
    coalesce_key: Optional[Hashable]
    deadline: Optional[float]  # absolute time.monotonic(); None = none
    future: RequestFuture
    enqueued_at: float


class RequestQueue:
    """Bounded FCFS admission queue + one scheduler thread.

    Coalescing pulls later same-key entries forward into the oldest
    entry's batch; other entries keep their order.  ``coalesce_key=None``
    opts an entry out.  ``serving_stats`` (optional) supplies what
    :meth:`serving_stats` reports: the runner's own counters."""

    kind = "coalesce"

    def __init__(
        self,
        runner: Callable[[List[Any], int], Sequence[Any]],
        *,
        max_depth: int = 64,
        max_coalesce: int = 8,
        name: str = "serve",
        serving_stats: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> None:
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if max_coalesce < 1:
            raise ValueError(f"max_coalesce must be >= 1, got {max_coalesce}")
        self._runner = runner
        self._serving_stats = serving_stats
        self.max_depth = int(max_depth)
        self.max_coalesce = int(max_coalesce)
        self.name = name
        self._entries: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._busy_since: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self.stats = {
            "submitted": 0, "completed": 0, "batches": 0,
            "coalesced_batches": 0, "coalesced_requests": 0,
            "shed_deadline": 0, "rejected_full": 0, "rejected_closed": 0,
            "gen_errors": 0,
        }

    # -- admission ------------------------------------------------------
    def submit(
        self,
        prompts: Sequence[Any],
        max_new_tokens: int,
        *,
        coalesce_key: Optional[Hashable] = None,
        deadline_s: Optional[float] = None,
    ) -> RequestFuture:
        """Admit a request and return its future; raises ``QueueClosed``
        when draining and ``QueueFull`` at capacity."""
        if not prompts:
            raise ValueError("prompts must be non-empty")
        now = time.monotonic()
        entry = _Entry(
            prompts=list(prompts),
            max_new_tokens=int(max_new_tokens),
            coalesce_key=coalesce_key,
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
        """How long the current runner call has run (0 when idle)."""
        with self._lock:
            if self._busy_since is None:
                return 0.0
            return time.monotonic() - self._busy_since

    def stats_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)

    def serving_stats(self) -> Dict[str, Any]:
        return dict(self._serving_stats()) if self._serving_stats else {}

    def try_remove(self, future: RequestFuture) -> bool:
        """Shed a still-queued entry: resolve it with ``DeadlineExceeded``
        and return True; False when it is already running or resolved."""
        with self._wake:
            for e in self._entries:
                if e.future is future:
                    self._entries.remove(e)
                    self.stats["shed_deadline"] += 1
                    e.future.set_exception(DeadlineExceeded("deadline exceeded while queued"))
                    return True
        return False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "RequestQueue":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=f"{self.name}-scheduler", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop admitting; admitted entries still run (drain)."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the drain (queue empty, runner idle, scheduler exited);
        False on timeout."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Close, optionally answer waiting entries with ``QueueClosed``
        instead of running them (``drain=False``), and join."""
        self.close()
        if not drain:
            with self._wake:
                while self._entries:
                    e = self._entries.popleft()
                    e.future.set_exception(QueueClosed(f"{self.name} queue shut down"))
                self._wake.notify_all()
        return self.join(timeout)

    # -- scheduler ------------------------------------------------------
    def _take_batch_locked(self) -> Optional[List[_Entry]]:
        """Shed expired entries, then pop the oldest entry plus every
        waiting entry with its coalesce key while the prompt count stays
        within ``max_coalesce``.  None when nothing is waiting."""
        now = time.monotonic()
        live = []
        for e in self._entries:
            if e.deadline is not None and now > e.deadline:
                self.stats["shed_deadline"] += 1
                waited = now - e.enqueued_at
                logger.warning(
                    f"{self.name}: shed expired request after {waited:.2f}s queued"
                )
                e.future.set_exception(
                    DeadlineExceeded(f"deadline exceeded after {waited:.2f}s queued")
                )
            else:
                live.append(e)
        if not live:
            self._entries = deque()
            return None
        head = live.pop(0)
        batch, n, keep = [head], len(head.prompts), []
        for e in live:
            if (
                head.coalesce_key is not None
                and e.coalesce_key == head.coalesce_key
                and n + len(e.prompts) <= self.max_coalesce
            ):
                batch.append(e)
                n += len(e.prompts)
            else:
                keep.append(e)
        self._entries = deque(keep)
        return batch

    def _run(self) -> None:
        while True:
            with self._wake:
                batch = self._take_batch_locked()
                while batch is None:
                    if self._closed:
                        return  # drained: admission closed and queue empty
                    self._wake.wait()
                    batch = self._take_batch_locked()
                self._busy_since = time.monotonic()
            try:
                self._run_batch(batch)
            finally:
                with self._lock:
                    self._busy_since = None

    def _run_batch(self, batch: List[_Entry]) -> None:
        prompts = [p for e in batch for p in e.prompts]
        max_new = max(e.max_new_tokens for e in batch)
        with self._lock:
            self.stats["batches"] += 1
            if len(batch) > 1:
                self.stats["coalesced_batches"] += 1
                self.stats["coalesced_requests"] += len(batch)
        if len(batch) > 1:
            logger.info(
                f"{self.name}: coalesced {len(batch)} requests "
                f"({len(prompts)} prompts) into one batch"
            )
        try:
            rows = list(self._runner(prompts, max_new))
            if len(rows) != len(prompts):
                raise RuntimeError(
                    f"runner returned {len(rows)} rows for {len(prompts)} prompts"
                )
        except Exception as exc:  # noqa: BLE001 — every coalesced client gets it
            with self._lock:
                self.stats["gen_errors"] += 1
            for e in batch:
                e.future.set_exception(exc)
            logger.warning(
                f"{self.name}: generation failed for a batch of {len(batch)} "
                f"request(s): {type(exc).__name__}: {exc}"
            )
            return
        i = 0
        for e in batch:
            out = [r[: e.max_new_tokens] for r in rows[i:i + len(e.prompts)]]
            i += len(e.prompts)
            e.future.set_result(out)
            with self._lock:
                self.stats["completed"] += 1
