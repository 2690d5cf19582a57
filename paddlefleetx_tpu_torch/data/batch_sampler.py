"""Batch sampling and host batch assembly.

Counterpart of ``paddlefleetx_tpu/data/batch_sampler.py``
(``DistributedBatchSampler:36``, ``collate_stack:99``, ``DataLoader:106``,
``WorkerLoader:250``, ``PrefetchLoader:465``).  On one device the sampler yields global batches
of dataset indices; resume is a sample counter (``consumed_samples``),
the contract the checkpoint meta carries.

Iterator-state contract: every loader here has ``state_dict()``,
``load_state(state)`` and ``rewind(consumed_samples)``.  The engine saves
the stream position in the checkpoint meta, and an anomaly rollback
rewinds the stream to the checkpoint's position, so the replayed data is
token for token what an uninterrupted run would have served.  The
position is read at ``iter()`` time: callers re-``iter()`` after a
rewind, and ``PrefetchLoader.rewind`` stops its thread first so its
lookahead cannot leak into the replay.

Not ported: the fault-injection sites inside the fetch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from paddlefleetx_tpu_torch.utils.log import logger


class DistributedBatchSampler:
    """Global batches of indices over ``dataset_len`` samples, shuffled
    per epoch with ``default_rng(seed + epoch)`` when ``shuffle``; starts
    at ``consumed_samples``."""

    def __init__(self, dataset_len: int, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 1234, consumed_samples: int = 0):
        self.n = int(dataset_len)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.consumed_samples = int(consumed_samples)
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.drop_last and self.n < self.batch_size:
            raise ValueError(
                f"dataset has {self.n} samples < batch_size {self.batch_size} with "
                "drop_last: no batch can ever be formed; lower the batch size "
                "(Global.eval_batch_size for eval) or grow the data"
            )

    def __iter__(self) -> Iterator[np.ndarray]:
        epoch = self.consumed_samples // self.n
        offset = self.consumed_samples % self.n
        while True:
            if self.shuffle:
                order = np.random.default_rng(self.seed + epoch).permutation(self.n)
            else:
                order = np.arange(self.n)
            for i in range(offset, self.n - self.batch_size + 1, self.batch_size):
                batch = order[i: i + self.batch_size]
                self.consumed_samples += len(batch)
                yield batch
            if not self.drop_last and (self.n - offset) % self.batch_size:
                tail = order[self.n - (self.n - offset) % self.batch_size:]
                self.consumed_samples += len(tail)
                yield tail
            epoch += 1
            offset = 0

    def state_dict(self) -> Dict[str, int]:
        return {"consumed_samples": self.consumed_samples}

    def load_state(self, state: Dict[str, int]) -> None:
        self.rewind(int(state["consumed_samples"]))

    def rewind(self, consumed_samples: int) -> None:
        """Reposition the stream at ``consumed_samples`` (read at the next
        ``iter()``)."""
        cs = int(consumed_samples)
        if cs < 0:
            raise ValueError(f"consumed_samples must be >= 0, got {cs}")
        self.consumed_samples = cs


def collate_stack(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """A dict of arrays stacked over the items."""
    return {k: np.stack([it[k] for it in items]) for k in items[0].keys()}


class DataLoader:
    """Sampler indices -> collated numpy batches, fetched inline.

    A sample whose fetch raises is skipped under a budget of ``max_skips``
    (``Data.<mode>.loader.max_skips``, default 0: the first bad sample
    fails): the next dataset index is substituted, deterministically, so a
    resumed or rewound replay that meets the same record serves the same
    substitute; each skip appends a ``data_skip`` event to
    ``skip_events`` (the engine moves them into the metrics stream), and
    an exhausted budget raises naming it."""

    def __init__(self, dataset, sampler: DistributedBatchSampler, collate_fn=collate_stack,
                 max_skips: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.max_skips = int(max_skips)
        self.skips = 0
        self.skip_events: List[Dict] = []
        # (stream position, cumulative skips) per skip on top of _skip_base
        # (restored from a checkpoint): skips_at(pos) charges the trained
        # data only, not a prefetch lookahead a resume would replay
        self._skip_base = 0
        self._skip_log: List[tuple] = []

    def _get(self, idx: int):
        try:
            return self.dataset[int(idx)]
        except Exception as e:  # noqa: BLE001 — budgeted, re-raised below
            return self._skip_and_substitute(int(idx), e)

    def _budget_error(self, idx: int, err: Exception) -> RuntimeError:
        return RuntimeError(
            f"data.max_skips budget exhausted: sample {idx} failed ({type(err).__name__}: "
            f"{err}) after {self.skips} skip(s) already spent (data.max_skips="
            f"{self.max_skips}); fix the shard or raise Data.<mode>.loader.max_skips"
        )

    def _skip_and_substitute(self, idx: int, err: Exception):
        n = len(self.dataset)
        bad = idx
        for attempt in range(1, max(n, 2)):
            if self.skips >= self.max_skips:
                raise self._budget_error(bad, err) from err
            self.skips += 1
            # the sampler counts a batch before yielding it: this is the
            # batch's end position
            pos = self.sampler.consumed_samples
            self._skip_log.append((pos, self.skips))
            sub = (idx + attempt) % n
            self.skip_events.append({
                "event": "data_skip", "index": bad, "substitute": sub, "pos": pos,
                "error": f"{type(err).__name__}: {err}", "skips": self.skips,
                "max_skips": self.max_skips,
            })
            logger.error(f"DATA SKIP {self.skips}/{self.max_skips}: sample {bad} failed "
                         f"({type(err).__name__}: {err}); substituting sample {sub}")
            try:
                return self.dataset[sub]
            except Exception as e:  # noqa: BLE001 — bounded by the budget
                bad, err = sub, e
        raise RuntimeError(f"every substitute sample failed after {self.skips} skip(s); "
                           f"last error on sample {bad}: {err}") from err

    def __iter__(self):
        for batch_idx in self.sampler:
            yield self.collate_fn([self._get(int(i)) for i in batch_idx])

    def state_dict(self) -> Dict[str, int]:
        state = dict(self.sampler.state_dict())
        state["skips"] = self.skips
        return state

    def load_state(self, state: Dict[str, int]) -> None:
        self.sampler.load_state(state)
        self.skips = int(state.get("skips", self.skips))
        self._skip_base = self.skips
        self._skip_log = []

    def rewind(self, consumed_samples: int) -> None:
        self.sampler.rewind(consumed_samples)

    def skips_at(self, consumed_samples: int) -> int:
        """Skips charged by batches at stream positions <=
        ``consumed_samples``: what a checkpoint at that position records."""
        out = self._skip_base
        for pos, cum in self._skip_log:
            if pos <= int(consumed_samples):
                out = cum
        return out

    def close(self) -> None:
        """Nothing to reclaim; present so every loader closes alike."""

    def stats(self) -> Dict[str, float]:
        return {"skips": self.skips}


class WorkerLoader:
    """Sampler indices -> collated batches, the samples fetched by a pool
    of ``num_workers`` processes (``Data.<mode>.loader.num_workers``).

    The workers start with ``spawn`` (a fresh interpreter: the training
    process holds CUDA and threads, which a fork would copy) and get the
    dataset pickled once, at pool start; afterwards only indices and
    samples cross the pipes.  ``pool.map`` keeps the sampler's order, so
    the batches are the inline loader's, and resume and rewind reposition
    the sampler as there (the pool is torn down first, so no stale
    lookahead leaks).  The pool lives for one iteration of the loader.
    A sample whose fetch raises fails the batch loudly: the corrupt-sample
    skip budget (``max_skips``) is the inline loader's.  The JAX loader's
    per-sample visit counters (for augmenting datasets) have no user here:
    no dataset of the port draws per visit."""

    def __init__(self, dataset, sampler: DistributedBatchSampler, collate_fn=collate_stack,
                 num_workers: int = 2):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, int(num_workers))
        self._gen = None

    def _iterate(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ctx.Pool(self.num_workers, initializer=_worker_init,
                      initargs=(self.dataset,)) as pool:
            for batch_idx in self.sampler:
                items = pool.map(_worker_get, [int(i) for i in batch_idx],
                                 chunksize=max(1, len(batch_idx) // self.num_workers))
                yield self.collate_fn(items)

    def __iter__(self):
        self.close()  # at most one live pool per loader
        self._gen = self._iterate()
        return self._gen

    def state_dict(self) -> Dict[str, int]:
        return self.sampler.state_dict()

    def load_state(self, state: Dict[str, int]) -> None:
        self.close()
        self.sampler.load_state(state)

    def rewind(self, consumed_samples: int) -> None:
        self.close()
        self.sampler.rewind(consumed_samples)

    def close(self) -> None:
        """Terminate the pool (closing the generator unwinds its ``with``)."""
        gen, self._gen = self._gen, None
        if gen is not None:
            gen.close()

    def stats(self) -> Dict[str, float]:
        return {}


_WORKER_DATASET = None


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(idx: int):
    return _WORKER_DATASET[idx]


class _PrefetchIterator:
    """One live prefetch stream: a thread fills a bounded queue from the
    wrapped loader; the consumer pops with starvation accounting."""

    def __init__(self, parent: "PrefetchLoader"):
        self.parent = parent
        self.q: queue.Queue = queue.Queue(maxsize=max(1, parent.depth))
        self.stop = threading.Event()
        self.err: List[BaseException] = []
        self.done = False
        self.thread = threading.Thread(target=self._producer, daemon=True,
                                       name="pfx-prefetch")
        self.thread.start()

    def _put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            for item in self.parent.loader:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            self.err.append(e)
        finally:
            self._put(PrefetchLoader._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self.done:
            raise StopIteration
        t0 = time.monotonic()
        warned = False
        while True:
            try:
                item = self.q.get(timeout=0.5)
                break
            except queue.Empty:
                waited = time.monotonic() - t0
                warn_s = self.parent.stall_warn_s
                if not warned and warn_s > 0 and waited >= warn_s:
                    warned = True
                    self.parent.stall_warnings += 1
                    logger.warning(
                        f"prefetch starved: the training step has waited {waited:.1f}s for "
                        f"the next batch (warn threshold {warn_s:.1f}s): an I/O stall, or "
                        "the host data pipeline cannot keep up with the device step"
                    )
        self.parent.data_wait_s += time.monotonic() - t0
        if item is PrefetchLoader._DONE:
            self.done = True
            self._join()
            if self.err:
                raise self.err[0]
            raise StopIteration
        return item

    def depth(self) -> int:
        return self.q.qsize()

    def close(self) -> None:
        self.stop.set()
        self._join()

    def _join(self) -> None:
        self.thread.join(self.parent.join_timeout_s)
        if self.thread.is_alive():
            logger.warning(f"prefetch thread did not exit within "
                           f"{self.parent.join_timeout_s:.1f}s (blocked in a sample fetch?); "
                           "leaving the daemon thread behind")


class PrefetchLoader:
    """A background thread assembles the next ``depth`` batches while the
    device steps.  Producer errors re-raise in the consumer; ``stats()``
    reports the queue depth and the consumer's seconds starved
    (``data_wait_s``); a wait past ``stall_warn_s`` warns once per batch;
    ``close()`` stops and joins the thread; ``rewind``/``load_state`` stop
    the live stream first."""

    _DONE = object()

    def __init__(self, loader, depth: int = 2, stall_warn_s: float = 30.0,
                 join_timeout_s: float = 5.0):
        self.loader = loader
        self.depth = int(depth)
        self.stall_warn_s = float(stall_warn_s)
        self.join_timeout_s = float(join_timeout_s)
        self.data_wait_s = 0.0
        self.stall_warnings = 0
        self._it: Optional[_PrefetchIterator] = None

    def __iter__(self):
        self._stop_stream()
        self._it = _PrefetchIterator(self)
        return self._it

    def _stop_stream(self) -> None:
        it, self._it = self._it, None
        if it is not None:
            it.close()

    def close(self) -> None:
        self._stop_stream()
        self.loader.close()

    def skips_at(self, consumed_samples: int):
        inner = getattr(self.loader, "skips_at", None)
        return inner(consumed_samples) if callable(inner) else None

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.loader.stats())
        out["data_wait_s"] = round(self.data_wait_s, 3)
        out["prefetch_depth"] = self._it.depth() if self._it is not None else 0
        out["stall_warnings"] = self.stall_warnings
        return out

    def state_dict(self) -> Dict[str, int]:
        return self.loader.state_dict()

    def load_state(self, state: Dict[str, int]) -> None:
        self._stop_stream()
        self.loader.load_state(state)

    def rewind(self, consumed_samples: int) -> None:
        self._stop_stream()
        self.loader.rewind(consumed_samples)

    @property
    def skips(self) -> int:
        return getattr(self.loader, "skips", 0)

    @property
    def skip_events(self) -> List[Dict]:
        return getattr(self.loader, "skip_events", [])
