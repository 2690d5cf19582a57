"""CUDA graphs of the continuous engine's decode and verify steps.

The port's counterpart of the JAX engine's compiled step families
(``paddlefleetx_tpu/core/continuous_batching.py`` ``_step_fn(M)``: one
executable per (capacity, table width), dispatched in one call), not a
feature of its own.  PyTorch runs the paged step eagerly, one launch at a
time: at GPT-345M a bf16 step is about 1100 launches, whose host cost is
several times the device's (``tools/profile_engine.py`` on an H100).  A :class:`StepGraphs` captures each
step shape once and replays it as one launch.

One ``torch.cuda.CUDAGraph`` per key, the keys the engine's
``stats["traces"]`` already counts: ("step", capacity, M) and ("verify",
capacity, M, k).  All graphs share one memory pool (a failed capture
retires it: the next capture starts another).  The first use of a
key runs the step eagerly on a side stream (that run IS the step: the
graph is not replayed for it), then captures it.  A graph reads and writes
only tensors whose memory outlives it (the engine's static buffers, the
arena, the weights and the split-K scratch, of which it keeps a
reference), so a replay is the step on the buffers' current contents.

Launch counts: a wrapper counts a kernel launch when Python calls it, and
a replay calls no Python.  So a capture records the counts its kernels
added to ``ops/decode_attention.COUNTS``, takes them back (a capture
launches nothing) and adds them again on every replay.

Random draws: the generator the steps sample from is registered with
every graph, so each replay advances its Philox offset as an eager step
would; without it every replay would repeat the capture's offset.

Failures raise: a capture that cannot run (a host sync inside the step, a
scratch buffer too small) or a replay that fails is an error of the step,
never a reason to step eagerly instead.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, List, Optional

import torch

from paddlefleetx_tpu_torch.ops import decode_attention as da

# graphs whose capture failed.  Such a capture can leave its memory pool
# recording in the caching allocator, with a filter that reads the graph
# object, so the object must outlive the process's later captures (which
# take a fresh pool)
_FAILED_CAPTURES: List[Any] = []


class StepGraphs:
    """The capture cache of one engine on one CUDA device."""

    def __init__(self, device: torch.device, generator: Optional[torch.Generator] = None) -> None:
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        self.generator = generator
        self._graphs: Dict[Hashable, tuple] = {}
        self._pool = None
        self._side: Optional[torch.cuda.Stream] = None
        # the split-K scratch pairs the graphs were captured with
        self._held: List[Any] = []
        self.stats: Dict[str, Any] = {"graphs": 0, "graph_replays": 0, "graph_capture_s": 0.0}

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Run one step: replay ``key``'s graph, or on its first use run
        ``fn`` eagerly and capture it for the next."""
        entry = self._graphs.get(key)
        if entry is None:
            self._capture(key, fn)
            return
        graph, delta = entry
        graph.replay()
        for name, n in delta.items():
            da.COUNTS[name] += n
        self.stats["graph_replays"] += 1

    def _capture(self, key: Hashable, fn: Callable[[], None]) -> None:
        t0 = time.perf_counter()
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        # the eager run (this call's step) on the side stream the capture
        # uses, so its first-use allocations and library set-up happen
        # outside the graph
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            fn()
        cur.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = dict(da.COUNTS)
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._side,
                                  capture_error_mode="thread_local"):
                fn()
        except BaseException:
            _FAILED_CAPTURES.append(graph)
            self._pool = None
            raise
        finally:
            delta = {k: da.COUNTS[k] - before[k] for k in da.COUNTS if da.COUNTS[k] != before[k]}
            da.COUNTS.update(before)
        scratch = da.split_scratch(self.device)
        if scratch is not None and all(scratch is not h for h in self._held):
            self._held.append(scratch)
        self._graphs[key] = (graph, delta)
        self.stats["graphs"] = len(self._graphs)
        self.stats["graph_capture_s"] += time.perf_counter() - t0

    def drop(self) -> None:
        """Release every graph (and their pool); the next use of a key
        captures it again."""
        torch.cuda.current_stream(self.device).synchronize()
        self._graphs.clear()
        self._held.clear()
        self._pool = None
        self._side = None
        self.stats["graphs"] = 0
