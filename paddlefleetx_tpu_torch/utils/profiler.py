"""On-demand profiling of a live serving process with ``torch.profiler``.

Counterpart of ``ProfileBusy:49``, ``profile_max_seconds:53`` and
``capture_profile:186`` of ``paddlefleetx_tpu/utils/profiler.py`` (the
training ``Profiler`` block is not ported): ``POST /admin/profile`` of the
serve CLI takes a capture of ``seconds`` while the scheduler keeps
serving, and answers with the summary.  The capture drives nothing and
waits on nothing: the profiler observes every running thread and, on the
card, the device through CUPTI.  Two safety rules: one capture at a time a process
(:class:`ProfileBusy`, HTTP 409) and a hard cap on the window
(``PFX_PROFILE_MAX_SECONDS``, default 30, HTTP 400 past it).

The summary keeps the JAX keys: ``seconds`` (the window and the
profiler's stop), ``trace_dir``, ``source``, ``device_us`` / ``host_us``
(the summed durations of the device events and of the host operators,
JAX's ``device_host_split``), ``op_count`` and ``top_ops`` (``op``,
``category``, ``occurrences``, ``total_us``, ``self_us``, ``self_frac``;
summed durations by name, JAX's ``trace_event_rows``).  On the card the op
rows are the device events (kernels, copies, memsets; CUPTI reports a
CUDA graph replay's kernels one by one) and a capture with none is an
error; on the CPU they are the host operators (``source`` "cpu").  No
Chrome trace is written (it runs to ~100 MB a second of serving): the
summary is the capture's artifact.  On the card a process's first capture
pays CUPTI's set-up in its start, and every stop processes the window's
events (seconds for a second of serving).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Tuple

import torch

from paddlefleetx_tpu_torch.utils.telemetry import env_float, get_registry

# one capture at a time a process: the profiler is a process-wide singleton
_CAPTURE_LOCK = threading.Lock()


class ProfileBusy(RuntimeError):
    """A profile capture is already active in this process."""


def profile_max_seconds() -> float:
    """The hard cap on a capture window (``PFX_PROFILE_MAX_SECONDS``,
    default 30): a trace grows with wall time."""
    return env_float("PFX_PROFILE_MAX_SECONDS", 30.0, minimum=0.001)


def _raw_events(prof):
    """(name, on the device, microseconds) of every recorded event.  A
    second of serving records ~10^5 events: read from the profiler's raw
    results (seconds), not folded through ``key_averages()`` (a minute)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        yield e.name(), e.device_type() == DeviceType.CUDA, e.duration_ns() / 1e3


def op_summary_rows(prof, cuda: bool) -> Tuple[List[Dict[str, Any]], float, float]:
    """(op rows by time, device_us, host_us) of a finished capture, the JAX
    ``trace_event_rows`` / ``device_host_split`` folds: per name the
    occurrences and the summed durations (a device event's duration is its
    own time; host operators nest, so theirs count their children too).
    On the card the rows are the device events, else the host operators."""
    agg: Dict[Tuple[str, bool], List[float]] = {}
    device_us = host_us = 0.0
    for name, on_device, us in _raw_events(prof):
        if on_device:
            device_us += us
        else:
            host_us += us
        entry = agg.setdefault((name, on_device), [0, 0.0])
        entry[0] += 1
        entry[1] += us
    rows = [{"op": name, "category": "device" if dev else "host", "occurrences": int(n),
             "total_us": us, "self_us": us}
            for (name, dev), (n, us) in agg.items() if dev == cuda]
    rows.sort(key=lambda r: -r["self_us"])
    return rows, device_us, host_us


def capture_profile(seconds: float, log_dir: str, top: int = 20,
                    device: torch.device = torch.device("cpu")) -> Dict[str, Any]:
    """Profile this live process for ``seconds`` and return the summary
    (the whole ``POST /admin/profile`` body).  Raises ``ValueError`` for a
    bad or over-cap window (HTTP 400), :class:`ProfileBusy` while another
    capture runs (HTTP 409), and ``RuntimeError`` when a capture on the
    card saw no device event."""
    cap = profile_max_seconds()
    try:
        seconds = float(seconds)
    except (TypeError, ValueError):
        raise ValueError(f"profile seconds must be a number, got {seconds!r}") from None
    if not seconds > 0:
        raise ValueError(f"profile seconds must be > 0, got {seconds}")
    if seconds > cap:
        raise ValueError(
            f"profile seconds={seconds} exceeds PFX_PROFILE_MAX_SECONDS={cap} "
            f"(raise the cap explicitly if you really want a longer trace)"
        )
    if not _CAPTURE_LOCK.acquire(blocking=False):
        raise ProfileBusy("a profile capture is already active in this process; "
                          "retry after it finishes")
    try:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.device(device).type == "cuda"
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(
            activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        t0 = time.monotonic()
        prof.start()
        try:
            time.sleep(seconds)
        finally:
            t_stop = time.monotonic()
            prof.stop()
        trace_s = time.monotonic() - t0  # the window and the profiler's stop
        stop_s = time.monotonic() - t_stop
        reg = get_registry()
        reg.counter("pfx_profiler_traces_total").inc()
        reg.gauge("pfx_profiler_trace_seconds").set(round(trace_s, 3))
        t_fold = time.monotonic()
        rows, device_us, host_us = op_summary_rows(prof, cuda)
        fold_s = time.monotonic() - t_fold
        if cuda and not rows:
            raise RuntimeError(
                f"the {trace_s:.2f}s capture on {device} recorded no device event (CUPTI "
                "traced nothing): no op table"
            )
        total_self = sum(r["self_us"] for r in rows) or 1.0
        return {
            "seconds": round(trace_s, 3),
            "stop_s": round(stop_s, 3),
            "fold_s": round(fold_s, 3),
            "trace_dir": log_dir,
            "source": "cuda" if cuda else "cpu",
            "device_us": round(device_us, 1),
            "host_us": round(host_us, 1),
            "op_count": len(rows),
            "top_ops": [{**r, "self_frac": round(r["self_us"] / total_self, 4)}
                        for r in rows[: max(0, int(top))]],
        }
    finally:
        _CAPTURE_LOCK.release()
