"""Deep-dive tracing: per-request trace timelines, a bounded sampled trace
buffer, a Chrome-trace / Perfetto exporter and the decision-log replay.

Counterpart of the whole of ``paddlefleetx_tpu/utils/tracing.py``
(``clock_anchor:119``, ``mono_to_epoch:133``, the process identity
``:155-168``, ``TraceContext:174``, ``TraceBuffer:333``, the trace headers
and ``remote_parent`` ``:441-484``, ``span_summary:501``,
``parse_span_summaries:558``, ``attach_request_trace:572``,
``discard_request_trace:600``, ``chrome_trace:629``,
``export_chrome_trace:708``, ``replay_decision_log:730``):

  - :class:`TraceContext`: one traced unit of work (a served request): a
    ``trace_id`` and a list of spans and instant events on the monotonic
    clock, stamped by the schedulers with the times they captured.
  - :class:`TraceBuffer`: the bounded, sampled store.
    ``PFX_TRACE_SAMPLE`` (0..1, default 1.0) samples with a deterministic
    accumulator (0.5 traces every other request); ``PFX_TRACE_CAP``
    (default 256) bounds the retained traces, oldest evicted.  At sample 0
    ``maybe_start`` returns None without a lock or a registry touch: the
    serving path then does no tracing work.
  - :func:`chrome_trace` / :func:`export_chrome_trace`: the traces as
    Chrome trace-event JSON (``ph="X"`` spans, microsecond ``ts`` / ``dur``
    on the wall clock through the process's one monotonic-to-epoch
    anchor), loadable in Perfetto; exports land under ``PFX_FLIGHT_DIR``.
  - :func:`span_summary` / :func:`parse_span_summaries` and the
    ``X-Trace-Id`` / ``X-Parent-Span`` propagation: the bounded envelope a
    traced inter-process hop returns, and the remote-parent binding that
    force-samples a hop's child trace.
  - :func:`replay_decision_log`: folds a ``ContinuousScheduler`` decision
    log back into the counters it must reproduce
    (``pfx_prefill_admits_total``, ``pfx_request_evictions_total``,
    ``pfx_spec_accepted_total``, the token ledger, the tenant counters).

Traces carry no prompt or token contents, only lengths, counts, slots and
timings, so ``/debug/trace`` and the exports can go to an operator.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.telemetry import (
    atomic_artifact_write,
    env_float,
    env_int,
    flight_dir,
    get_registry,
)


# events retained per trace (oldest dropped): request traces are
# naturally bounded by request length, but a long training fit appends
# one step_window span per logged window for its whole life — without a
# ring, a million-step run pins tens of MB on one context
TRACE_EVENT_CAP = 4096

# spans per cross-process summary (the X-Span-Summary response header):
# bounded so a long decode cannot grow an unbounded HTTP header — dense
# per-step instants aggregate first, then middle spans drop (first/last
# kept, `dropped` counted honestly)
SPAN_SUMMARY_CAP = 48
# per-name aggregation threshold inside a summary: more than this many
# events of one name (decode_chunk instants) collapse into ONE span
# covering their window, numeric args summed, `count` recorded
SPAN_AGG_THRESHOLD = 4


# ---------------------------------------------------------------------------
# wall-clock anchoring: ONE monotonic <-> epoch pair per process
# ---------------------------------------------------------------------------

_anchor_lock = threading.Lock()
_anchor: Optional[tuple] = None


def clock_anchor() -> tuple:
    """This process's ``(monotonic, epoch)`` anchor, captured ONCE at
    first use: every cross-process timestamp conversion in this process
    goes through the same pair, so the conversion is a constant offset
    (jitter between the two clock reads lands in the per-hop envelope
    bound, not in span-relative ordering)."""
    global _anchor
    if _anchor is None:
        with _anchor_lock:
            if _anchor is None:
                _anchor = (time.monotonic(), time.time())
    return _anchor


def mono_to_epoch(t: float) -> float:
    """Monotonic seconds -> epoch seconds through this process's anchor."""
    mono, epoch = clock_anchor()
    return float(t) - mono + epoch


def epoch_to_mono(t: float) -> float:
    """Epoch seconds -> this process's monotonic frame (the inverse of
    :func:`mono_to_epoch`; remote spans are stored in the LOCAL
    monotonic frame so timeline/export code paths stay uniform)."""
    mono, epoch = clock_anchor()
    return float(t) - epoch + mono


# ---------------------------------------------------------------------------
# process identity: who stamped a span (serving processes set replica
# id + role at boot; defaults keep single-process exports working)
# ---------------------------------------------------------------------------

_proc_identity: Dict[str, Any] = {}


def set_process_identity(**fields: Any) -> None:
    """Label this process's spans (``replica_id=``, ``role=``) for
    cross-process exports; the serve CLI calls it at boot."""
    _proc_identity.update({k: v for k, v in fields.items() if v})


def process_identity() -> Dict[str, Any]:
    """``{"pid", "replica_id"?, "role"?}`` — carried in span summaries
    and used to name Perfetto pid lanes."""
    return {"pid": os.getpid(), **_proc_identity}


def _proc_label(proc: Dict[str, Any]) -> str:
    rid = proc.get("replica_id") or f"pid {proc.get('pid', '?')}"
    role = proc.get("role")
    return f"{rid} ({role})" if role else str(rid)


class TraceContext:
    """One traced unit of work: ``trace_id`` + time-ordered spans and
    instant events on the monotonic clock.

    Events are plain dicts ``{"name", "ph", "t", "dur", "args"}`` with
    ``t``/``dur`` in monotonic SECONDS (the exporter converts to the
    Chrome trace format's microseconds).  ``ph`` is ``"X"`` (complete
    span) for phases and ``"i"``-style instants are stored as ``"X"``
    with ``dur=0`` so consumers parse exactly one event shape.  The
    event list is a bounded ring (``TRACE_EVENT_CAP``, newest kept) so
    no single long-lived trace grows without bound.

    Thread-safe: a request trace is stamped by the scheduler thread and
    finished by the HTTP handler thread."""

    __slots__ = ("trace_id", "name", "meta", "t0", "t_end", "_lock", "_events")

    def __init__(self, trace_id: str, name: str, t0: Optional[float] = None,
                 **meta: Any) -> None:
        self.trace_id = trace_id
        self.name = name
        self.meta = dict(meta)
        self.t0 = time.monotonic() if t0 is None else float(t0)
        self.t_end: Optional[float] = None
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=TRACE_EVENT_CAP)

    def event(self, name: str, t: Optional[float] = None, **args: Any) -> None:
        """Record an instant (zero-duration) event — a scheduler
        decision, a decode chunk's commit counts, the respond stamp."""
        self.span(name, t0=t, t1=t, **args)

    def span(self, name: str, t0: Optional[float] = None,
             t1: Optional[float] = None, **args: Any) -> None:
        """Record a completed span [t0, t1] (monotonic seconds; ``None``
        means "now").  Negative durations are clamped to 0 — injected
        stamps may quantize, and the exporter promises non-negative
        ``dur``."""
        now = time.monotonic()
        a = now if t0 is None else float(t0)
        b = now if t1 is None else float(t1)
        ev = {
            "name": name,
            "ph": "X",
            "t": a,
            "dur": max(0.0, b - a),
            "args": args,
        }
        with self._lock:
            self._events.append(ev)

    def add_remote_summary(self, summary: Dict[str, Any],
                           t_send: float, t_recv: float) -> float:
        """Stitch one hop's span summary (:func:`span_summary`, parsed
        off the callee's ``X-Span-Summary`` response header) into this
        trace, applying THE SKEW RULE: the hop's anchored spans are
        converted into this process's monotonic frame and then shifted
        by the minimal constant that pulls the whole hop window inside
        the ``[t_send, t_recv]`` request/response envelope observed on
        THIS process's clock — per-hop skew is bounded by the envelope,
        and relative order within the hop is preserved.  Returns the
        applied skew in seconds (0.0 for well-synced clocks).

        Each remote span lands as an event carrying the hop process's
        ``pid``/``proc`` identity, so the exporter gives every process
        its own Perfetto lane; an enclosing hop bar (named after the
        remote process) is added for valid nesting in that lane."""
        proc = dict(summary.get("proc") or {})
        spans = list(summary.get("spans") or [])[:SPAN_SUMMARY_CAP]
        if not spans:
            return 0.0
        local = []
        for s in spans:
            t0 = epoch_to_mono(float(s.get("t0", 0.0)))
            dur = max(0.0, float(s.get("dur", 0.0)))
            local.append((t0, dur, s))
        w0 = min(t0 for t0, _, _ in local)
        w1 = max(t0 + dur for t0, dur, _ in local)
        skew = 0.0
        if w0 < t_send:
            skew = t_send - w0
        elif w1 > t_recv:
            # shift back, but never past the send stamp: a hop window
            # wider than its own envelope (should not happen — the hop
            # ran inside it) pins to the send edge rather than lying
            # about the request's start
            skew = max(t_send - w0, t_recv - w1)
        pid = proc.get("pid")
        label = _proc_label(proc)
        bar = {
            "name": label, "ph": "X",
            "t": w0 + skew, "dur": max(0.0, w1 - w0),
            "args": {
                "trace_id": summary.get("trace_id"),
                "skew_s": round(skew, 6),
                "dropped": int(summary.get("dropped", 0)),
            },
            "pid": pid, "proc": proc,
        }
        evs = [bar]
        for t0, dur, s in local:
            evs.append({
                "name": str(s.get("name", "?")), "ph": "X",
                "t": t0 + skew, "dur": dur,
                "args": dict(s.get("args") or {}),
                "pid": pid, "proc": proc,
            })
        with self._lock:
            self._events.extend(evs)
        return skew

    def finish(self, t: Optional[float] = None) -> None:
        """Stamp the end of the whole trace (idempotent: first wins)."""
        with self._lock:
            if self.t_end is None:
                self.t_end = time.monotonic() if t is None else float(t)

    def events(self) -> List[Dict[str, Any]]:
        """Time-ordered copies of the recorded events."""
        with self._lock:
            evs = [dict(e) for e in self._events]
        evs.sort(key=lambda e: (e["t"], -e["dur"]))
        return evs

    def total_s(self) -> float:
        end = self.t_end
        if end is None:
            with self._lock:
                end = max(
                    [e["t"] + e["dur"] for e in self._events], default=self.t0
                )
        return max(0.0, end - self.t0)

    def timeline(self) -> Dict[str, Any]:
        """The offline-reconstruction view (`GET /debug/trace?id=`):
        start-relative phase rows, newest last.  Carries no prompt/token
        contents — only names, counts, and timings."""
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "meta": dict(self.meta),
            "total_s": round(self.total_s(), 6),
            "done": self.t_end is not None,
            "events": [
                {
                    "name": e["name"],
                    "at_s": round(e["t"] - self.t0, 6),
                    "dur_s": round(e["dur"], 6),
                    "args": e["args"],
                    # stitched remote spans name their process; local
                    # events omit the key (the common single-process
                    # timeline shape is unchanged)
                    **({"proc": e["proc"]} if e.get("proc") else {}),
                }
                for e in self.events()
            ],
        }


class TraceBuffer:
    """Bounded, sampled, in-memory trace store (process-wide via
    :func:`get_trace_buffer`; tests may build private instances).

    Sampling is a deterministic accumulator — ``sample=1.0`` traces
    everything, ``0.5`` every other request, ``0`` disables tracing
    entirely (``maybe_start`` returns None without taking this buffer's
    lock or touching the registry: the acceptance contract is that the
    serving hot path does zero tracing work at sample 0)."""

    def __init__(self, sample: Optional[float] = None,
                 cap: Optional[int] = None) -> None:
        self.sample = (
            env_float("PFX_TRACE_SAMPLE", 1.0) if sample is None
            else float(sample)
        )
        if not 0.0 <= self.sample <= 1.0:
            raise ValueError(
                f"PFX_TRACE_SAMPLE={self.sample} must be within [0, 1]"
            )
        self.cap = cap if cap is not None else env_int("PFX_TRACE_CAP", 256)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, TraceContext]" = OrderedDict()
        self._acc = 0.0
        self._seq = 0
        self._sampled_counter = None  # lazy registry child

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    def _start_locked(self, name: str, t0: Optional[float],
                      meta: Dict[str, Any]) -> TraceContext:
        # caller holds self._lock
        self._seq += 1
        trace_id = f"{os.getpid():x}-{self._seq:08x}"
        tc = TraceContext(trace_id, name, t0=t0, **meta)
        self._traces[trace_id] = tc
        while len(self._traces) > self.cap:
            self._traces.popitem(last=False)  # evict oldest
        return tc

    def _count_sampled(self) -> None:
        counter = self._sampled_counter
        if counter is None:
            counter = get_registry().counter("pfx_trace_sampled_total")
            self._sampled_counter = counter
        counter.inc()

    def maybe_start(self, name: str, t0: Optional[float] = None,
                    **meta: Any) -> Optional[TraceContext]:
        """Start a trace if the sampler picks this request; None
        otherwise.  The fast path at sample=0 is a single float compare."""
        if self.sample <= 0.0:
            return None
        with self._lock:
            self._acc += self.sample
            if self._acc < 1.0:
                return None
            self._acc -= 1.0
            tc = self._start_locked(name, t0, meta)
        self._count_sampled()
        return tc

    def start(self, name: str, t0: Optional[float] = None,
              **meta: Any) -> Optional[TraceContext]:
        """Start a trace UNCONDITIONALLY (bypassing the sampling
        accumulator) — the remote-parent path: a request that arrived
        carrying ``X-Trace-Id`` is already part of a sampled timeline
        at its caller, and losing the child leg to this process's own
        sampler would leave a hole in every stitched trace.  Still None
        when tracing is disabled outright (sample=0: the zero-work
        contract wins over stitching)."""
        if self.sample <= 0.0:
            return None
        with self._lock:
            tc = self._start_locked(name, t0, meta)
        self._count_sampled()
        return tc

    def get(self, trace_id: str) -> Optional[TraceContext]:
        with self._lock:
            return self._traces.get(trace_id)

    def discard(self, trace_id: str) -> None:
        """Drop a trace that never became a unit of work (an admission
        that was rejected after sampling) so the retained window holds
        only real timelines."""
        with self._lock:
            self._traces.pop(trace_id, None)

    def traces(self) -> List[TraceContext]:
        """Oldest-first snapshot of the retained window."""
        with self._lock:
            return list(self._traces.values())


# ---------------------------------------------------------------------------
# cross-process propagation: request headers + the remote-parent binding
# ---------------------------------------------------------------------------

TRACE_ID_HEADER = "X-Trace-Id"
PARENT_SPAN_HEADER = "X-Parent-Span"
SPAN_SUMMARY_HEADER = "X-Span-Summary"

_remote_tls = threading.local()


def outbound_trace_headers(trace, span: str) -> Dict[str, str]:
    """Request headers for one inter-process hop: the caller's trace id
    plus the hop name the callee's spans nest under.  Empty when the
    request is untraced (the callee then applies its own sampler)."""
    if trace is None:
        return {}
    return {TRACE_ID_HEADER: trace.trace_id, PARENT_SPAN_HEADER: str(span)}


def remote_parent_from_headers(headers: Any) -> Optional[Dict[str, str]]:
    """Parse the propagation headers off an incoming request (any
    ``.get()``-able mapping); None when the hop is untraced."""
    tid = str((headers.get(TRACE_ID_HEADER) if headers is not None else "")
              or "").strip()
    if not tid:
        return None
    return {
        "trace_id": tid,
        "span": str(headers.get(PARENT_SPAN_HEADER) or "").strip(),
    }


class remote_parent:
    """Bind an incoming hop's parent identity for the duration of the
    ``submit`` call (thread-local; the HTTP handler submits on its own
    thread, synchronously): ``attach_request_trace`` then FORCE-samples
    the trace and records the parent ids.  ``parent=None`` is a no-op
    so call sites stay unconditional."""

    def __init__(self, parent: Optional[Dict[str, str]]) -> None:
        self._parent = parent

    def __enter__(self) -> "remote_parent":
        if self._parent is not None:
            self._prev = getattr(_remote_tls, "parent", None)
            _remote_tls.parent = self._parent
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._parent is not None:
            _remote_tls.parent = self._prev


def current_remote_parent() -> Optional[Dict[str, str]]:
    return getattr(_remote_tls, "parent", None)


def _scalar_args(args: Dict[str, Any]) -> Dict[str, Any]:
    """Counts/timings only (the redaction contract, applied again at
    the process boundary): keep numeric/bool/short-string values, drop
    anything structured."""
    out = {}
    for k, v in args.items():
        if isinstance(v, bool) or isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, str) and len(v) <= 64:
            out[k] = v
    return out


def span_summary(trace: TraceContext,
                 cap: int = SPAN_SUMMARY_CAP) -> Dict[str, Any]:
    """Render a trace as the bounded cross-process envelope a replica
    returns in its ``X-Span-Summary`` response header: spans on the
    wall-clock axis (epoch seconds through this process's anchor), this
    process's identity, scalar args only.  Dense repeated instants (one
    ``decode_chunk`` per iteration) aggregate into one span with their
    numeric args summed and ``count`` recorded; past ``cap`` spans the
    middle drops (first/last kept) and ``dropped`` says how many."""
    evs = [e for e in trace.events() if not e.get("proc")]
    by_name: Dict[str, int] = {}
    for e in evs:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    agg: Dict[str, Dict[str, Any]] = {}
    spans: List[Dict[str, Any]] = []
    for e in evs:
        name = e["name"]
        if by_name[name] > SPAN_AGG_THRESHOLD:
            a = agg.get(name)
            if a is None:
                a = agg[name] = {
                    "name": name, "t0": e["t"], "end": e["t"] + e["dur"],
                    "args": {"count": 0},
                }
                spans.append(a)
            a["t0"] = min(a["t0"], e["t"])
            a["end"] = max(a["end"], e["t"] + e["dur"])
            a["args"]["count"] += 1
            for k, v in e["args"].items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                a["args"][k] = a["args"].get(k, 0) + v
        else:
            spans.append({
                "name": name, "t0": e["t"], "end": e["t"] + e["dur"],
                "args": _scalar_args(e["args"]),
            })
    dropped = 0
    if len(spans) > cap:
        dropped = len(spans) - cap
        spans = spans[:cap - 1] + [spans[-1]]
    return {
        "trace_id": trace.trace_id,
        "proc": process_identity(),
        "spans": [
            {
                "name": s["name"],
                "t0": round(mono_to_epoch(s["t0"]), 6),
                "dur": round(max(0.0, s["end"] - s["t0"]), 6),
                "args": s["args"],
            }
            for s in spans
        ],
        "dropped": dropped,
    }


def parse_span_summaries(raw: str) -> List[Dict[str, Any]]:
    """Parse an ``X-Span-Summary`` header value (a JSON LIST of
    summaries — a relay hop appends its own to the ones it carried).
    Malformed input returns [] (a broken header must never fail the
    request it rode on)."""
    try:
        doc = json.loads(raw)
    except (ValueError, TypeError):
        return []
    if isinstance(doc, dict):
        doc = [doc]
    return [s for s in doc if isinstance(s, dict)] if isinstance(doc, list) else []


def attach_request_trace(future, *, t0: float, scheduler: str,
                         prompts: int, max_new: int) -> None:
    """THE scheduler-side request-trace attach recipe (both
    `RequestQueue.submit` and `ContinuousScheduler.submit` use it, so
    the admission-event shape cannot drift between schedulers): sample
    a trace, hang it on the future BEFORE the entry becomes visible to
    the scheduler thread, stamp the admission instant.  No-op when
    sampled out.

    A request that arrived on a traced inter-process hop (the handler
    bound :class:`remote_parent` around submit) is FORCE-sampled with
    the parent ids on its meta — the caller's stitched timeline must
    not lose this leg to the local sampler."""
    parent = current_remote_parent()
    buf = get_trace_buffer()
    if parent is not None:
        tr = buf.start(
            "request", t0=t0, scheduler=scheduler,
            parent_trace=parent["trace_id"],
            parent_span=parent.get("span", ""),
        )
    else:
        tr = buf.maybe_start("request", t0=t0, scheduler=scheduler)
    if tr is not None:
        future.trace = tr
        tr.event("admission", t=t0, prompts=prompts, max_new=max_new)


def discard_request_trace(future) -> None:
    """Undo :func:`attach_request_trace` for an admission that was
    REJECTED (QueueFull/QueueClosed): the trace never became a unit of
    work and must not sit in the sampled window as an empty timeline."""
    tr = getattr(future, "trace", None)
    if tr is not None:
        future.trace = None
        get_trace_buffer().discard(tr.trace_id)


_buffer: Optional[TraceBuffer] = None
_buffer_lock = threading.Lock()


def get_trace_buffer() -> TraceBuffer:
    """The process-wide trace buffer (knobs read at first use)."""
    global _buffer
    if _buffer is None:
        with _buffer_lock:
            if _buffer is None:
                _buffer = TraceBuffer()
    return _buffer


# ---------------------------------------------------------------------------
# Chrome trace-event / Perfetto export
# ---------------------------------------------------------------------------


def chrome_trace(traces: List[TraceContext]) -> Dict[str, Any]:
    """Render traces as a Chrome trace-event document (Perfetto- and
    chrome://tracing-loadable).  Every event is a ``ph="X"`` complete
    span carrying ``ts``/``dur`` in microseconds, ``pid`` (the process
    that stamped it — stitched remote spans keep their own pid, so each
    process gets its own Perfetto lane), ``tid`` (one lane per trace),
    and ``name``; each trace additionally gets an enclosing span named
    after the trace so the phase rows nest under one bar per request.

    WALL-CLOCK ANCHORED: ``ts`` is epoch microseconds through this
    process's :func:`clock_anchor`, not raw monotonic — two processes'
    exports (or one stitched export) overlay on one comparable axis.
    Monotonic exports could never be overlaid at all (each process's
    zero is its own boot).  ``ph="M"`` ``process_name`` metadata rows
    label the pid lanes."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    proc_names: Dict[int, str] = {pid: _proc_label(process_identity())}
    for tid, tc in enumerate(traces, start=1):
        # ONE event-list snapshot per trace, and the enclosing bar's end
        # derived from that SAME snapshot: an in-flight trace (scraped
        # mid-decode) may grow concurrently, and re-reading the live
        # events per child would let a just-appended child overhang the
        # already-computed bar — the partial overlap the nesting
        # contract forbids
        evs = tc.events()
        t_end = tc.t_end
        if t_end is None:
            t_end = max([e["t"] + e["dur"] for e in evs], default=tc.t0)
        bar_end = max(tc.t0, t_end)
        bar_ts = round(mono_to_epoch(tc.t0) * 1e6, 3)
        bar_dur = round((bar_end - tc.t0) * 1e6, 3)
        events.append({
            "ph": "X",
            "ts": bar_ts,
            "dur": bar_dur,
            "pid": pid,
            "tid": tid,
            "name": tc.name,
            "cat": "trace",
            "args": {"trace_id": tc.trace_id, **tc.meta},
        })
        for ev in evs:
            # clamp children into the enclosing bar so nesting stays
            # valid even when a stamp lands after finish()
            t0 = max(tc.t0, ev["t"])
            dur = min(ev["dur"], max(0.0, bar_end - t0))
            ev_pid = ev.get("pid") or pid
            if ev_pid not in proc_names and ev.get("proc"):
                proc_names[ev_pid] = _proc_label(ev["proc"])
            # SECOND clamp, in the ROUNDED domain: epoch-anchored ts is
            # ~2^50 us, where one float64 ulp is 0.25 us and round(x, 3)
            # can no longer move a value — independently rounded child
            # endpoints can overshoot the bar by a few ulps (the nesting
            # flake under contended laps).  Clamping the exported
            # numbers themselves keeps the document's nesting exact
            # instead of merely within float error.
            ts_c = max(round(mono_to_epoch(t0) * 1e6, 3), bar_ts)
            dur_c = max(
                0.0, min(round(dur * 1e6, 3), bar_ts + bar_dur - ts_c)
            )
            events.append({
                "ph": "X",
                "ts": ts_c,
                "dur": dur_c,
                "pid": ev_pid,
                "tid": tid,
                "name": ev["name"],
                "cat": tc.name,
                "args": dict(ev["args"]),
            })
    meta = [
        {"ph": "M", "pid": p, "tid": 0, "name": "process_name",
         "args": {"name": label}}
        for p, label in sorted(proc_names.items())
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: Optional[str] = None,
                        buffer: Optional[TraceBuffer] = None) -> Optional[str]:
    """Write the buffer's retained window as Chrome-trace JSON.  Default
    path: ``<PFX_FLIGHT_DIR>/trace.json`` (next to the flight-recorder
    dumps).  Atomic write; returns the path, or None on failure (logged,
    never raised — callers include crash/debug paths)."""
    buf = buffer if buffer is not None else get_trace_buffer()
    path = path or os.path.join(flight_dir(), "trace.json")
    doc = chrome_trace(buf.traces())
    if not atomic_artifact_write(path, lambda f: json.dump(doc, f)):
        return None
    logger.info(
        f"trace export: {len(doc['traceEvents'])} event(s) to {path}"
    )
    return path


# ---------------------------------------------------------------------------
# decision-log replay
# ---------------------------------------------------------------------------


def replay_decision_log(rows) -> Dict[str, Any]:
    """Fold ContinuousScheduler decision-log rows back into the counters
    they must reproduce.  The agreement contract (tested): on a run whose
    log was not truncated, ``prefill_admits`` == pfx_prefill_admits_total,
    ``evictions`` == pfx_request_evictions_total, ``spec_accepted`` ==
    pfx_spec_accepted_total, ``prefix_hits`` == pfx_prefix_hits_total,
    the spill/migration quartet ``spills`` / ``readmits`` /
    ``spill_discards`` / ``migrate_adopted`` == pfx_prefix_spills_total
    / pfx_prefix_readmits_total / pfx_prefix_spill_discards_total /
    pfx_migrate_adopted_total, and the tenancy trio: ``preempted`` and
    per-label ``preempted_tenants`` == pfx_tenant_preemptions_total,
    per-label ``tenants`` == pfx_tenant_admitted_total — a trace event
    silently dropped by the scheduler shows up here as a mismatch."""
    out: Dict[str, Any] = {
        "iterations": 0,
        "prefill_admits": 0,
        "evictions": 0,
        "shed": 0,
        "finished": 0,
        "spec_proposed": 0,
        "spec_accepted": 0,
        "prefix_hits": 0,
        "prefix_hit_tokens": 0,
        "prefix_evictions": 0,
        "chunks": 0,
        "spills": 0,
        "readmits": 0,
        "spill_discards": 0,
        "migrate_adopted": 0,
        "preempted": 0,
        "tok_admitted": 0,
        "tok_delivered": 0,
        "tok_evicted_lost": 0,
        "tok_preempt_refunded": 0,
        "tok_shed_after_admit": 0,
        "tenants": {},
        "preempted_tenants": {},
    }
    for row in rows:
        out["iterations"] += 1
        out["prefill_admits"] += int(row.get("admitted", 0))
        out["evictions"] += int(row.get("evicted", 0))
        out["shed"] += int(row.get("shed", 0))
        out["finished"] += int(row.get("finished", 0))
        out["spec_proposed"] += int(row.get("spec_proposed", 0))
        out["spec_accepted"] += int(row.get("spec_accepted", 0))
        out["prefix_hits"] += int(row.get("prefix_hits", 0))
        out["prefix_hit_tokens"] += int(row.get("prefix_hit_tokens", 0))
        out["prefix_evictions"] += int(row.get("prefix_evictions", 0))
        out["chunks"] += int(row.get("chunks", 0))
        out["spills"] += int(row.get("spills", 0))
        out["readmits"] += int(row.get("readmits", 0))
        out["spill_discards"] += int(row.get("spill_discards", 0))
        out["migrate_adopted"] += int(row.get("migrate_adopted", 0))
        out["preempted"] += int(row.get("preempted", 0))
        # token-ledger columns: folding an untruncated log reproduces
        # every pfx_token_ledger_total disposition exactly
        for key in ("tok_admitted", "tok_delivered", "tok_evicted_lost",
                    "tok_preempt_refunded", "tok_shed_after_admit"):
            out[key] += int(row.get(key, 0))
        for tn, n in (row.get("tenants") or {}).items():
            out["tenants"][tn] = out["tenants"].get(tn, 0) + int(n)
        for tn, n in (row.get("preempted_tenants") or {}).items():
            out["preempted_tenants"][tn] = (
                out["preempted_tenants"].get(tn, 0) + int(n)
            )
    return out
