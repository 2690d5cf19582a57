"""The process-wide metrics registry of the serving path, and model FLOPs
with the card's peak for the ``mfu`` column of the training records.

Counterpart of the registry of ``paddlefleetx_tpu/utils/telemetry.py``
(``Counter:312``, ``Gauge:336``, ``Histogram:345``, ``_Family:405``,
``Registry:427``, ``parse_exposition:604``, ``get_registry:687`` and the
``StatsView`` its serving classes count in):

  - **Registry**: thread-safe counters, gauges and histograms with
    labels.  Every name must be declared in ``METRICS`` (here: only the
    names the port emits, each with the JAX table's kind and help text;
    the registry raises on an undeclared name).  ``snapshot()`` returns
    one locked view and ``render_prometheus()`` renders that same view as
    Prometheus text, so ``/metrics`` and ``/healthz`` of the serve CLI
    are two renderings of one snapshot.
  - **StatsView**: a dict-like per-instance stats object (``stats["x"]
    += 1`` keeps working) whose numeric keys are exported onto the
    registry through a weakly held collector.
  - **MFU**: ``model_flops_per_token:859`` and ``peak_flops:899`` (the
    analytic ``6 * N`` per trained token, PaLM's MFU convention: no
    recompute extra, attention scores excluded).  The peak is the card's
    dense bf16 tensor-core rate, picked by ``torch.cuda.get_device_name``;
    ``PFX_PEAK_FLOPS`` overrides it.  On the CPU, or on a card the table
    does not know, there is no peak and the record carries no ``mfu``.

Not ported yet: ``SLOTracker``, ``Span`` and ``FlightRecorder``.  Metric
mutations never take the registry lock (each metric and collector owns
one), so the scheduler threads never contend with a scrape.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
import weakref
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from paddlefleetx_tpu_torch.utils.log import logger

# dense bf16 tensor-core FLOP/s by a substring of the device name (NVIDIA
# data sheets, SXM parts at their full power limit)
PEAK_FLOPS_BY_DEVICE_NAME: Dict[str, float] = {
    "h100": 989e12,
    "h200": 989e12,
}


def gpt_param_count(*, vocab_size: int, hidden_size: int, num_layers: int,
                    ffn_hidden_size: Optional[int] = None) -> int:
    """The matmul-bearing parameter count N of a GPT stack: the tied
    embedding once, per layer fused qkv, the output projection and the
    two MLP matmuls with biases, two LayerNorms, and the final LayerNorm;
    position embeddings excluded."""
    h = int(hidden_size)
    ffn = int(ffn_hidden_size or 4 * h)
    per_layer = (3 * h * h + 3 * h) + (h * h + h) + (h * ffn + ffn) + (ffn * h + h) + 4 * h
    return int(vocab_size) * h + int(num_layers) * per_layer + 2 * h


def model_flops_per_token(config: Any) -> Optional[float]:
    """``6 * N`` per trained token; None when the config lacks the GPT
    fields."""
    vocab = getattr(config, "vocab_size", None)
    hidden = getattr(config, "hidden_size", None)
    layers = getattr(config, "num_layers", None)
    if not vocab or not hidden or not layers:
        return None
    n = gpt_param_count(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                        ffn_hidden_size=getattr(config, "ffn_hidden_size", None))
    return float(6 * n)


def peak_flops(device: torch.device) -> Optional[float]:
    """Per-card peak FLOP/s: ``PFX_PEAK_FLOPS`` (> 0) if set, else the
    table's entry for the card's name, else None (on the CPU too)."""
    raw = os.environ.get("PFX_PEAK_FLOPS") or ""
    if raw.strip():
        try:
            val = float(raw)
        except ValueError:
            raise ValueError(f"PFX_PEAK_FLOPS={raw!r} is not a number; unset it or pass "
                             "FLOP/s") from None
        if val <= 0:
            raise ValueError(f"PFX_PEAK_FLOPS={raw!r} must be > 0")
        return val
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for sub, peak in PEAK_FLOPS_BY_DEVICE_NAME.items():
        if sub in name:
            return peak
    logger.warning(f"peak_flops: unknown card {name!r} and no PFX_PEAK_FLOPS set; mfu "
                   "left out of the metrics")
    return None

# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

# name -> (kind, help): the names the port emits, each exactly as the JAX
# package's METRICS table declares it (tests/test_torch_tenancy.py holds
# every entry against that table; no name here is new)
METRICS: Dict[str, Tuple[str, str]] = {
    "pfx_serving_requests_total": ("counter", "Completed generate_ids calls"),
    "pfx_serving_tokens_out_total": ("counter", "Generated tokens delivered"),
    "pfx_serving_gen_seconds_total": ("counter", "Wall seconds inside generate_ids"),
    "pfx_serving_gen_errors_total": ("counter", "Generation failures"),
    "pfx_serving_last_latency_seconds": ("gauge", "Latency of the most recent generate_ids call"),
    "pfx_serving_warmup_seconds_total": ("counter", "Seconds spent in warmup compiles"),
    "pfx_queue_submitted_total": ("counter", "Requests admitted"),
    "pfx_queue_completed_total": ("counter", "Requests answered"),
    "pfx_queue_batches_total": ("counter", "Runner batches executed"),
    "pfx_queue_coalesced_batches_total": ("counter", "Batches that merged >1 request"),
    "pfx_queue_coalesced_requests_total": ("counter", "Requests served via a coalesced batch"),
    "pfx_queue_shed_deadline_total": ("counter", "Requests shed at their deadline"),
    "pfx_queue_rejected_full_total": ("counter", "Admissions rejected: queue full"),
    "pfx_queue_rejected_closed_total": ("counter", "Admissions rejected: draining"),
    "pfx_queue_gen_errors_total": ("counter", "Runner batches that raised"),
    "pfx_queue_depth": ("gauge", "Requests waiting in the admission queue"),
    "pfx_queue_busy_seconds": ("gauge", "Seconds the current runner call has been executing"),
    "pfx_batch_occupancy": ("gauge", "Active rows / capacity of the continuous decode batch"),
    "pfx_kv_blocks_used": ("gauge", "Paged KV arena blocks allocated to live sequences"),
    "pfx_kv_blocks_free": ("gauge", "Paged KV arena blocks available"),
    "pfx_kv_blocks_available": ("gauge", "Arena blocks admissible right now: free plus reclaimable cached-prefix blocks (the decode-pool scale signal)"),
    "pfx_request_evictions_total": ("counter", "Rows evicted mid-decode (deadline shed frees their blocks)"),
    "pfx_prefill_admits_total": ("counter", "Rows admitted into the running batch (prefill-on-admit)"),
    "pfx_spec_proposed_total": ("counter", "Draft tokens proposed to the speculative verify step"),
    "pfx_spec_accepted_total": ("counter", "Draft tokens accepted and committed by the verify step"),
    "pfx_spec_accept_rate": ("gauge", "Lifetime accepted/proposed draft ratio"),
    "pfx_prefix_hits_total": ("counter", "Admissions that reused cached prefix blocks"),
    "pfx_prefix_misses_total": ("counter", "Admissions that found no cached prefix (cache enabled)"),
    "pfx_prefix_hit_tokens_total": ("counter", "Prompt tokens whose KV was reused instead of recomputed"),
    "pfx_prefix_evictions_total": ("counter", "Cached prefix blocks evicted (LRU budget or allocation pressure)"),
    "pfx_prefix_cached_blocks": ("gauge", "Arena blocks currently pinned by the prefix index"),
    "pfx_prefill_chunks_total": ("counter", "Chunked-prefill dispatches (one prompt chunk per scheduler iteration)"),
    "pfx_prefix_spill_bytes": ("gauge", "Host-RAM bytes held by spilled prefix blocks (--prefix-spill-bytes tier)"),
    "pfx_prefix_spill_entries": ("gauge", "Prefix blocks currently resident in the host-RAM spill store"),
    "pfx_prefix_spills_total": ("counter", "Evicted prefix blocks demoted to the host-RAM spill store"),
    "pfx_prefix_readmits_total": ("counter", "Spilled prefix blocks promoted back into the arena on a prefix match"),
    "pfx_prefix_spill_discards_total": ("counter", "Spilled entries lost instead of readmitted (checksum/corruption, budget pressure, failed spill or readmit) — the graceful-degradation counter"),
    "pfx_http_requests_in_flight": ("gauge", "In-flight /generate requests"),
    "pfx_http_responses_total": ("counter", "HTTP responses by status code"),
    "pfx_http_client_gone_total": ("counter", "Responses lost to client disconnects"),
    "pfx_request_latency_seconds": ("histogram", "End-to-end /generate latency"),
    "pfx_request_ttft_seconds": ("histogram", "Time to first token (request receipt to first flush; non-streamed: decode done)"),
    "pfx_request_itl_seconds": ("histogram", "Inter-token latency: gap between consecutive streamed token flushes"),
    "pfx_serve_draining": ("gauge", "1 while the server drains for shutdown"),
    "pfx_tenant_admitted_total": ("counter", "Rows admitted by the weighted-fair scheduler pull (labels: tenant)"),
    "pfx_tenant_preemptions_total": ("counter", "Active rows preempted mid-decode by a higher-priority arrival and requeued as re-prefill continuations (labels: tenant = the victim's)"),
    "pfx_tenant_queue_depth": ("gauge", "Entries waiting in the scheduler's admission queue per tenant (labels: tenant)"),
    "pfx_tenant_ttft_seconds": ("histogram", "Time to first token per tenant (labels: tenant)"),
}

# latency-shaped default buckets (seconds): sub-ms to minutes, exponential-ish
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)
# reservoir per histogram child: enough for stable p50/p99 on /healthz
# without unbounded memory
_RESERVOIR = 256


# ---------------------------------------------------------------------------
# metric children
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter.  ``set()`` exists for exporter-style cumulative
    imports (a loader's own ``data_wait_s`` total pushed as-is) and must
    only ever be called with non-decreasing values."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def get(self) -> float:
        with self._lock:
            return self._value


class Gauge(Counter):
    """Settable instantaneous value; ``add()`` for in-flight up/downs."""

    __slots__ = ()

    def add(self, v: float) -> None:
        self.inc(v)


class Histogram:
    """Cumulative-bucket histogram + a bounded reservoir for percentiles.

    Buckets render in Prometheus ``_bucket{le=...}`` form; the reservoir
    (last ``_RESERVOIR`` observations) feeds ``percentile()`` for the
    /healthz p50/p99 fields without a full-series store."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_reservoir", "_lock")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._reservoir: deque = deque(maxlen=_RESERVOIR)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            self._reservoir.append(v)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir (0.0 when empty)."""
        with self._lock:
            vals = sorted(self._reservoir)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
        return vals[idx]

    def state(self) -> Dict[str, Any]:
        with self._lock:
            cum, total = [], 0
            for c in self._counts:
                total += c
                cum.append(total)
            vals = sorted(self._reservoir)
            sum_ = self._sum

        def pct(q: float) -> float:
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]

        return {
            "buckets": list(zip(self.buckets, cum[:-1])),
            "count": cum[-1],
            "sum": sum_,
            "p50": pct(0.50),
            "p99": pct(0.99),
        }


class _Family:
    """One declared metric: kind + per-labelset children."""

    __slots__ = ("name", "kind", "help", "buckets", "children")

    def __init__(self, name: str, kind: str, help_: str, buckets=None) -> None:
        self.name = name
        self.kind = kind
        self.help = help_
        self.buckets = buckets
        self.children: Dict[Tuple[Tuple[str, str], ...], Any] = OrderedDict()


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class Registry:
    """Process-wide metric registry.  One instance per process in
    production (``get_registry()``); tests may build private instances
    for absolute-count isolation."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = OrderedDict()
        self._collectors: List[weakref.ref] = []

    # -- declaration-checked accessors ---------------------------------
    def _family(self, name: str, kind: str, buckets=None) -> _Family:
        declared = METRICS.get(name)
        if declared is None or declared[0] != kind:
            raise ValueError(
                f"metric {name!r} ({kind}) is not declared in "
                "telemetry.METRICS — every emitted name must be declared "
                "there, as the JAX package's table declares it"
            )
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, declared[1], buckets)
                self._families[name] = fam
            return fam

    def _child(self, name: str, kind: str, labels: Dict[str, str], buckets=None):
        fam = self._family(name, kind, buckets)
        key = _label_key(labels)
        with self._lock:
            child = fam.children.get(key)
            if child is None:
                if kind == "histogram":
                    child = Histogram(fam.buckets or DEFAULT_BUCKETS)
                elif kind == "gauge":
                    child = Gauge()
                else:
                    child = Counter()
                fam.children[key] = child
            return child

    def counter(self, name: str, **labels: str) -> Counter:
        return self._child(name, "counter", labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._child(name, "gauge", labels)

    def histogram(self, name: str, buckets: Optional[Tuple[float, ...]] = None,
                  **labels: str) -> Histogram:
        return self._child(name, "histogram", labels, buckets)

    # -- collectors -----------------------------------------------------
    def register_collector(self, obj: Any) -> None:
        """Register an object with a ``collect() -> iterable of
        (metric_name, labels_dict, value)`` method.  Held by WEAK
        reference: a dead GenerationServer or scheduler silently drops
        out of the snapshot instead of reporting stale values forever."""
        names = {n for n, _, _ in obj.collect()}
        for n in names:
            if n not in METRICS:
                raise ValueError(
                    f"collector exports undeclared metric {n!r}; declare "
                    "it in telemetry.METRICS"
                )
        with self._lock:
            self._collectors.append(weakref.ref(obj))

    # -- snapshot + exposition -----------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """ONE consistent view of every metric: owned children plus live
        collectors, read under the registry lock.  Counters from multiple
        collectors of the same name sum (process-wide total); gauges are
        last-writer-wins.  Shape::

            {name: {"kind": ..., "help": ...,
                    "values": [(labels_dict, value)], ...}}

        histogram entries instead carry ``buckets``/``count``/``sum``/
        ``p50``/``p99`` per labelset.
        """
        snap: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for name, fam in self._families.items():
                entry = {"kind": fam.kind, "help": fam.help, "values": []}
                for key, child in fam.children.items():
                    labels = dict(key)
                    if fam.kind == "histogram":
                        entry["values"].append((labels, child.state()))
                    else:
                        entry["values"].append((labels, child.get()))
                snap[name] = entry
            live = []
            for ref in self._collectors:
                obj = ref()
                if obj is None:
                    continue
                live.append(ref)
                for name, labels, value in obj.collect():
                    kind, help_ = METRICS[name]
                    entry = snap.setdefault(
                        name, {"kind": kind, "help": help_, "values": []}
                    )
                    labels = dict(labels or {})
                    for i, (lab, old) in enumerate(entry["values"]):
                        if lab == labels:
                            entry["values"][i] = (
                                lab,
                                old + value if kind == "counter" else value,
                            )
                            break
                    else:
                        entry["values"].append((labels, float(value)))
            self._collectors[:] = live
        return snap

    def render_prometheus(self, snap: Optional[Dict[str, Dict[str, Any]]] = None) -> str:
        """Prometheus text exposition (format 0.0.4) of a snapshot —
        pass the snapshot a ``/healthz`` view was built from to guarantee
        the two endpoints agree."""
        snap = snap if snap is not None else self.snapshot()
        lines: List[str] = []
        for name in sorted(snap):
            entry = snap[name]
            lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {entry['kind']}")
            for labels, value in entry["values"]:
                lstr = _render_labels(labels)
                if entry["kind"] == "histogram":
                    extra = dict(labels)
                    for le, cum in value["buckets"]:
                        bl = _render_labels({**extra, "le": _fmt(le)})
                        lines.append(f"{name}_bucket{bl} {cum}")
                    bl = _render_labels({**extra, "le": "+Inf"})
                    lines.append(f"{name}_bucket{bl} {value['count']}")
                    lines.append(f"{name}_sum{lstr} {_fmt(value['sum'])}")
                    lines.append(f"{name}_count{lstr} {value['count']}")
                else:
                    lines.append(f"{name}{lstr} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def value(self, name: str, default: Any = 0.0,
              snap: Optional[Dict[str, Dict[str, Any]]] = None,
              **labels: str) -> Any:
        """Convenience read of one metric value — a counter/gauge float,
        or a histogram's state dict.  Pass ``snap`` to read out of an
        already-taken snapshot (tools/serve.py renders /healthz and
        /metrics from ONE snapshot so the endpoints agree)."""
        entry = (snap if snap is not None else self.snapshot()).get(name)
        if not entry:
            return default
        want = {str(k): str(v) for k, v in labels.items()}
        for lab, val in entry["values"]:
            if lab == want:
                return val
        return default

    def reset(self) -> None:
        """Drop every family and collector (test isolation only)."""
        with self._lock:
            self._families.clear()
            self._collectors.clear()


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


_SAMPLE_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?\s+(?P<value>[^\s]+)\s*$"
)
_LABEL_PAIR_RE = re.compile(r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"\s*$')


def parse_exposition(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse Prometheus text exposition into ``(name, labels, value)``
    sample rows, order preserved.  Tolerant the way a scraper must be: comment and
    blank lines skip, a malformed sample line skips (counted into the
    scrape outcome by the caller via the returned rows being fewer, not
    by raising mid-scrape), label escapes (\\\\, \\", \\n) unescape."""
    rows: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_LINE_RE.match(line)
        if not m:
            continue
        labels: Dict[str, str] = {}
        raw = (m.group("labels") or "{}")[1:-1]
        ok = True
        for part in _split_label_pairs(raw):
            lm = _LABEL_PAIR_RE.match(part)
            if not lm:
                ok = False
                break
            # single left-to-right pass: sequential .replace calls
            # would corrupt values containing literal backslashes
            # (\\n must decode to backslash+n, not newline)
            labels[lm.group("k")] = re.sub(
                r"\\(.)",
                lambda m: {"n": "\n"}.get(m.group(1), m.group(1)),
                lm.group("v"),
            )
        if not ok:
            continue
        try:
            val = float(m.group("value").replace("+Inf", "inf")
                        .replace("Inf", "inf"))
        except ValueError:
            continue
        rows.append((m.group("name"), labels, val))
    return rows


def _split_label_pairs(raw: str) -> List[str]:
    """Split ``k="v",k2="v2"`` on commas OUTSIDE quoted values."""
    if not raw.strip():
        return []
    parts, buf, in_q, esc = [], [], False, False
    for ch in raw:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            buf.append(ch)
            continue
        if ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return parts


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


_registry = Registry()


def get_registry() -> Registry:
    """The process-wide default registry."""
    return _registry


# ---------------------------------------------------------------------------
# StatsView: dict-like per-instance stats exported via a collector
# ---------------------------------------------------------------------------


class StatsView:
    """Per-instance stats with the old hand-rolled-dict interface
    (``stats["requests"] += 1``, ``dict(stats)``, ``**stats``) whose
    numeric keys are ALSO exported onto the registry.

    ``exported`` maps dict key -> declared metric name; keys mapped to
    ``None`` (and any key assigned later, e.g. ``warmup_s``/``last_error``)
    stay instance-local.  The registry holds only a weak reference, so a
    test-scoped server's counters vanish with it."""

    def __init__(
        self,
        exported: Dict[str, Optional[str]],
        init: Optional[Dict[str, Any]] = None,
        registry: Optional[Registry] = None,
    ) -> None:
        self._exported = dict(exported)
        self._lock = threading.Lock()
        self._vals: Dict[str, Any] = {k: 0 for k in exported}
        if init:
            self._vals.update(init)
        (registry or get_registry()).register_collector(self)

    # collector protocol
    def collect(self) -> List[Tuple[str, Dict[str, str], float]]:
        with self._lock:
            return [
                (metric, {}, float(self._vals[key]))
                for key, metric in self._exported.items()
                if metric is not None
                and isinstance(self._vals.get(key), (int, float))
                and not isinstance(self._vals.get(key), bool)
            ]

    # mapping protocol (enough for dict(view), **view, view.items())
    def __getitem__(self, key: str) -> Any:
        with self._lock:
            return self._vals[key]

    def __setitem__(self, key: str, value: Any) -> None:
        with self._lock:
            self._vals[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._vals.get(key, default)

    def keys(self):
        with self._lock:
            return list(self._vals.keys())

    def items(self):
        with self._lock:
            return list(self._vals.items())

    def values(self):
        with self._lock:
            return list(self._vals.values())

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._vals)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._vals

    def __repr__(self) -> str:
        return f"StatsView({dict(self.items())!r})"
