"""The serving fleet's router core: N serve CLI replicas behind one front
door, queue-aware load balancing, the replica lifecycle, rolling drains
and the disaggregated prefill/decode dispatch.

A copy of ``paddlefleetx_tpu/core/router.py`` (pure host Python) that
imports only this package's modules: the HTTP contract, the scoring, the
journal and the failover ladder are the JAX router's, so either router
fronts either package's replicas.

  - **admission**: the router bounds its own in-flight work
    (``QueueFull`` -> HTTP 429, ``QueueClosed`` while draining -> 503),
    with per-tenant edge quotas, and checks deadlines before dispatching.
  - **replica lifecycle**: a state machine fed by ``/healthz?metrics=1``
    polls: ``booting`` -> ``warm`` -> ``serving`` -> ``draining`` ->
    ``gone``; a degraded replica (watchdog ``ok: false``) stays
    ``serving`` but ineligible until it recovers.
  - **scoring** (:meth:`RouterCore._score`): reported queue depth plus
    the router's in-flight count, a replica whose estimated wait exceeds
    the request's remaining deadline penalized to last resort, and a
    prefix-affinity bonus (:meth:`RouterCore._affinity`) toward the
    replica that advertises the prompt's cached prefix blocks.
  - **retry**: only for a send that provably never arrived (refused, not
    sent); anything after bytes were exchanged answers an honest 503 and
    is never replayed.
  - **rolling drain**: :meth:`RouterCore.drain` marks a replica ineligible
    and POSTs an authenticated ``/admin/drain`` (with ``migrate_to``: the
    surviving peers its hottest prefixes move to); a replica without
    ``/admin/drain`` gets SIGTERM on its identity pid.
  - **disaggregation** (:meth:`RouterCore.generate_disaggregated`): each
    prompt prefills on a prefill replica, which returns a PFXH1 KV-handoff
    payload (``core/paged_cache.pack_handoff``) for the router to carry
    (proxy) or POSTs it straight to the decode replica the router's ticket
    names (direct); the decode replica adopts the blocks and decodes on.
    A prefill replica lost mid-exchange is retried on another; a decode
    replica lost after adoption triggers one re-prefill through a healthy
    pair when the deadline allows, never a replay at a replica that saw
    the bytes.
  - **fleet state**: :class:`FleetFederation` re-exports the replicas'
    metrics, :class:`FleetLog` samples the fleet into a JSONL log, and
    :class:`FleetJournal` / :func:`read_fleet_journal` /
    :func:`replay_fleet_state` keep a crash-consistent record of the
    registry the router recovers from at boot.

``check_admin`` is the fleet's admin rule: one shared token in
``PFX_ADMIN_TOKEN`` gates every ``/admin/*`` and ``/debug/*`` endpoint of
the serve CLI and the router (``Authorization: Bearer <token>``); with it
unset only loopback clients are let in, and the first one logs a warning.
The elastic controller (``core/controller.py``) drives the fleet through
:meth:`RouterCore.add_replica`, :meth:`RouterCore.replica_views` and
:meth:`RouterCore.drain`, and journals its ``slot`` and ``scale`` records
here.
"""

from __future__ import annotations

import dataclasses
import hmac
import http.client
import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from paddlefleetx_tpu_torch.core.request_queue import QueueClosed, QueueFull
from paddlefleetx_tpu_torch.core.tenancy import (
    TenantAdmission,
    TenantConfig,
    TenantLabelCap,
    normalize_tenant,
)
from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.telemetry import (
    env_int,
    atomic_artifact_write,
    get_registry,
    parse_exposition,
)
from paddlefleetx_tpu_torch.utils.tracing import (
    SPAN_SUMMARY_HEADER,
    get_trace_buffer,
    outbound_trace_headers,
    parse_span_summaries,
)

REPLICA_STATES = ("booting", "warm", "serving", "draining", "gone")
STATE_CODE = {s: i for i, s in enumerate(REPLICA_STATES)}

# ---------------------------------------------------------------------------
# shared-token admin auth: THE auth rule for every /admin/* and /debug/*
# endpoint in the serving fleet (tools/serve.py AND tools/router.py), so a
# remote drain works cross-host without shipping an unauthenticated
# kill-switch.  One shared token via PFX_ADMIN_TOKEN; token unset means
# loopback-only, loudly (docs/serving.md "Elastic control plane").
# ---------------------------------------------------------------------------

ADMIN_TOKEN_ENV = "PFX_ADMIN_TOKEN"
_LOCAL_ONLY_WARNED = [False]  # once per process, reset by tests


def admin_token() -> str:
    """The fleet-shared admin token (empty = unset)."""
    return (os.environ.get(ADMIN_TOKEN_ENV) or "").strip()


def admin_headers() -> Dict[str, str]:
    """Outbound auth headers for an /admin call (empty dict when no
    token is configured — the callee then applies its loopback rule)."""
    tok = admin_token()
    return {"Authorization": f"Bearer {tok}"} if tok else {}


def check_admin(headers: Any, client_address: Any, *,
                what: str = "/admin") -> Tuple[bool, Optional[int], Optional[str]]:
    """Authorize one admin/debug request: ``(ok, http_code, message)``.

    Token set: the request must carry ``Authorization: Bearer <token>``
    (constant-time compare) — anything else is 401.  Token UNSET: only
    loopback clients are allowed (403 otherwise), and the first allowed
    request logs a LOUD warning so an operator who exposed the port
    beyond localhost knows the admin surface is gated off, not open.
    ``headers`` is any ``.get()``-able mapping; ``client_address`` is the
    ``(host, port)`` pair http.server hands a handler."""
    tok = admin_token()
    auth = str((headers.get("Authorization") if headers is not None else "") or "")
    supplied = auth[len("Bearer "):].strip() if auth.startswith("Bearer ") else ""
    if tok:
        if supplied and hmac.compare_digest(supplied, tok):
            return True, None, None
        return (False, 401,
                f"{what} requires a valid {ADMIN_TOKEN_ENV} bearer token")
    host = str(client_address[0]) if client_address else ""
    # ::ffff:127.x is a genuine loopback client seen through a
    # dual-stack (--host ::) bind — it must not be locked out
    if (host == "::1" or host.startswith("127.")
            or host.startswith("::ffff:127.")):
        if not _LOCAL_ONLY_WARNED[0]:
            _LOCAL_ONLY_WARNED[0] = True
            logger.warning(
                f"{ADMIN_TOKEN_ENV} is unset: /admin and /debug endpoints "
                "are LOCALHOST-ONLY.  Set the shared token on every "
                "replica and router to enable authenticated remote "
                "drains (docs/serving.md)"
            )
        return True, None, None
    return (False, 403,
            f"{what} is localhost-only while {ADMIN_TOKEN_ENV} is unset; "
            "set the shared token to enable remote admin")


class TenantQuotaExceeded(RuntimeError):
    """A tenant hit its configured quota at the front door (HTTP 429).
    ``retry_after_s`` is HONEST: for a rate rejection it is the token
    bucket's actual refill time, not a constant."""

    def __init__(self, tenant: str, reason: str,
                 retry_after_s: float) -> None:
        super().__init__(
            f"tenant {tenant!r} over {reason} quota; "
            f"retry after {retry_after_s:.3f}s"
        )
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


class NoReplicaAvailable(RuntimeError):
    """No eligible replica for the requested role (HTTP 503)."""


class ReplicaUnavailable(RuntimeError):
    """Dispatch failed after bytes may have been exchanged — honest 503,
    NEVER retried on another replica (the decode may have happened).
    ``replica_key`` (set by :meth:`RouterCore.dispatch`) names the
    replica that failed, so the handoff failover ladder can exclude it
    from a fallback chain without ever replaying AT it."""

    replica_key: Optional[str] = None


class RequestNotSent(ReplicaUnavailable):
    """Transport failed BEFORE the request went out (connect timeout,
    non-refused OSError): nothing downstream processed anything.  The
    drain path restores the target to rotation on this class — only a
    reply lost AFTER the exchange leaves it draining for the poller."""


@dataclasses.dataclass
class Replica:
    """One backend replica as the router sees it."""

    key: str               # router-assigned stable id (r0, r1, ...)
    url: str               # base URL, e.g. http://127.0.0.1:8001
    role: str = "monolith"  # monolith | prefill | decode (configured pool)
    state: str = "booting"
    # from the /healthz identity block (tools/serve.py)
    replica_id: Optional[str] = None
    pid: Optional[int] = None
    # boot_id is random per PROCESS START: pid+boot_id names one process
    # incarnation, so adoption and the legacy drain-by-pid fallback can
    # never signal a recycled pid (docs/serving.md "Control-plane
    # recovery"); started_at is the incarnation's wall-clock birth
    boot_id: Optional[str] = None
    started_at: Optional[float] = None
    scheduler: Optional[str] = None
    # last poll view
    healthy: bool = False   # healthz ok (False while degraded)
    depth: int = 0
    busy_s: float = 0.0
    occupancy: float = 0.0  # continuous-batch rows/capacity (0 otherwise)
    # paged-arena blocks an admission can actually obtain (decode
    # replicas report it; None until a poll carries the field)
    available_blocks: Optional[int] = None
    # prefix-affinity advertisement (tools/serve.py /healthz): published
    # shared-prefix blocks, the replica's KV block size, and crc32 path
    # hashes of its hottest cached prefixes — `pick` scores a request
    # toward the replica already holding its prefill (None/empty until
    # a poll carries the fields; absent when the prefix cache is off)
    prefix_cached_blocks: Optional[int] = None
    prefix_block: int = 0
    prefix_hashes: frozenset = frozenset()
    slo_breach: bool = False  # replica-reported SLO burn-rate breach
    # latency/TTFT view off the same /healthz snapshot (fleet-log fields)
    latency_p50_s: float = 0.0
    latency_p99_s: float = 0.0
    ttft_p99_s: float = 0.0
    itl_p99_s: float = 0.0
    last_poll: float = 0.0
    ok_streak: int = 0
    failures: int = 0
    role_mismatch: bool = False
    drain_requested: bool = False
    # router-side live accounting
    in_flight: int = 0
    last_latency_s: float = 0.05

    def eligible(self) -> bool:
        return (self.state == "serving" and self.healthy
                and not self.drain_requested and not self.role_mismatch)

    def view(self) -> Dict[str, Any]:
        """Operator JSON for GET /replicas (no secrets, no prompt data)."""
        return {
            "key": self.key,
            "url": self.url,
            "role": self.role,
            "state": self.state,
            "replica_id": self.replica_id,
            "pid": self.pid,
            "boot_id": self.boot_id,
            "started_at": self.started_at,
            "scheduler": self.scheduler,
            "healthy": self.healthy,
            "eligible": self.eligible(),
            "depth": self.depth,
            "busy_s": round(self.busy_s, 3),
            "occupancy": round(self.occupancy, 4),
            "available_blocks": self.available_blocks,
            "prefix_cached_blocks": self.prefix_cached_blocks,
            "prefix_hashes_advertised": len(self.prefix_hashes),
            "slo_breach": self.slo_breach,
            "latency_p50_s": self.latency_p50_s,
            "latency_p99_s": self.latency_p99_s,
            "ttft_p99_s": self.ttft_p99_s,
            "itl_p99_s": self.itl_p99_s,
            "in_flight": self.in_flight,
            "last_latency_s": round(self.last_latency_s, 4),
            "failures": self.failures,
            "role_mismatch": self.role_mismatch,
            "draining": self.drain_requested or self.state == "draining",
        }


def _local_url(base_url: str) -> bool:
    """True when the url's host is THIS host's loopback — the only case
    where the legacy SIGTERM-by-pid drain fallback is safe (a /healthz
    identity pid from another host is a valid pid HERE for some
    unrelated process)."""
    host = (urlsplit(base_url).hostname or "").lower()
    return (host == "localhost" or host == "::1"
            or host.startswith("127.") or host.startswith("::ffff:127."))


def _http_request(base_url: str, method: str, path: str, body=None,
                  headers=None, timeout: float = 30.0, sink=None
                  ) -> Tuple[int, bytes, str, Dict[str, str]]:
    """One downstream HTTP exchange -> ``(status, body, content_type,
    response_headers)``.  ``ConnectionRefusedError`` propagates
    untouched (the retryable class: no process listened, so nothing was
    processed); every other transport failure raises
    :class:`ReplicaUnavailable` (bytes may have been exchanged — never
    replay).  Response headers ride back for the trace-stitching layer
    (the callee's ``X-Span-Summary`` envelope).

    ``sink`` (optional, streamed relay): a ``sink(chunk: bytes)``
    callable — a 200 response's body is forwarded chunk-by-chunk as it
    arrives (``read1`` returns whatever is available instead of
    blocking for a full buffer, so token flushes propagate unbuffered)
    and only a bounded rolling TAIL is returned as ``body``, enough
    for the caller to parse the stream's terminal summary frame.  The
    sink must not raise — swallow client-side write failures and keep
    accepting (the upstream read is then just drained).  Non-200
    responses are returned whole so error bodies stay parseable."""
    u = urlsplit(base_url)
    conn = http.client.HTTPConnection(
        u.hostname, u.port or 80, timeout=timeout
    )
    try:
        try:
            conn.request(method, path, body=body, headers=headers or {})
        except ConnectionRefusedError:
            raise
        except OSError as e:
            # DNS failure / unreachable before the request line went out
            # behaves like refused for routing purposes
            if isinstance(e, ConnectionError) or getattr(e, "errno", None) in (
                111, 113,  # ECONNREFUSED, EHOSTUNREACH
            ):
                raise ConnectionRefusedError(str(e)) from e
            raise RequestNotSent(f"send failed: {e}") from e
        try:
            resp = conn.getresponse()
            if sink is not None and resp.status == 200:
                tail = b""
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    sink(chunk)
                    tail = (tail + chunk)[-8192:]
                data = tail
            else:
                data = resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise ReplicaUnavailable(
                f"reply lost mid-request ({type(e).__name__}: {e}); "
                "not retried — the decode may have run"
            ) from e
        return (resp.status, data,
                resp.getheader("Content-Type") or "application/json",
                dict(resp.getheaders()))
    finally:
        conn.close()


def stream_summary(tail: bytes) -> Dict[str, Any]:
    """Parse the terminal ``event: summary`` frame out of a streamed
    SSE body (or its rolling tail): the streamed stand-in for the
    ``X-Span-Summary`` response header, which cannot be complete
    before the body starts (tools/serve.py writes the frame last).
    Returns ``{}`` when absent or torn — a stream that failed
    mid-flight has no summary, honestly."""
    idx = tail.rfind(b"event: summary")
    if idx < 0:
        return {}
    for line in tail[idx:].split(b"\n"):
        if line.startswith(b"data: "):
            try:
                return json.loads(line[len(b"data: "):].decode(
                    "utf-8", "replace"
                ))
            except ValueError:
                return {}
    return {}


class FleetFederation:
    """Fleet metrics federation: one scrape of the router answers for
    the whole serving fabric (docs/observability.md "Fleet metrics
    federation").

    The router's /healthz poll loop feeds each replica's own
    ``/metrics`` exposition (carried on the SAME ``/healthz?metrics=1``
    response — one replica-side registry snapshot produces both the
    scoring fields and the federated samples, so routing decisions and
    exported fleet metrics can never tell two stories) into
    :meth:`ingest`; registered as a registry collector, every router
    snapshot then re-exports the stored samples as
    ``pfx_fleet_metric{replica=,pool=,name=<original sample>}`` rows —
    all from ONE locked registry snapshot, like every other collector.

    Guard rails: a per-replica staleness gauge
    (``pfx_fleet_scrape_age_seconds``) says how old each replica's view
    is, and a LABEL-CARDINALITY CAP (``PFX_FLEET_SERIES_CAP``, default
    4096 total series) drops the excess LOUDLY (one warning naming the
    count + ``pfx_fleet_series_dropped``) instead of letting the
    router's exposition grow unbounded as the supervisor churns slots.
    """

    def __init__(self, series_cap: Optional[int] = None) -> None:
        self.series_cap = (
            env_int("PFX_FLEET_SERIES_CAP", 4096)
            if series_cap is None else int(series_cap)
        )
        self._lock = threading.Lock()
        # replica key -> {"pool", "rows": [(name, labels, value)],
        #                 "t": monotonic of last SUCCESSFUL ingest}
        self._replicas: Dict[str, Dict[str, Any]] = {}
        self._cap_warned = False
        reg = get_registry()
        self._scrapes = lambda replica, outcome: reg.counter(
            "pfx_fleet_scrapes_total", replica=replica, outcome=outcome
        )

    def ingest(self, replica_key: str, pool: str, text: str) -> int:
        """Store one replica's exposition text (parsed); returns the
        number of federated samples kept for it.  Only ``pfx_*`` names
        federate, and a replica's own ``pfx_fleet_*`` rows (a router
        polled as a replica) are excluded — federation must not recurse."""
        rows = [
            (name, labels, value)
            for name, labels, value in parse_exposition(text)
            if name.startswith("pfx_")
            and not name.startswith("pfx_fleet_")  # noqa — prefix, not a metric name
        ]
        with self._lock:
            self._replicas[replica_key] = {
                "pool": pool, "rows": rows, "t": time.monotonic(),
            }
        self._scrapes(replica_key, "ok").inc()
        return len(rows)

    def note_miss(self, replica_key: str, outcome: str) -> None:
        """Count a poll that produced no federated samples: ``missing``
        (the replica answered /healthz without a metrics_text — an old
        build) or ``error`` (the poll itself failed).  The stored rows
        stay as-is; the staleness gauge carries the age."""
        self._scrapes(replica_key, outcome).inc()

    def forget(self, replica_key: str) -> None:
        """Drop a replica's stored samples (the slot was re-registered
        or permanently removed) so its stale series leave /metrics."""
        with self._lock:
            self._replicas.pop(replica_key, None)

    def value(self, replica_key: str, name: str,
              **labels: str) -> Optional[float]:
        """Read one stored sample for a replica (None when absent) —
        the fleet log's accessor."""
        want = {str(k): str(v) for k, v in labels.items()}
        with self._lock:
            rec = self._replicas.get(replica_key)
            if rec is None:
                return None
            for n, lab, v in rec["rows"]:
                if n == name and lab == want:
                    return v
        return None

    def samples(self, replica_key: str,
                name: str) -> List[Tuple[Dict[str, str], float]]:
        """Every stored (labels, value) sample of one family for one
        replica — the accessor for dynamically-labeled families (e.g.
        the per-tenant occupancy ledgers, whose tenant label set is not
        known up front the way :meth:`value`'s callers know theirs)."""
        out: List[Tuple[Dict[str, str], float]] = []
        with self._lock:
            rec = self._replicas.get(replica_key)
            if rec is None:
                return out
            for n, lab, v in rec["rows"]:
                if n == name:
                    out.append((dict(lab), v))
        return out

    def collect(self):
        """Registry-collector protocol: staleness per replica + every
        stored sample under the ``pfx_fleet_metric`` family, bounded by
        the series cap (replicas in sorted order, each replica's rows
        in scrape order — deterministic about WHICH series drop)."""
        now = time.monotonic()
        with self._lock:
            snap = {
                k: (rec["pool"], list(rec["rows"]), rec["t"])
                for k, rec in sorted(self._replicas.items())
            }
        out: List[Tuple[str, Dict[str, str], float]] = []
        kept = dropped = 0
        for key, (pool, rows, t) in snap.items():
            out.append((
                "pfx_fleet_scrape_age_seconds", {"replica": key},
                round(now - t, 3),
            ))
            for name, labels, value in rows:
                if kept >= self.series_cap:
                    dropped += 1
                    continue
                kept += 1
                merged = {"replica": key, "pool": pool, "name": name}
                for k, v in labels.items():
                    # an original label that collides with a federation
                    # label is preserved under a src_ prefix, never
                    # silently overwritten
                    merged[f"src_{k}" if k in merged else k] = v
                out.append(("pfx_fleet_metric", merged, value))
        out.append(("pfx_fleet_series", {}, float(kept)))
        out.append(("pfx_fleet_series_dropped", {}, float(dropped)))
        if dropped and not self._cap_warned:
            self._cap_warned = True
            logger.warning(
                f"fleet federation: series cap PFX_FLEET_SERIES_CAP="
                f"{self.series_cap} dropped {dropped} series — the fleet "
                "scrape no longer covers every replica sample; raise the "
                "cap or shrink the fleet's label space "
                "(pfx_fleet_series_dropped tracks the live count)"
            )
        return out


class FleetLog:
    """Append-only fleet-observability artifact
    (``<PFX_FLIGHT_DIR>/fleet_metrics.jsonl``): one sample row per
    replica per cadence (plus one for the router itself) and one row
    per controller scale event — what ``tools/report.py --fleet``
    renders, crash-tolerant by construction (every line is a complete
    JSON object; a torn tail line is skipped by the loader)."""

    def __init__(self, path: str, min_interval_s: float = 1.0) -> None:
        self.path = path
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._last_sample = 0.0
        self._warned = False

    def _append(self, rows: List[Dict[str, Any]]) -> None:
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            with open(self.path, "a") as f:
                for row in rows:
                    f.write(json.dumps(row, default=str) + "\n")
        except OSError as e:
            if not self._warned:
                self._warned = True
                logger.warning(f"fleet log write to {self.path} failed: {e}")

    def event(self, row: Dict[str, Any]) -> None:
        """Append one event row immediately (controller scale events)."""
        with self._lock:
            self._append([{"ts": time.time(), **row}])

    def due(self) -> bool:
        """Whether :meth:`sample` would write now — callers use it to
        skip building the (snapshot-priced) sample inputs off-cadence."""
        with self._lock:
            return time.monotonic() - self._last_sample >= self.min_interval_s

    def sample(self, views: List[Dict[str, Any]],
               federation: Optional[FleetFederation] = None,
               router_extra: Optional[Dict[str, Any]] = None) -> bool:
        """Append one sample row per replica (rate-limited to
        ``min_interval_s``) + a router self-row; returns whether a
        sample landed."""
        with self._lock:
            now = time.monotonic()
            if now - self._last_sample < self.min_interval_s:
                return False
            self._last_sample = now
            ts = time.time()
            rows = []
            for v in views:
                row = {
                    "ts": ts, "event": "replica_sample",
                    "replica": v["key"], "pool": v["role"],
                    "state": v["state"],
                    "depth": v["depth"],
                    "occupancy": v["occupancy"],
                    "in_flight": v["in_flight"],
                    "ttft_p99_s": v.get("ttft_p99_s", 0.0),
                    "itl_p99_s": v.get("itl_p99_s", 0.0),
                    "latency_p50_s": v.get("latency_p50_s", 0.0),
                    "latency_p99_s": v.get("latency_p99_s", 0.0),
                }
                if federation is not None:
                    for field, (name, labels) in _FLEET_SAMPLE_FIELDS.items():
                        val = federation.value(v["key"], name, **labels)
                        if val is not None:
                            row[field] = val
                rows.append(row)
            rows.append({
                "ts": ts, "event": "router_sample",
                **(router_extra or {}),
            })
            self._append(rows)
        return True


# federated samples copied onto each replica's fleet-log row (the
# report's handoff/arena breakdown): field -> (sample name, labels)
_FLEET_SAMPLE_FIELDS = {
    "kv_blocks_used": ("pfx_kv_blocks_used", {}),
    "kv_blocks_available": ("pfx_kv_blocks_available", {}),
    "tokens_out_total": ("pfx_serving_tokens_out_total", {}),
    "handoff_bytes_direct": ("pfx_handoff_bytes_total",
                             {"transport": "direct"}),
    "handoff_bytes_proxy": ("pfx_handoff_bytes_total",
                            {"transport": "proxy"}),
    "handoff_exports_total": ("pfx_handoff_exports_total", {}),
    "handoff_adopts_total": ("pfx_handoff_adopts_total", {}),
    # KV-durability view (docs/serving.md "KV lifecycle"): published
    # prefix blocks + the spill tier + drain-time migration outcomes —
    # tools/report.py --fleet renders the cache-survival curves off
    # these per-replica series
    "prefix_cached_blocks": ("pfx_prefix_cached_blocks", {}),
    "prefix_spill_entries": ("pfx_prefix_spill_entries", {}),
    "prefix_spills_total": ("pfx_prefix_spills_total", {}),
    "prefix_readmits_total": ("pfx_prefix_readmits_total", {}),
    "migrate_sent_total": ("pfx_migrate_sent_total", {}),
    "migrate_adopted_total": ("pfx_migrate_adopted_total", {}),
    "migrate_failed_total": ("pfx_migrate_failed_total", {}),
    # goodput ledgers (docs/observability.md "Goodput ledger"): the
    # scheduler's time buckets + token dispositions per replica — what
    # tools/report.py --fleet renders as the stacked goodput breakdown
    "sched_wall_s": ("pfx_sched_wall_seconds_total", {}),
    "sched_host_gap_s": ("pfx_sched_host_gap_seconds_total", {}),
    "sched_device_decode_s": ("pfx_sched_time_seconds_total",
                              {"bucket": "device_decode"}),
    "sched_device_prefill_s": ("pfx_sched_time_seconds_total",
                               {"bucket": "device_prefill"}),
    "sched_host_sched_s": ("pfx_sched_time_seconds_total",
                           {"bucket": "host_sched"}),
    "sched_readback_s": ("pfx_sched_time_seconds_total",
                         {"bucket": "readback"}),
    "sched_stream_flush_s": ("pfx_sched_time_seconds_total",
                             {"bucket": "stream_flush"}),
    "sched_idle_s": ("pfx_sched_time_seconds_total", {"bucket": "idle"}),
    "tok_admitted": ("pfx_token_ledger_total", {"disposition": "admitted"}),
    "tok_delivered": ("pfx_token_ledger_total",
                      {"disposition": "delivered"}),
    "tok_evicted_lost": ("pfx_token_ledger_total",
                         {"disposition": "evicted_lost"}),
    "tok_preempt_refunded": ("pfx_token_ledger_total",
                             {"disposition": "preempt_refunded"}),
    "tok_shed_after_admit": ("pfx_token_ledger_total",
                             {"disposition": "shed_after_admit"}),
}

# ---------------------------------------------------------------------------
# crash-consistent control-plane journal (docs/serving.md "Control-plane
# recovery"): the registry, supervisor slot table, controller clocks, and
# tenant quota buckets all live in router memory — FleetJournal makes them
# survive the router.  Same durability recipe the flight artifacts use:
# every record is one complete JSON line appended to
# <PFX_FLIGHT_DIR>/fleet_state.jsonl; every `snapshot_every` records the
# file is REWRITTEN atomically (`atomic_artifact_write`) as one compacted
# full-state snapshot line, so the journal is bounded and any prefix of it
# replays to a valid (if slightly stale) control-plane view.  A torn tail
# — the router died mid-append — is a loud note and a safe partial
# recovery, never a crash and never a phantom replica.
# ---------------------------------------------------------------------------

FLEET_JOURNAL_SNAPSHOT_EVERY_ENV = "PFX_JOURNAL_SNAPSHOT_EVERY"


class FleetJournal:
    """Append log + periodic compacted snapshot of the control plane.

    Record kinds (each one JSON line with ``ts`` wall-clock + ``kind``):

    - ``replica``  — registry add / state transition (key, url, role,
      state, why, and the /healthz identity triple replica_id/pid/boot_id)
    - ``slot``     — supervisor slot fact (pool, slot, port, url, rid,
      cmd_hash, pid, boot_id, phase ``spawning|spawned|adopted``); the
      ``spawning`` record lands BEFORE the child process exists, so no
      window exists where a spawned replica is untracked and unadoptable
    - ``scale``    — controller decision + clock AGES (``up_age_s`` etc.
      are ``now_monotonic - clock`` at record time: monotonic clocks
      never cross a process boundary, ages + the death window do)
    - ``tenants``  — tenant bucket/in-flight snapshot (rate-limited)
    - ``snapshot`` — compaction: the full state a fresh replay starts from

    Appends happen under callers' registry locks (core -> journal lock
    order); compaction reads live state via ``snapshot_fn`` and therefore
    runs ONLY from :meth:`maybe_compact` on the poll thread, which holds
    no core lock.  Journal gauges are exposed via ``collect()``
    (registry -> journal order), never pushed from ``record()``."""

    def __init__(self, path: str, snapshot_every: Optional[int] = None
                 ) -> None:
        self.path = path
        self.snapshot_every = (
            env_int(FLEET_JOURNAL_SNAPSHOT_EVERY_ENV, 256)
            if snapshot_every is None else int(snapshot_every))
        self._lock = threading.Lock()
        self._warned = False
        self._since_snapshot = 0
        self._bytes = 0
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            pass
        self._snapshot_fn = None  # () -> full-state dict (tools/router.py)
        get_registry().register_collector(self)

    def set_snapshot_fn(self, fn) -> None:
        self._snapshot_fn = fn

    def collect(self) -> List[Tuple[str, Dict[str, str], float]]:
        with self._lock:
            return [
                ("pfx_router_journal_records", {},
                 float(self._since_snapshot)),
                ("pfx_router_journal_bytes", {}, float(self._bytes)),
            ]

    def record(self, kind: str, **fields: Any) -> None:
        """Append one record.  Never raises (a dead disk must not take
        the control plane with it — warn once and keep serving)."""
        row: Dict[str, Any] = {"ts": round(time.time(), 3), "kind": kind}
        row.update(fields)
        line = json.dumps(row, default=str) + "\n"
        with self._lock:
            try:
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(line)
            except OSError as e:
                if not self._warned:
                    self._warned = True
                    logger.warning(
                        f"fleet journal write to {self.path} failed: {e} "
                        "— control-plane state will NOT survive this "
                        "router (recovery falls back to /admin/register "
                        "heartbeats)")
                return
            self._since_snapshot += 1
            self._bytes += len(line)

    def maybe_compact(self, force: bool = False) -> bool:
        """Rewrite the journal as one snapshot line when the append tail
        is due.  Called off the poll loop ONLY — ``snapshot_fn`` reads
        live registry/controller/tenant state, so it must run on a
        thread holding no core or registry lock.  A record racing the
        atomic swap is superseded by the snapshot it raced (the snapshot
        is built from live state); at worst the journal is one
        transition stale until the next compaction."""
        fn = self._snapshot_fn
        if fn is None:
            return False
        with self._lock:
            due = force or (self.snapshot_every > 0
                            and self._since_snapshot >= self.snapshot_every)
        if not due:
            return False
        try:
            state = fn()
        except Exception as e:  # noqa: BLE001 — snapshot is best-effort
            logger.warning(f"fleet journal snapshot build failed: {e}")
            return False
        row = {"ts": round(time.time(), 3), "kind": "snapshot",
               "state": state}
        line = json.dumps(row, default=str) + "\n"
        with self._lock:
            if not atomic_artifact_write(
                    self.path, lambda f: f.write(line)):
                return False
            self._since_snapshot = 0
            self._bytes = len(line)
        return True


def read_fleet_journal(path: str
                       ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """Load a fleet journal -> ``(records, note)``.

    ``note`` is None for a clean read; a torn or corrupt line makes it a
    loud human sentence and truncates the record list THERE — everything
    before the tear is trusted, everything after it is dropped (ordering
    past a corrupt line cannot be trusted, and a half-written JSON
    object must never become a phantom replica).  A missing file is an
    empty journal, not an error."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], None
    records: List[Dict[str, Any]] = []
    note: Optional[str] = None
    lines = data.split(b"\n")
    for i, ln in enumerate(lines):
        if not ln.strip():
            continue
        try:
            obj = json.loads(ln.decode("utf-8"))
            if not isinstance(obj, dict) or "kind" not in obj:
                raise ValueError("not a journal record")
        except (ValueError, UnicodeDecodeError):
            dropped = sum(1 for rest in lines[i:] if rest.strip())
            note = (f"fleet journal {path}: torn/corrupt record at line "
                    f"{i + 1}; recovered {len(records)} record(s), "
                    f"dropped {dropped} from the tail")
            logger.warning(note)
            break
        records.append(obj)
    return records, note


def replay_fleet_state(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold journal records into the control-plane view they describe.

    The replay contract, control-plane edition: recovery
    CONSUMES this function's output (tools/router.py applies it to the
    fresh registry/controller/tenant objects), so "replay equals the
    recovered views" holds by construction and the drill only has to
    compare this fold against the recovered router's HTTP surfaces.

    Returns ``{"replicas": {key: {...}}, "slots": {pool: {slot: {...}}},
    "controller": {pool: {...}}, "tenants": {"buckets", "in_flight"},
    "wall": <ts of last folded record>, "records": n}``."""
    state: Dict[str, Any] = {
        "replicas": {}, "slots": {}, "controller": {},
        "tenants": {"buckets": {}, "in_flight": {}},
        "wall": None, "records": 0,
    }
    for rec in records:
        kind = rec.get("kind")
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            state["wall"] = float(ts)
        state["records"] += 1
        if kind == "snapshot":
            snap = rec.get("state") or {}
            state["replicas"] = {
                str(k): dict(v)
                for k, v in (snap.get("replicas") or {}).items()
                if isinstance(v, dict)}
            state["slots"] = {
                str(p): {str(s): dict(f) for s, f in pool.items()
                         if isinstance(f, dict)}
                for p, pool in (snap.get("slots") or {}).items()
                if isinstance(pool, dict)}
            state["controller"] = {
                str(p): dict(v)
                for p, v in (snap.get("controller") or {}).items()
                if isinstance(v, dict)}
            ten = snap.get("tenants") or {}
            state["tenants"] = {
                "buckets": dict(ten.get("buckets") or {}),
                "in_flight": dict(ten.get("in_flight") or {}),
            }
        elif kind == "replica":
            key = rec.get("key")
            if not key:
                continue
            row = state["replicas"].setdefault(str(key), {})
            for f in ("url", "role", "state", "why",
                      "replica_id", "pid", "boot_id"):
                if rec.get(f) is not None:
                    row[f] = rec[f]
        elif kind == "slot":
            pool = str(rec.get("pool") or "monolith")
            slot = rec.get("slot")
            if slot is None:
                continue
            row = state["slots"].setdefault(pool, {}).setdefault(
                str(slot), {})
            for f in ("port", "url", "rid", "cmd_hash", "pid",
                      "boot_id", "phase"):
                if rec.get(f) is not None:
                    row[f] = rec[f]
        elif kind == "scale":
            pool = str(rec.get("pool") or "monolith")
            row = {}
            for f in ("target", "tick", "action", "reason",
                      "up_age_s", "scale_age_s", "idle_for_s"):
                if rec.get(f) is not None:
                    row[f] = rec[f]
            row["wall"] = ts
            state["controller"][pool] = row
        elif kind == "tenants":
            state["tenants"] = {
                "buckets": dict(rec.get("buckets") or {}),
                "in_flight": dict(rec.get("in_flight") or {}),
            }
    return state


# prefix affinity is worth at most this many backlog units in `_score`:
# enough to break a near-tie toward a warm cache, never enough to beat
# a meaningfully shorter queue — and 5 orders of magnitude under the
# blocks-exhausted / deadline-infeasible penalties it must never mask
_AFFINITY_CAP = 4.0


class RouterCore:
    """The transport-independent router: replica registry + health
    poller + admission + scored dispatch (tools/router.py is the HTTP
    skin).  ``replicas`` is a list of (url, role) pairs; roles partition
    into pools, and `pick` draws from one pool."""

    def __init__(self, replicas: Sequence[Tuple[str, str]], *,
                 max_inflight: int = 64, retries: int = 2,
                 poll_interval_s: float = 0.5, poll_timeout_s: float = 2.0,
                 eject_after: int = 3, serve_after: int = 1,
                 allow_empty: bool = False, name: str = "router",
                 handoff: str = "proxy",
                 tenant_config: Optional[TenantConfig] = None) -> None:
        if not replicas and not allow_empty:
            # allow_empty is the supervised topology (tools/router.py
            # --supervise): the controller registers replicas via
            # add_replica as it spawns them
            raise ValueError("router needs >= 1 replica")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if handoff not in ("proxy", "direct"):
            raise ValueError(
                f"unknown handoff transport {handoff!r}; "
                "valid: proxy, direct"
            )
        # disaggregated KV-handoff transport: "direct" issues a
        # placement ticket and the prefill replica POSTs the payload
        # straight to the chosen decode replica (handoff bytes never
        # transit the router); "proxy" carries the payload through this
        # process — kept as the drilled fallback, and what a direct
        # transfer degrades to when the send fails
        self.handoff = handoff
        self.name = name
        self.retries = int(retries)
        self.max_inflight = int(max_inflight)
        self.poll_interval_s = float(poll_interval_s)
        self.poll_timeout_s = float(poll_timeout_s)
        self.eject_after = int(eject_after)
        self.serve_after = max(1, int(serve_after))
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._closed = False
        self._in_flight_total = 0
        # per-tenant edge quotas (docs/serving.md "Multi-tenant
        # isolation"): rate buckets + in-flight caps ahead of the global
        # in-flight gate; the default config admits everything
        self.tenant_config = tenant_config or TenantConfig()
        self._tenant_admission = TenantAdmission(self.tenant_config)
        self._tenant_labels = TenantLabelCap(
            seed=self.tenant_config.known_tenants()
        )
        self._stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._rr = 0  # round-robin tiebreak cursor
        self.replicas: Dict[str, Replica] = {}
        for i, (url, role) in enumerate(replicas):
            if role not in ("monolith", "prefill", "decode"):
                raise ValueError(
                    f"unknown replica role {role!r}; "
                    "valid: monolith, prefill, decode"
                )
            self.replicas[f"r{i}"] = Replica(
                key=f"r{i}", url=url.rstrip("/"), role=role
            )
        self._next_slot = len(self.replicas)
        roles = {r.role for r in self.replicas.values()}
        if "monolith" in roles and roles != {"monolith"}:
            raise ValueError(
                "mixing monolith replicas with prefill/decode pools is not "
                "supported; run either --replica or --prefill/--decode"
            )
        if roles and roles != {"monolith"} and not (
            "prefill" in roles and "decode" in roles
        ):
            raise ValueError(
                "disaggregated mode needs BOTH --prefill and --decode "
                f"replicas (got roles {sorted(roles)})"
            )
        self.disaggregated = bool(roles) and roles != {"monolith"}
        reg = get_registry()
        self._requests = lambda replica, outcome: reg.counter(
            "pfx_router_requests_total", replica=replica, outcome=outcome
        )
        self._retries_ctr = reg.counter("pfx_router_retries_total")
        self._drains_ctr = reg.counter("pfx_router_drains_total")
        self._handoff_bytes = reg.counter("pfx_router_handoff_bytes_total")
        self._handoff_hist = reg.histogram("pfx_router_handoff_seconds")
        self._failovers = lambda leg: reg.counter(
            "pfx_handoff_failovers_total", leg=leg
        )
        reg.register_collector(self)
        # fleet metrics federation: the poll loop feeds each replica's
        # /metrics view (same snapshot as its scoring fields) in here;
        # one scrape of the router then answers for the whole fleet
        self.federation = FleetFederation()
        reg.register_collector(self.federation)
        # optional fleet-observability artifact (tools/router.py wires
        # it in serve mode; library users opt in by assigning one)
        self.fleet_log: Optional[FleetLog] = None
        # optional crash-consistent control-plane journal (tools/router.py
        # wires one; docs/serving.md "Control-plane recovery").  Lock
        # order: self._lock -> journal._lock — journal code never calls
        # back into the router
        self.journal: Optional[FleetJournal] = None
        self._journal_last_tenants = 0.0

    # -- telemetry ------------------------------------------------------
    def collect(self):
        with self._lock:
            rows = [("pfx_router_in_flight", {},
                     float(self._in_flight_total))]
            for key, r in self.replicas.items():
                rows.append(("pfx_router_replica_depth", {"replica": key},
                             float(r.depth)))
                rows.append(("pfx_router_replica_state", {"replica": key},
                             float(STATE_CODE[r.state])))
        # per-tenant in-flight (TenantAdmission holds its own lock; the
        # label cap keeps cardinality at top-k + overflow)
        folded: Dict[str, float] = {}
        for tn, n in self._tenant_admission.inflight_snapshot().items():
            lab = self._tenant_labels.label(tn)
            folded[lab] = folded.get(lab, 0.0) + float(n)
        for lab in sorted(folded):
            rows.append(("pfx_tenant_in_flight", {"tenant": lab},
                         folded[lab]))
        return rows

    # -- dynamic registration (elastic control plane) --------------------
    def add_replica(self, url: str, role: str = "monolith") -> str:
        """Register a replica at runtime (the controller calls this as
        the supervisor spawns one).  Idempotent on url: re-registering a
        known url returns its existing key — a respawned process on the
        same port re-enters the rotation through the normal gone ->
        warm -> serving walk, it does not get a second slot."""
        if role not in ("monolith", "prefill", "decode"):
            raise ValueError(
                f"unknown replica role {role!r}; "
                "valid: monolith, prefill, decode"
            )
        url = url.rstrip("/")
        with self._lock:
            for r in self.replicas.values():
                if r.url == url:
                    return r.key
            roles = {r.role for r in self.replicas.values()}
            if roles and (
                (role == "monolith") != (roles == {"monolith"})
            ):
                raise ValueError(
                    f"cannot register a {role} replica into a "
                    f"{'monolith' if roles == {'monolith'} else 'pool'} "
                    "topology (mixing is not supported)"
                )
            key = f"r{self._next_slot}"
            self._next_slot += 1
            self.replicas[key] = Replica(key=key, url=url, role=role)
            # a pool-supervised router boots EMPTY (allow_empty) and
            # learns its topology from the registrations
            self.disaggregated = role != "monolith"
        logger.info(f"{self.name}: replica {key} registered ({url}, {role})")
        j = self.journal
        if j is not None:
            j.record("replica", key=key, url=url, role=role,
                     state="booting", why="registered")
        return key

    # -- health polling + lifecycle -------------------------------------
    def poll_replica(self, r: Replica) -> None:
        """One poll, driving the state machine (called by the poll
        loop; tests call it directly for determinism).  The poll GETs
        ``/healthz?metrics=1``: the replica renders its health JSON AND
        its full /metrics exposition from ONE registry snapshot, so the
        scoring fields this poll stores (depth, busy, occupancy) and
        the federated samples it ingests can never disagree mid-scrape
        — routing decisions and exported fleet metrics tell one story."""
        try:
            status, body, _, _ = _http_request(
                r.url, "GET", "/healthz?metrics=1",
                timeout=self.poll_timeout_s,
            )
            if status == 404:
                # a pre-federation replica may match /healthz by EXACT
                # path and 404 the query spelling: a healthy old build
                # in a mixed-version rolling upgrade must keep polling
                # fine (scrape outcome counts "missing" below), never
                # accumulate failures toward ejection
                status, body, _, _ = _http_request(
                    r.url, "GET", "/healthz", timeout=self.poll_timeout_s,
                )
            if status != 200:
                raise ReplicaUnavailable(f"/healthz returned {status}")
            h = json.loads(body)
        except Exception as exc:  # noqa: BLE001 — any failed poll counts
            with self._lock:
                r.failures += 1
                r.ok_streak = 0
                r.last_poll = time.monotonic()
                refused = isinstance(exc, ConnectionRefusedError)
                if r.state == "draining" and refused:
                    # the drained process exited: clean end of life
                    self._transition(r, "gone", "drained and exited")
                elif r.failures >= self.eject_after and r.state != "gone":
                    self._transition(
                        r, "gone",
                        f"ejected after {r.failures} failed polls "
                        f"({type(exc).__name__})",
                    )
            get_registry().counter(
                "pfx_router_poll_failures_total", replica=r.key
            ).inc()
            self.federation.note_miss(r.key, "error")
            return
        mt = h.get("metrics_text")
        if isinstance(mt, str) and mt:
            self.federation.ingest(r.key, r.role, mt)
        else:
            # a pre-federation replica answers /healthz without the
            # field: counted, never fatal — the staleness gauge carries
            # how old (or absent) its federated view is
            self.federation.note_miss(r.key, "missing")
        with self._lock:
            r.failures = 0
            r.last_poll = time.monotonic()
            r.healthy = bool(h.get("ok", False))
            r.depth = int(h.get("queue_depth", 0))
            r.busy_s = float(h.get("busy_s", 0.0))
            r.latency_p50_s = float(h.get("latency_p50_s", 0.0) or 0.0)
            r.latency_p99_s = float(h.get("latency_p99_s", 0.0) or 0.0)
            r.ttft_p99_s = float(h.get("ttft_p99_s", 0.0) or 0.0)
            r.itl_p99_s = float(h.get("itl_p99_s", 0.0) or 0.0)
            # elastic-control signals (core/controller.py): continuous-
            # batch occupancy and the replica's own SLO breach verdict
            r.occupancy = float(h.get("occupancy", 0.0) or 0.0)
            ab = h.get("available_blocks")
            r.available_blocks = int(ab) if ab is not None else None
            # prefix-affinity advertisement (absent on replicas without
            # a prefix cache — affinity then scores 0, never an error)
            pcb = h.get("prefix_cached_blocks")
            r.prefix_cached_blocks = int(pcb) if pcb is not None else None
            r.prefix_block = int(h.get("prefix_block", 0) or 0)
            try:
                r.prefix_hashes = frozenset(
                    int(x) for x in (h.get("prefix_hashes") or ())
                )
            except (TypeError, ValueError):
                r.prefix_hashes = frozenset()  # malformed: no affinity
            r.slo_breach = bool((h.get("slo") or {}).get("breach", False))
            ident = h.get("identity") or {}
            old_pid = r.pid
            if ident:
                r.replica_id = ident.get("replica_id", r.replica_id)
                r.pid = ident.get("pid", r.pid)
                r.boot_id = ident.get("boot_id", r.boot_id)
                try:
                    sa = ident.get("started_at")
                    r.started_at = float(sa) if sa is not None \
                        else r.started_at
                except (TypeError, ValueError):
                    pass
                r.scheduler = ident.get("scheduler", r.scheduler)
                reported = ident.get("role")
                if reported and reported != r.role and not r.role_mismatch:
                    # a decode replica in the prefill pool would 404 every
                    # dispatch: refuse to route rather than half-work
                    r.role_mismatch = True
                    logger.warning(
                        f"{self.name}: {r.key} reports role "
                        f"{reported!r} but is configured {r.role!r}; "
                        "marked ineligible"
                    )
            if r.drain_requested and (
                r.state == "gone"
                or (old_pid is not None and r.pid is not None
                    and r.pid != old_pid)
            ):
                # a REDEPLOYED process answered on the drained replica's
                # url (we saw it reach gone, or the pid changed): the
                # drain is complete for the OLD process — clearing the
                # flag lets the new one re-enter via warm -> serving,
                # which is the whole rolling-deploy recipe
                r.drain_requested = False
                logger.info(
                    f"{self.name}: replica {r.key} redeployed "
                    f"(pid {r.pid}); drain flag cleared"
                )
            if h.get("state") == "draining" or r.drain_requested:
                if r.state not in ("draining", "gone"):
                    self._transition(r, "draining", "replica drain observed")
                r.ok_streak = 0
                return
            r.ok_streak = r.ok_streak + 1 if r.healthy else 0
            if r.state in ("booting", "gone"):
                self._transition(r, "warm", "healthz answered")
            if r.state == "warm" and r.ok_streak >= self.serve_after:
                self._transition(r, "serving", "health streak met")

    def _transition(self, r: Replica, state: str, why: str) -> None:
        # caller holds the lock
        if r.state != state:
            logger.info(
                f"{self.name}: replica {r.key} ({r.url}) "
                f"{r.state} -> {state}: {why}"
            )
            r.state = state
            j = self.journal
            if j is not None:
                # identity rides every transition record so replay can
                # restore the pid/boot_id view without a separate stream
                # (lock order core -> journal; record() never blocks on
                # the registry)
                j.record("replica", key=r.key, url=r.url, role=r.role,
                         state=state, why=why, replica_id=r.replica_id,
                         pid=r.pid, boot_id=r.boot_id)
            if state == "gone":
                # a gone replica's federated series leave the scrape
                # (they would otherwise re-export forever with growing
                # staleness and, under supervisor churn, crowd LIVE
                # replicas out of the series cap); a redeploy that walks
                # gone -> warm -> serving repopulates on its next poll.
                # Lock order: self._lock (held) -> federation._lock —
                # nothing takes them in the other order
                self.federation.forget(r.key)

    def _poll_loop(self) -> None:
        # gone replicas keep getting polled (cheap): a redeployed process
        # on the same url re-enters the rotation via warm -> serving
        while not self._stop.wait(self.poll_interval_s):
            for r in list(self.replicas.values()):
                self.poll_replica(r)
            self._fleet_sample()
            self._journal_tick()

    def _fleet_sample(self) -> None:
        """One fleet-log sample after a poll sweep (rate-limited inside
        FleetLog; no-op when no log is wired)."""
        log = self.fleet_log
        if log is None or not log.due():
            return
        reg = get_registry()
        snap = reg.snapshot()
        hand = reg.value("pfx_router_handoff_seconds",
                         default={"count": 0, "sum": 0.0}, snap=snap)
        log.sample(
            self.replica_views(), self.federation,
            router_extra={
                "in_flight": self.depth(),
                "handoff_bytes_proxied": reg.value(
                    "pfx_router_handoff_bytes_total", snap=snap),
                "handoff_count": hand.get("count", 0),
                "handoff_seconds_sum": hand.get("sum", 0.0),
                "fleet_series": reg.value("pfx_fleet_series", snap=snap),
                "tenants": self.tenant_snapshot(),
            },
        )

    def _journal_tick(self) -> None:
        """Periodic journal upkeep off the poll sweep: a rate-limited
        tenant bucket/in-flight record, then compaction when the append
        tail is due.  Runs HERE (poll thread, no core lock held) because
        compaction reads live state via the snapshot provider — see
        :meth:`FleetJournal.maybe_compact`."""
        j = self.journal
        if j is None:
            return
        now = time.monotonic()
        if now - self._journal_last_tenants >= 1.0:
            self._journal_last_tenants = now
            j.record("tenants", **self.tenant_journal_snapshot())
        j.maybe_compact()

    def tenant_journal_snapshot(self) -> Dict[str, Any]:
        """Tenant bucket + in-flight state for the fleet journal (the
        shape ``restore_tenant_buckets`` folds back in; in-flight is
        journaled for observability only — those requests die with the
        router that admitted them)."""
        return {
            "buckets": self._tenant_admission.bucket_snapshot(),
            "in_flight": self._tenant_admission.inflight_snapshot(),
        }

    # -- control-plane recovery (docs/serving.md "Control-plane
    # recovery"): journal restore + replica self-registration ------------
    def restore_tenant_buckets(self, buckets: Dict[str, Dict[str, float]],
                               age_s: float = 0.0) -> int:
        """Fold a journaled tenant bucket snapshot back into admission
        (router restart): each bucket resumes from its recorded tokens
        plus ``age_s`` seconds of refill — the death window earns
        exactly the refill it would have earned, never a fresh burst
        allowance.  Returns buckets restored."""
        n = self._tenant_admission.restore_buckets(buckets or {},
                                                   age_s=age_s)
        if n:
            logger.info(f"{self.name}: restored {n} tenant quota "
                        f"bucket(s) from the fleet journal "
                        f"(death window {age_s:.1f}s of refill)")
        return n

    def register_replica(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """One ``POST /admin/register`` heartbeat from a replica
        (tools/serve.py ``--router-url``): idempotent add + identity
        refresh, so a router restarted with a lost or stale journal
        rediscovers its fleet from the replicas themselves.  A body with
        ``deregister: true`` is the drain-exit goodbye — the replica is
        walked to ``gone`` immediately instead of waiting out
        ``eject_after`` failed polls, gated on an identity match so a
        stale goodbye can never eject a redeployed successor.  Raises
        ``ValueError`` on a malformed body (HTTP skin answers 400)."""
        url = str(obj.get("url") or "").rstrip("/")
        if not url or not urlsplit(url).netloc:
            raise ValueError(
                "register needs a base 'url' (http://host:port)")
        ident = obj.get("identity")
        if not isinstance(ident, dict):
            ident = {}
        if obj.get("deregister"):
            with self._lock:
                target = next((r for r in self.replicas.values()
                               if r.url == url), None)
                if target is None:
                    return {"key": None, "state": "unknown"}
                rid = ident.get("replica_id")
                boot = ident.get("boot_id")
                if ((rid and target.replica_id
                     and rid != target.replica_id)
                        or (boot and target.boot_id
                            and boot != target.boot_id)):
                    raise ValueError(
                        f"deregister identity mismatch for {url}: "
                        "a stale goodbye cannot eject the current "
                        "process")
                self._transition(target, "gone", "deregistered on drain")
                key = target.key
            get_registry().counter(
                "pfx_replica_registrations_total", outcome="deregister"
            ).inc()
            return {"key": key, "state": "gone"}
        role = str(obj.get("role") or "monolith")
        key = self.add_replica(url, role)
        with self._lock:
            r = self.replicas[key]
            if ident.get("replica_id"):
                r.replica_id = str(ident["replica_id"])
            if ident.get("pid") is not None:
                try:
                    r.pid = int(ident["pid"])
                except (TypeError, ValueError):
                    pass
            if ident.get("boot_id"):
                r.boot_id = str(ident["boot_id"])
            if ident.get("started_at") is not None:
                try:
                    r.started_at = float(ident["started_at"])
                except (TypeError, ValueError):
                    pass
            state = r.state
        get_registry().counter(
            "pfx_replica_registrations_total", outcome="register"
        ).inc()
        return {"key": key, "state": state}

    def start(self) -> "RouterCore":
        if self._poll_thread is None or not self._poll_thread.is_alive():
            # first sweep synchronously: the front door opens with a view
            for r in self.replicas.values():
                self.poll_replica(r)
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name=f"{self.name}-poll", daemon=True
            )
            self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)

    # -- admission (the RequestQueue surface, router-level) -------------
    def acquire(self, tenant: Optional[str] = None) -> None:
        """Admit one request into the router.  Per-tenant quota first
        (``TenantQuotaExceeded`` -> 429 with the bucket's HONEST
        retry-after), then the global gate: ``QueueFull`` -> 429,
        ``QueueClosed`` (draining) -> 503 — the admission contract
        applied at the front door.

        LOCK ORDER: the registry snapshot holds the registry lock while
        calling :meth:`collect` (which takes ``self._lock``), so nothing
        here may touch the registry while holding ``self._lock`` — the
        rejection counters are bumped AFTER release or a concurrent
        /metrics scrape deadlocks the router."""
        tn = normalize_tenant(tenant)
        ok, why, retry = self._tenant_admission.admit(tn)
        if not ok:
            get_registry().counter(
                "pfx_tenant_rejected_total",
                tenant=self._tenant_labels.label(tn), reason=why,
            ).inc()
            raise TenantQuotaExceeded(tn, why, retry)
        reason = None
        with self._lock:
            if self._closed:
                reason = "draining"
            elif self._in_flight_total >= self.max_inflight:
                reason = "full"
            else:
                self._in_flight_total += 1
        if reason is not None:
            # the tenant slot was provisional: give it back before
            # rejecting so a global 429/503 never leaks tenant in-flight
            self._tenant_admission.release(tn)
            get_registry().counter(
                "pfx_router_rejected_total", reason=reason
            ).inc()
            if reason == "draining":
                raise QueueClosed(f"{self.name} is draining")
            raise QueueFull(
                f"{self.name} at capacity ({self.max_inflight} in flight)"
            )

    def release(self, tenant: Optional[str] = None) -> None:
        self._tenant_admission.release(normalize_tenant(tenant))
        with self._idle:
            self._in_flight_total -= 1
            if self._in_flight_total == 0:
                self._idle.notify_all()

    def close(self) -> None:
        """Stop admitting (drain): in-flight requests finish."""
        with self._lock:
            self._closed = True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every admitted request has left the router."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._in_flight_total > 0:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0:
                    return False
                self._idle.wait(left)
        return True

    def depth(self) -> int:
        with self._lock:
            return self._in_flight_total

    # -- scoring + dispatch ---------------------------------------------
    def _score(self, r: Replica, remaining_s: float,
               affinity: float = 0.0) -> float:
        """Queue-depth/deadline-aware least-loaded score (lower wins):
        base = reported depth + router-side in-flight; a replica whose
        estimated wait (backlog x recent per-request latency + the
        in-progress decode's age) exceeds the request's remaining
        deadline is pushed to last resort.

        DECODE replicas additionally fold their paged-arena pressure in
        (the /healthz ``occupancy`` + ``available_blocks`` the poller
        already carries): a shallow queue on a nearly-full arena loses
        to a slightly deeper one with room, and an arena with NO
        admissible blocks is pushed near last resort — it would bounce
        the adoption it attracted.

        ``affinity`` (cached-prefix blocks this replica already holds
        for THIS request — `_affinity`) is a CAPPED subtraction: worth
        at most ``_AFFINITY_CAP`` backlog units, so a warm cache can
        break a near-tie but can NEVER override the blocks-exhausted or
        deadline-infeasible penalties (1e5/1e6 — a replica that cannot
        answer in time loses regardless of what it has cached)."""
        backlog = r.depth + r.in_flight
        est_wait = backlog * max(r.last_latency_s, 0.01) + min(r.busy_s, 60.0)
        score = float(backlog)
        score -= min(max(0.0, float(affinity)), _AFFINITY_CAP)
        if r.role == "decode":
            score += 8.0 * r.occupancy
            if r.available_blocks is not None and r.available_blocks <= 0:
                score += 1e5
        if remaining_s > 0 and est_wait > remaining_s:
            score += 1e6  # only if every replica is past the deadline
        return score

    @staticmethod
    def _affinity(r: Replica, prefix_tokens, hash_cache: dict) -> float:
        """Cached-prefix overlap between one request and one replica:
        the number of CONTIGUOUS-from-the-root block-aligned prefix
        hashes of ``prefix_tokens`` present in the replica's advertised
        digest (``/healthz prefix_hashes``).  Contiguity is the cache's
        own usability rule — a cached block is only reachable under its
        ancestors — so the count is the prefill this replica would
        actually skip.  Hashes are computed per advertised block size
        and memoised in ``hash_cache`` across the pool walk."""
        if not prefix_tokens or not r.prefix_hashes or r.prefix_block <= 0:
            return 0.0
        if r.prefix_block not in hash_cache:
            from paddlefleetx_tpu_torch.core.paged_cache import prefix_digest_hashes

            hash_cache[r.prefix_block] = prefix_digest_hashes(
                prefix_tokens, r.prefix_block
            )
        overlap = 0
        for hx in hash_cache[r.prefix_block]:
            if hx not in r.prefix_hashes:
                break
            overlap += 1
        return float(overlap)

    def pick(self, role: str, remaining_s: float,
             exclude: Optional[set] = None,
             prefix_tokens=None) -> Replica:
        """The routing decision: least-loaded eligible replica of the
        pool (round-robin tiebreak).  ``prefix_tokens`` (the request's
        prompt ids, when the front door has them) folds prefix affinity
        into the score — capped, so it steers ties toward the replica
        already holding the prefill and never outweighs load or
        deadline feasibility.  Raises :class:`NoReplicaAvailable` when
        the pool has no eligible member."""
        hash_cache: dict = {}
        with self._lock:
            pool = [
                r for r in self.replicas.values()
                if r.role == role and r.eligible()
                and (not exclude or r.key not in exclude)
            ]
            if not pool:
                raise NoReplicaAvailable(
                    f"no eligible {role} replica "
                    f"({len(self.replicas)} configured)"
                )
            self._rr += 1
            rr = self._rr
            best = min(
                enumerate(pool),
                key=lambda ir: (
                    self._score(
                        ir[1], remaining_s,
                        affinity=self._affinity(
                            ir[1], prefix_tokens, hash_cache
                        ),
                    ),
                    (ir[0] + rr) % len(pool),
                ),
            )[1]
            best.in_flight += 1
            return best

    def dispatch(self, method: str, path: str, body: Optional[bytes], *,
                 role: str, deadline_s: float, headers=None,
                 trace=None, exclude: Optional[set] = None, sink=None,
                 prefix_tokens=None) -> Tuple[int, bytes, str]:
        """Route one request: pick -> forward -> account.  Bounded retry
        on ANOTHER replica only for connection-refused and provably-
        unsent sends (:class:`RequestNotSent` — the transport failed
        before the request line went out, so nothing downstream saw
        it); NEVER after a partial exchange; every attempt's routing
        decision lands on the request's trace.  ``exclude`` seeds the never-pick set (the
        handoff failover ladder excludes a replica that already failed
        mid-exchange — a fallback must not replay AT it).  Raises
        :class:`NoReplicaAvailable` / :class:`ReplicaUnavailable` (the
        latter carrying ``replica_key``) for the transport layer to turn
        into 503.

        ``sink`` streams a 200 body through unbuffered (see
        :func:`_http_request`); the retry ladder is unaffected because
        both retryable classes fail before any body byte flows.  The
        callee's span summaries then ride the stream's terminal
        ``event: summary`` frame instead of the ``X-Span-Summary``
        header (which is already on the wire before the spans close)
        and are stitched from :func:`stream_summary` of the returned
        tail."""
        deadline_abs = time.monotonic() + float(deadline_s)
        seeded: set = set(exclude or ())
        tried: set = set(seeded)
        attempt = 0
        while True:
            remaining = deadline_abs - time.monotonic()
            if remaining <= 0:
                raise ReplicaUnavailable(
                    f"deadline {deadline_s:g}s exhausted before dispatch"
                )
            try:
                r = self.pick(role, remaining, exclude=tried,
                              prefix_tokens=prefix_tokens)
            except NoReplicaAvailable:
                # count only replicas THIS dispatch contacted as
                # attempts — caller-seeded exclusions were never tried
                # here, and claiming they refused misleads the operator
                attempts = sorted(tried - seeded)
                if attempts or seeded:
                    raise NoReplicaAvailable(
                        f"no eligible {role} replica left after "
                        f"{len(attempts)} failed attempt(s) "
                        f"(tried {attempts}; excluded {sorted(seeded)})"
                    ) from None
                raise
            if trace is not None:
                trace.event(
                    "route", replica=r.key, role=role, depth=r.depth,
                    in_flight=r.in_flight, attempt=attempt,
                )
            t0 = time.monotonic()
            try:
                status, data, ctype, resp_headers = _http_request(
                    r.url, method, path, body=body,
                    # the propagation headers (X-Trace-Id/X-Parent-Span)
                    # make the callee force-sample its leg and return a
                    # span summary for the stitched timeline
                    headers={**(headers or {}),
                             **outbound_trace_headers(trace, path)},
                    timeout=remaining + 5.0, sink=sink,
                )
            except ConnectionRefusedError:
                with self._lock:
                    r.in_flight -= 1
                    r.failures += 1
                    # refuse NOW rather than waiting eject_after polls:
                    # nothing listens on that port
                    if r.state not in ("gone", "draining"):
                        self._transition(
                            r, "gone", "connection refused on dispatch"
                        )
                self._requests(r.key, "refused").inc()
                tried.add(r.key)
                if attempt < self.retries:
                    attempt += 1
                    self._retries_ctr.inc()
                    if trace is not None:
                        trace.event("retry", replica=r.key, attempt=attempt)
                    continue
                raise NoReplicaAvailable(
                    f"all {role} dispatch attempts refused "
                    f"(tried {sorted(tried - seeded)}; "
                    f"excluded {sorted(seeded)})"
                ) from None
            except RequestNotSent as e:
                # nothing downstream saw the request (the class's own
                # contract — transport failed BEFORE the request line
                # went out), so unlike a reply lost mid-exchange a
                # bounded retry on ANOTHER replica can never replay
                # anything
                with self._lock:
                    r.in_flight -= 1
                    r.failures += 1
                self._requests(r.key, "unsent").inc()
                tried.add(r.key)
                if attempt < self.retries:
                    attempt += 1
                    self._retries_ctr.inc()
                    if trace is not None:
                        trace.event("retry", replica=r.key,
                                    attempt=attempt)
                    continue
                e.replica_key = r.key
                raise
            except ReplicaUnavailable as e:
                with self._lock:
                    r.in_flight -= 1
                self._requests(r.key, "lost").inc()
                e.replica_key = r.key
                raise
            dt = time.monotonic() - t0
            with self._lock:
                r.in_flight -= 1
                r.last_latency_s = dt
            get_registry().histogram(
                "pfx_router_replica_latency_seconds", replica=r.key
            ).observe(dt)
            self._requests(r.key, str(status)).inc()
            if trace is not None:
                trace.event("routed", replica=r.key, code=status,
                            seconds=round(dt, 4))
                # stitch the callee's span summaries (possibly a relay
                # chain: prefill appends its own to the decode leg's)
                # into the timeline, skew-bounded by THIS exchange's
                # request/response envelope (the tracing.py skew rule)
                raw = resp_headers.get(SPAN_SUMMARY_HEADER)
                if raw:
                    t_recv = time.monotonic()
                    for s in parse_span_summaries(raw):
                        trace.add_remote_summary(s, t_send=t0,
                                                 t_recv=t_recv)
                elif sink is not None and status == 200:
                    # streamed leg: summaries arrive in-band, in the
                    # terminal summary frame retained in the tail
                    t_recv = time.monotonic()
                    for s in stream_summary(data).get("spans") or []:
                        trace.add_remote_summary(s, t_send=t0,
                                                 t_recv=t_recv)
            return status, data, ctype

    # -- disaggregated prefill -> decode --------------------------------
    def _handoff_one(self, prompt: List[int], max_tokens: Optional[int],
                     deadline_abs: float, deadline_s: float,
                     trace=None,
                     extra_headers: Optional[Dict[str, str]] = None
                     ) -> List[int]:
        """One prompt's prefill -> handoff -> decode chain, under the
        failover ladder (docs/serving.md "Disaggregated operations"):

        - the PREFILL leg is stateless (blocks free on export, nothing
          client-visible happened), so a prefill replica lost
          mid-exchange is simply retried on ANOTHER prefill replica —
          handled inside :meth:`_dispatch_prefill`.  Under the direct
          transport the lost attempt's decode leg MAY already have run;
          the retry then duplicates bounded, deterministic decode work
          (client-correct either way) and prefers a clean decode
          replica for its fresh ticket.
        - the DECODE leg is not: after ``adopt`` the row lives in one
          replica's arena, and a request is NEVER replayed at a replica
          that saw its bytes (the rule).  A decode replica lost
          after the exchange started triggers ONE bounded re-prefill
          fallback — the whole chain re-runs through a healthy pair with
          the dead replica excluded — when the deadline allows; an
          honest 503 otherwise.  Greedy decode is deterministic, so a
          fallback that succeeds is token-identical to the answer the
          dead replica would have given."""
        excluded: set = set()
        fellback = False
        while True:
            try:
                return self._handoff_chain(
                    prompt, max_tokens, deadline_abs, deadline_s,
                    trace, excluded, extra_headers=extra_headers,
                )
            except _DecodeDied as e:
                if e.replica_key:
                    excluded.add(e.replica_key)
                remaining = deadline_abs - time.monotonic()
                if fellback:
                    raise ReplicaUnavailable(
                        f"decode replica lost after adoption and the "
                        f"re-prefill fallback also failed ({e}); not "
                        "retried further"
                    ) from e
                if remaining <= 0:
                    raise ReplicaUnavailable(
                        f"decode replica lost after adoption ({e}); "
                        f"deadline {deadline_s:g}s leaves no room for a "
                        "re-prefill fallback"
                    ) from e
                with self._lock:
                    any_decode = any(
                        r.role == "decode" and r.eligible()
                        and r.key not in excluded
                        for r in self.replicas.values()
                    )
                if not any_decode:
                    # the chain's decode pick could only 503 — don't
                    # burn a full prefill (seconds of compute + an
                    # arena reservation) proving it
                    raise NoReplicaAvailable(
                        f"decode replica lost after adoption ({e}); no "
                        "eligible decode replica left for the "
                        "re-prefill fallback"
                    ) from e
                fellback = True
                self._failovers("decode").inc()
                logger.warning(
                    f"{self.name}: decode replica "
                    f"{e.replica_key or '?'} lost after adoption; "
                    f"re-prefill fallback through a healthy pair "
                    f"({remaining:.1f}s left)"
                )
                if trace is not None:
                    trace.event("handoff_failover", leg="decode",
                                excluded=sorted(excluded))

    def _dispatch_prefill(self, req: Dict[str, Any], deadline_abs: float,
                          deadline_s: float, trace=None,
                          exclude_decode: Optional[set] = None,
                          extra_headers: Optional[Dict[str, str]] = None
                          ) -> Tuple[int, bytes, str, Optional[str]]:
        """The prefill leg: dispatch with the STATELESS retry — a
        prefill replica lost mid-exchange never produced anything a
        client saw (its export blocks free either way), so unlike
        /generate and /decode the request is safely re-run on another
        prefill replica, bounded by ``retries``.

        Under the direct transport a FRESH placement ticket is issued
        per attempt (returned as the 4th element): a retry must not
        reuse the previous attempt's ticket — its decode replica may
        have died or been ejected since, and its deadline budget has
        burned down with the lost attempt.  A lost attempt's ticket is
        also POSSIBLY DIRTY: the direct decode leg may have run before
        the prefill replica died, leaving an orphaned adoption in that
        decode replica's arena, so the retry prefers a different decode
        replica when one is eligible (never at the cost of
        availability — with only the dirty replica left, it is reused:
        a duplicate adoption is bounded, deterministic, and client-
        correct, unlike a 503 for a healthy pool)."""
        lost: set = set()
        dirty: set = set()
        while True:
            remaining = deadline_abs - time.monotonic()
            if remaining <= 0:
                raise ReplicaUnavailable(
                    f"deadline {deadline_s:g}s exhausted during prefill"
                )
            req["deadline_s"] = remaining
            ticket = None
            if self.handoff == "direct":
                # placement ticket: the router still makes the routing
                # decision (it sees every decode replica's queue +
                # arena), but the payload bytes flow prefill -> decode
                # directly
                try:
                    ticket = self.pick(
                        "decode", remaining,
                        exclude=(set(exclude_decode or ()) | dirty)
                        or None,
                    )
                except NoReplicaAvailable:
                    if not dirty:
                        raise
                    ticket = self.pick("decode", remaining,
                                       exclude=exclude_decode or None)
                req["forward"] = {"url": ticket.url,
                                  "deadline_s": remaining}
                if trace is not None:
                    trace.event("handoff_ticket", decode=ticket.key)
            try:
                status, payload, ctype = self.dispatch(
                    "POST", "/prefill", json.dumps(req).encode(),
                    role="prefill", deadline_s=remaining,
                    # extra_headers carries tenant/priority VERBATIM on
                    # every retry attempt of this stateless leg
                    headers={"Content-Type": "application/json",
                             **(extra_headers or {}),
                             **admin_headers()},
                    trace=trace, exclude=lost,
                )
                return (status, payload, ctype,
                        ticket.key if ticket is not None else None)
            except RequestNotSent:
                # dispatch() already ran the bounded retry-on-another-
                # replica for provably-unsent sends (the class's own
                # contract); exhaustion there is final.  Re-looping
                # here would multiply attempts retries-fold and count
                # sends that never went out as mid-exchange failovers.
                raise
            except ReplicaUnavailable as e:
                key = e.replica_key
                if key is None or len(lost) >= self.retries:
                    raise
                lost.add(key)
                if ticket is not None:
                    # a mid-exchange loss leaves the ticket possibly
                    # dirty: the direct decode leg may have run before
                    # the prefill replica died
                    dirty.add(ticket.key)
                self._failovers("prefill").inc()
                logger.warning(
                    f"{self.name}: prefill replica {key} lost "
                    "mid-exchange; retrying on another (stateless leg)"
                )
                if trace is not None:
                    trace.event("handoff_failover", leg="prefill",
                                replica=key)
            finally:
                if ticket is not None:
                    with self._lock:
                        ticket.in_flight -= 1

    def _handoff_chain(self, prompt: List[int],
                       max_tokens: Optional[int], deadline_abs: float,
                       deadline_s: float, trace,
                       exclude_decode: set,
                       extra_headers: Optional[Dict[str, str]] = None
                       ) -> List[int]:
        """One attempt of the prefill -> handoff -> decode chain.
        Raises :class:`_DecodeDied` when the decode leg was lost after
        bytes were exchanged (the caller decides on the re-prefill
        fallback)."""
        remaining = deadline_abs - time.monotonic()
        if remaining <= 0:
            raise ReplicaUnavailable(
                f"deadline {deadline_s:g}s exhausted mid-request"
            )
        t0 = time.monotonic()
        req: Dict[str, Any] = {
            "prompt_ids": prompt, "deadline_s": remaining,
        }
        if max_tokens is not None:
            # omitted -> the replica's configured default decides
            req["max_tokens"] = int(max_tokens)
        status, payload, ctype, ticket_key = self._dispatch_prefill(
            req, deadline_abs, deadline_s, trace=trace,
            exclude_decode=exclude_decode, extra_headers=extra_headers,
        )
        if ticket_key is not None and ctype.startswith("application/json"):
            # the prefill replica completed (or definitively failed) the
            # direct leg: the payload bytes never transited this process
            try:
                obj = json.loads(payload or b"{}")
            except json.JSONDecodeError:
                obj = {}
            if status == 200 and "completion_ids" in obj:
                dt = time.monotonic() - t0
                self._handoff_hist.observe(dt)
                # the router never dispatches to the ticketed decode
                # replica under direct transport, so its deadline-aware
                # score would otherwise run on the initial-latency
                # floor forever: stamp the chain duration as a
                # conservative (whole-chain) upper bound on its
                # per-request latency
                with self._lock:
                    rep = self.replicas.get(ticket_key)
                    if rep is not None:
                        rep.last_latency_s = dt
                if trace is not None:
                    trace.event("handoff", direct=True)
                return obj["completion_ids"]
            if obj.get("handoff_leg") == "decode":
                # the decode replica died mid-direct-exchange: the row
                # may be adopted there — never replayed at it
                raise _DecodeDied(
                    ticket_key,
                    obj.get("error", "direct decode leg lost"),
                )
            if status == 200:
                # a 200 relay whose body is unparseable or carries no
                # completion is NOT a success — relaying it verbatim
                # would hand the client a silent wrong-200
                raise _DownstreamError(502, json.dumps({
                    "error": "malformed direct-transfer relay: 200 "
                             "without completion_ids",
                }).encode())
            # the prefill replica's own verdict (400/429/503/...), or a
            # decode rejection it relayed — hand it to the client
            raise _DownstreamError(status, payload)
        if status != 200:
            raise _DownstreamError(status, payload)
        # octet-stream: the proxy leg — either proxy mode, or a direct
        # send that failed BEFORE any decode replica read it (refused /
        # drop / non-200), which is safe to carry to any decode replica
        self._handoff_bytes.inc(len(payload))
        self._handoff_hist.observe(time.monotonic() - t0)
        if trace is not None:
            trace.event("handoff", bytes=len(payload))
        remaining = deadline_abs - time.monotonic()
        if remaining <= 0:
            raise ReplicaUnavailable(
                f"deadline {deadline_s:g}s exhausted after prefill"
            )
        excludes = [set(exclude_decode or ())]
        if ticket_key is not None and ticket_key not in excludes[0]:
            # the ticketed replica just failed or rejected the direct
            # send (refused / drop / 429 / 503): prefer ANY other
            # decode replica for the proxy carry — re-offering the
            # payload to the replica that just bounced it wastes the
            # fallback; fall back to it only over 503ing a pool with
            # nothing else eligible
            excludes.insert(0, excludes[0] | {ticket_key})
        for i, exc in enumerate(excludes):
            try:
                status, body, _ = self.dispatch(
                    "POST", f"/decode?deadline_s={remaining:.3f}",
                    payload,
                    role="decode", deadline_s=remaining,
                    headers={"Content-Type": "application/octet-stream",
                             "X-Handoff-Transport": "proxy",
                             **(extra_headers or {}),
                             **admin_headers()},
                    trace=trace, exclude=exc or None,
                )
                break
            except NoReplicaAvailable:
                if i + 1 < len(excludes):
                    continue
                raise
            except RequestNotSent:
                # provably unsent (dispatch already retried other
                # replicas): no decode replica saw the payload, so this
                # is an honest 503 — NOT a phantom adoption worth
                # burning the one re-prefill fallback on
                raise
            except ReplicaUnavailable as e:
                if e.replica_key is None:
                    # dispatch never completed an exchange with any
                    # decode replica (deadline ran out between
                    # attempts): an honest 503, not an adoption claim
                    raise
                # deliberate: the payload is still in hand here, but the
                # fallback re-runs the WHOLE chain (re-prefill) instead
                # of re-offering these bytes to another decode replica —
                # one failover rung shared with the direct transport
                # (where the router never holds the payload) keeps the
                # ladder and its drill matrix uniform; the extra prefill
                # only costs on the rare proxy-transport decode death
                raise _DecodeDied(e.replica_key, str(e)) from e
        if status != 200:
            raise _DownstreamError(status, body)
        return json.loads(body)["completion_ids"]

    def generate_disaggregated(self, prompts_ids: List[List[int]],
                               max_tokens: Optional[int], deadline_s: float,
                               trace=None,
                               extra_headers: Optional[Dict[str, str]] = None
                               ) -> List[List[int]]:
        """Serve one request through the split pools: per prompt, a
        prefill replica exports the KV-handoff payload and a decode
        replica adopts it and decodes.  A plural request runs its
        prompts' chains CONCURRENTLY (the decode replica batches the
        rows at its own step boundaries anyway — serializing here would
        regress plural latency linearly in prompt count).  Raises
        :class:`_DownstreamError` carrying the downstream (status, body)
        on a non-200 leg."""
        deadline_abs = time.monotonic() + float(deadline_s)
        if len(prompts_ids) == 1:
            return [self._handoff_one(
                prompts_ids[0], max_tokens, deadline_abs, deadline_s,
                trace=trace, extra_headers=extra_headers,
            )]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(len(prompts_ids), 8),
            thread_name_prefix=f"{self.name}-handoff",
        ) as pool:
            futs = [
                pool.submit(self._handoff_one, p, max_tokens,
                            deadline_abs, deadline_s, trace,
                            extra_headers)
                for p in prompts_ids
            ]
            return [f.result() for f in futs]

    # -- rolling drain ---------------------------------------------------
    def drain(self, replica_key: Optional[str] = None) -> Dict[str, Any]:
        """Initiate a drain-one-replica deploy step: mark the replica
        ineligible (no new traffic) and POST the authenticated
        ``/admin/drain`` to it (shared ``PFX_ADMIN_TOKEN`` — the remote
        transport that makes rolling deploys work CROSS-HOST); the serve CLI's
        drain contract finishes its admitted work and exits 0, and the
        poller walks it draining -> gone.  A replica that predates
        ``/admin/drain`` (404) falls back to SIGTERM on its identity
        pid — same-host topologies only.  Picks the least-loaded serving
        replica when none is named.  Raises ValueError when the target
        does not exist / is already gone, or when the drain provably
        did NOT land — auth rejected, 404 with no safe local-pid
        fallback, any other non-200 — in which case the target is first
        RESTORED to rotation: a failed drain must not blackhole a
        healthy replica while reporting success."""
        with self._lock:
            if replica_key is None:
                candidates = [
                    r for r in self.replicas.values()
                    if r.state == "serving" and not r.drain_requested
                ]
                if not candidates:
                    raise ValueError("no serving replica left to drain")
                target = min(candidates,
                             key=lambda r: r.depth + r.in_flight)
            else:
                target = None
                for r in self.replicas.values():
                    if replica_key in (r.key, r.replica_id):
                        target = r
                        break
                if target is None:
                    raise ValueError(
                        f"unknown replica {replica_key!r} "
                        f"(known: {sorted(self.replicas)})"
                    )
            if target.state == "gone":
                raise ValueError(f"replica {target.key} is already gone")
            prev_state = target.state
            target.drain_requested = True
            self._transition(target, "draining", "drain requested")
            pid = target.pid
            key = target.key
            url = target.url
            # identity as recorded BEFORE the drain: the legacy SIGTERM
            # fallback below must confirm the process answering on the
            # url is still this incarnation before signalling its pid
            rid_ident = target.replica_id
            boot_ident = target.boot_id
            # surviving same-pool peers, least-loaded first: the drain
            # body names them so the draining replica can ship its
            # hottest cached prefixes to one before exiting (KV
            # migration, docs/serving.md "KV lifecycle").  Best-effort
            # on the replica side — an empty list just skips migration.
            survivors = sorted(
                (
                    r for r in self.replicas.values()
                    if r.key != target.key and r.role == target.role
                    and r.state == "serving" and not r.drain_requested
                ),
                key=lambda r: r.depth + r.in_flight,
            )
            migrate_to = [r.url for r in survivors]
        def _restore(why: str) -> None:
            # a drain that provably did NOT land must put the target
            # back in rotation — leaving it marked draining would
            # blackhole a healthy replica while reporting success
            with self._lock:
                target.drain_requested = False
                self._transition(target, prev_state, why)

        # the HTTP leg runs OUTSIDE the lock (the poll loop and /metrics
        # collectors take it; a slow replica must not wedge them).  The
        # drain hop rides the fleet propagation headers like every other
        # inter-process hop: a sampled "drain" trace records who was
        # asked and what came back, and the replica can tie its
        # drain_start flight event to the operator action that caused it
        status: Optional[int] = None
        drain_trace = get_trace_buffer().maybe_start(
            "drain", replica=key, url=url,
        )
        outcome = "answered"
        try:
            status, body, _, _ = _http_request(
                url, "POST", "/admin/drain",
                body=json.dumps({"migrate_to": migrate_to}).encode(),
                headers={"Content-Type": "application/json",
                         **admin_headers(),
                         **outbound_trace_headers(drain_trace,
                                                  "/admin/drain")},
                timeout=max(self.poll_timeout_s, 5.0),
            )
        except ConnectionRefusedError:
            outcome = "refused"
            with self._lock:
                self._transition(target, "gone",
                                 "refused the drain call: already exited")
        except RequestNotSent as e:
            # the request never went out (connect stall / send failure):
            # nothing downstream saw it — back in rotation, loudly
            outcome = "not_sent"
            _restore("drain POST not sent")
            raise ValueError(
                f"drain POST to {key} could not be sent ({e}); the "
                "replica was left in rotation — retry when the network "
                "settles"
            ) from e
        except ReplicaUnavailable as e:
            # bytes were exchanged: the drain may have landed — leave the
            # replica draining and let the poller decide (it walks a
            # drained process to gone, and a redeploy clears the flag)
            outcome = "lost_mid_exchange"
            logger.warning(
                f"{self.name}: drain POST to {key} lost mid-exchange "
                f"({e}); leaving it draining for the poller"
            )
        finally:
            # the outcome lands on the trace on EVERY path — a failed
            # drain is exactly when the postmortem trail matters
            if drain_trace is not None:
                drain_trace.event("drain_answered", code=status,
                                  outcome=outcome)
                drain_trace.finish()

        if status in (401, 403):
            _restore("drain auth rejected")
            raise ValueError(
                f"replica {key} rejected the drain auth (HTTP {status}); "
                f"set the same {ADMIN_TOKEN_ENV} on the router and every "
                "replica (docs/serving.md)"
            )
        if status == 404:
            if pid is not None and _local_url(url):
                # pre-/admin replica on THIS host: the legacy SIGTERM
                # transport (a pid from another host must never be
                # signalled here — it names an unrelated local process).
                # NEVER on the bare pid: a /healthz re-probe must confirm
                # the process answering on the url is still the recorded
                # incarnation (pid + replica_id + boot_id when published)
                # — between the last poll and now the pid could have
                # exited and been recycled by an unrelated process
                confirmed = False
                exited = False
                try:
                    st2, body2, _, _ = _http_request(
                        url, "GET", "/healthz",
                        timeout=self.poll_timeout_s)
                    ident2 = ((json.loads(body2) or {}).get("identity")
                              or {}) if st2 == 200 else {}
                    confirmed = (
                        ident2.get("pid") == pid
                        and (not rid_ident
                             or ident2.get("replica_id")
                             in (None, rid_ident))
                        and (not boot_ident
                             or ident2.get("boot_id")
                             in (None, boot_ident)))
                except ConnectionRefusedError:
                    exited = True
                except Exception:  # noqa: BLE001 — treat as unconfirmed
                    confirmed = False
                if exited:
                    with self._lock:
                        self._transition(
                            target, "gone",
                            "refused the identity re-probe: "
                            "already exited")
                elif not confirmed:
                    _restore("identity re-probe mismatch")
                    raise ValueError(
                        f"replica {key} has no /admin/drain (404) and "
                        f"the /healthz identity re-probe did not match "
                        f"the recorded incarnation (pid {pid}, "
                        f"boot_id {boot_ident}); refusing to SIGTERM a "
                        "possibly-recycled pid — drain it on its own "
                        "host"
                    )
                else:
                    logger.warning(
                        f"{self.name}: {key} has no /admin/drain (404); "
                        f"falling back to SIGTERM on identity pid {pid} "
                        "(same-host only, identity re-probe confirmed)"
                    )
                    try:
                        os.kill(pid, signal.SIGTERM)
                    except ProcessLookupError:
                        with self._lock:
                            self._transition(target, "gone",
                                             "pid already exited")
            else:
                _restore("no drain transport")
                raise ValueError(
                    f"replica {key} has no /admin/drain (404) and cannot "
                    f"be signalled (pid {pid}, url {url} "
                    f"{'local' if _local_url(url) else 'NOT local'}); "
                    "upgrade the replica or drain it on its own host"
                )
        elif status is not None and status != 200:
            _restore(f"drain refused (HTTP {status})")
            raise ValueError(
                f"replica {key} answered the drain POST with HTTP "
                f"{status}; it was left in rotation"
            )
        self._drains_ctr.inc()
        logger.info(f"{self.name}: drain initiated for {key} ({url})")
        return {"replica": key, "pid": pid, "state": target.state}

    # -- views -----------------------------------------------------------
    def replica_views(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.view() for r in self.replicas.values()]

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {k: r.state for k, r in self.replicas.items()}

    def tenant_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant front-door view for /replicas and the fleet log:
        label-folded in-flight plus the configured quota knobs (None =
        unlimited).  Config-declared tenants always appear, so a quiet
        gold tenant is visible as quiet rather than absent."""
        rows: Dict[str, Dict[str, Any]] = {}
        for tn in self.tenant_config.known_tenants():
            lab = self._tenant_labels.label(tn)
            pol = self.tenant_config.policy(tn)
            rows[lab] = {
                "in_flight": 0,
                "weight": pol.weight,
                "rps": pol.rps,
                "max_inflight": pol.max_inflight,
            }
        for tn, n in self._tenant_admission.inflight_snapshot().items():
            lab = self._tenant_labels.label(tn)
            row = rows.setdefault(lab, {"in_flight": 0})
            row["in_flight"] = int(row.get("in_flight", 0)) + int(n)
        return rows


class _DownstreamError(RuntimeError):
    """A non-200 from a prefill/decode leg, propagated verbatim so the
    front door can hand the client the replica's own status + error."""

    def __init__(self, status: int, body: bytes) -> None:
        super().__init__(f"downstream {status}")
        self.status = int(status)
        self.body = bytes(body)


class _DecodeDied(RuntimeError):
    """The decode leg was lost AFTER bytes were exchanged — the payload
    may be adopted (and decoding) in the dead replica's arena, so it is
    NEVER replayed there.  ``_handoff_one`` answers with one bounded
    re-prefill fallback through a healthy pair, or an honest 503."""

    def __init__(self, replica_key: Optional[str], msg: str) -> None:
        super().__init__(msg)
        self.replica_key = replica_key
