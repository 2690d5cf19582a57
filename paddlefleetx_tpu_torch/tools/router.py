"""The serving fleet's front door: route client traffic across N
``paddlefleetx_tpu_torch.tools.serve`` replicas (``core/router.py``), with
queue-aware load balancing, replica health management, rolling drains and
the disaggregated prefill/decode topology.

A copy of the JAX package's ``tools/router.py`` that imports only this
package: the HTTP contract is the JAX router's, so either router fronts
either package's replicas.

Two topologies:

  replicated     N monolith replicas; each POST /generate goes to the
                 least-loaded serving replica (bounded retry of sends that
                 provably never arrived; a partial exchange answers an
                 honest 503, never a replay).
  disaggregated  --prefill and --decode pools: each prompt prefills on a
                 prefill replica and a decode replica adopts its KV and
                 decodes on (greedy tokens identical to one continuous
                 replica).  ``--handoff direct`` (default): the router
                 issues a placement ticket and the prefill replica POSTs
                 the payload straight to the chosen decode replica, so the
                 payload bytes never cross the router; ``--handoff
                 proxy``: the router carries them.  A prefill replica lost
                 mid-exchange is retried on another; a decode replica lost
                 after adoption triggers one re-prefill through a healthy
                 pair when the deadline allows, an honest 503 otherwise.

The router owns front-door admission (``--max-inflight`` -> 429, draining
-> 503, per-tenant quotas from ``--tenants``, deadlines checked before
every dispatch) and mirrors the serve CLI's drain contract: SIGTERM stops
admission, in-flight requests finish, exit 0; a second signal
force-quits.  ``--router-id`` names it; its journal
(``$PFX_FLIGHT_DIR/fleet_state.jsonl``) and fleet log
(``fleet_metrics.jsonl``) land under the flight directory.

Elastic control plane (``--supervise``, ``core/controller.py``): the
router spawns its replicas itself as managed subprocesses from a command
template, one log file each under ``--replica-log-dir`` (default
``$PFX_FLIGHT_DIR/replicas``): crash-restart with exponential backoff, a
flap budget that quarantines a crash-looping replica loudly, warm boot
through ``--compile-cache-dir`` (the replicas share one kernel-library
directory), breach / depth / occupancy-driven scale-up, idle scale-down
through the authenticated remote drain, every decision in a bounded
replayable log (``GET /debug/controller``).  ``--prefill-cmd`` /
``--decode-cmd`` run one supervisor and controller per pool (prefill on
depth and TTFT burn, decode on arena occupancy and ``available_blocks``).
A router restarted on the same ports and flight directory re-adopts the
live replicas its journal names and resumes the controller's clocks.

Usage:
  # replicated
  python -m paddlefleetx_tpu_torch.tools.router --port 9000 \
      --replica http://127.0.0.1:8001 --replica http://127.0.0.1:8002
  # disaggregated
  python -m paddlefleetx_tpu_torch.tools.router --port 9000 \
      --prefill http://127.0.0.1:8001 --decode http://127.0.0.1:8002
  # supervised + autoscaled (the elastic control plane)
  python -m paddlefleetx_tpu_torch.tools.router --port 9000 --supervise \
      --replica-cmd "python -m paddlefleetx_tpu_torch.tools.serve -c cfg.yaml \
                     --port {port} --replica-id {replica_id}" \
      --min-replicas 1 --max-replicas 4 --base-port 8101 \
      --compile-cache-dir build/torch_kernels
  # supervised disaggregated pools
  python -m paddlefleetx_tpu_torch.tools.router --port 9000 --supervise \
      --prefill-cmd "python -m paddlefleetx_tpu_torch.tools.serve -c cfg.yaml \
                     --role prefill --port {port} --replica-id {replica_id}" \
      --decode-cmd "python -m paddlefleetx_tpu_torch.tools.serve -c cfg.yaml \
                    --role decode --port {port} --replica-id {replica_id}" \
      --min-prefill 1 --max-prefill 4 --min-decode 1 --max-decode 4
  # rolling deploy, one replica at a time (requires the router up):
  python -m paddlefleetx_tpu_torch.tools.router drain \
      --admin http://127.0.0.1:9000 [--replica-id r0]

Endpoints:
  POST /generate        route one request (token-id modes only when
                        disaggregated: the router has no tokenizer)
  GET  /healthz         router health + per-replica lifecycle states
  GET  /metrics         Prometheus exposition (pfx_router_*, the
                        federated pfx_fleet_* samples)
  GET  /replicas        per-replica view (identity, scores)
  POST /admin/drain     drain one replica (body: {"replica": id})
  POST /admin/register  a replica's self-registration heartbeat
  POST /admin/profile   fan a profiler capture out to live replicas
  GET  /debug/traces    sampled routing timelines (Perfetto JSON)
  GET  /debug/trace?id= one stitched fleet timeline
  GET  /debug/controller  scale policy + decision log + supervised slots

/admin/* and /debug/* are gated by the fleet-shared ``PFX_ADMIN_TOKEN``
bearer token (unset = loopback only, loudly); drains ride the same token
to each replica's ``POST /admin/drain``.
"""

import argparse
import json
import math
import os
import sys
import time



def serve_router(args) -> int:
    import signal
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from paddlefleetx_tpu_torch.core.controller import (
        ElasticController,
        ReplicaSupervisor,
        ScalePolicy,
    )
    from urllib.parse import parse_qs, urlsplit

    from paddlefleetx_tpu_torch.core.request_queue import QueueClosed, QueueFull
    from paddlefleetx_tpu_torch.core.router import (
        FleetJournal,
        FleetLog,
        NoReplicaAvailable,
        ReplicaUnavailable,
        RouterCore,
        TenantQuotaExceeded,
        _DownstreamError,
        _http_request,
        admin_headers,
        check_admin,
        read_fleet_journal,
        replay_fleet_state,
    )
    from paddlefleetx_tpu_torch.utils.log import log_server_error
    from paddlefleetx_tpu_torch.core.tenancy import (
        PRIORITY_HEADER,
        TENANT_HEADER,
        TenantConfig,
    )
    from paddlefleetx_tpu_torch.utils.telemetry import (
        flight_dir,
        get_flight_recorder,
        get_registry,
    )
    from paddlefleetx_tpu_torch.utils import tracing
    from paddlefleetx_tpu_torch.utils.tracing import chrome_trace, get_trace_buffer

    replicas = [(u, "monolith") for u in args.replica]
    replicas += [(u, "prefill") for u in args.prefill]
    replicas += [(u, "decode") for u in args.decode]
    pool_supervise = bool(args.supervise and args.prefill_cmd)
    tenant_config = None
    if getattr(args, "tenants", ""):
        # a bad quota file must fail the boot, not silently admit all
        tenant_config = TenantConfig.from_file(args.tenants)
    core = RouterCore(
        replicas,
        max_inflight=args.max_inflight,
        retries=args.retries,
        poll_interval_s=args.poll_interval,
        eject_after=args.eject_after,
        serve_after=args.serve_after,
        allow_empty=args.supervise,
        handoff=args.handoff,
        tenant_config=tenant_config,
    )
    if pool_supervise:
        # the supervised pools register as they spawn; pin the topology
        # now so the first /generate routes disaggregated (add_replica
        # keeps it consistent from then on)
        core.disaggregated = True
    log_dir = args.replica_log_dir or os.path.join(flight_dir(), "replicas")
    shared_policy = dict(
        high_depth=args.scale_high_depth,
        low_depth=args.scale_low_depth,
        up_cooldown_s=args.scale_up_cooldown,
        down_cooldown_s=args.scale_down_cooldown,
        idle_s=args.scale_idle,
        interval_s=args.control_interval,
    )
    shared_sup = dict(
        compile_cache_dir=args.compile_cache_dir,
        log_dir=log_dir,
        backoff_base_s=args.restart_backoff,
        flap_budget=args.flap_budget,
        flap_window_s=args.flap_window,
    )
    controllers = []
    if pool_supervise:
        # role-aware pool supervision (docs/serving.md "Disaggregated
        # operations"): one supervisor + controller per pool, each on
        # its own port range and replica-id prefix, with pool-specific
        # scale signals — prefill watches queue depth + TTFT burn (its
        # replicas hold no decode arena), decode watches arena
        # occupancy + available_blocks (its queue drains at step
        # boundaries; the arena is what actually bounces adoptions)
        specs = (
            ("prefill", args.prefill_cmd, args.prefill_base_port,
             args.min_prefill, args.max_prefill, "p",
             # under the direct transport a prefill dispatch stays
             # in-flight through the whole prefill->decode relay, so
             # router-side in-flight would scale the prefill pool on
             # DECODE duration — count replica-reported queue depth only
             dict(use_occupancy=False,
                  count_in_flight=args.handoff != "direct")),
            ("decode", args.decode_cmd, args.decode_base_port,
             args.min_decode, args.max_decode, "d",
             dict(use_depth=False, low_blocks=args.decode_low_blocks)),
        )
        for role, cmd, base_port, mn, mx, prefix, signals in specs:
            supervisor = ReplicaSupervisor(
                cmd, base_port=base_port, max_replicas=mx, role=role,
                slot_prefix=prefix, **shared_sup,
            )
            controllers.append(ElasticController(
                core, supervisor,
                ScalePolicy(min_replicas=mn, max_replicas=mx,
                            **shared_policy, **signals),
                role=role,
            ))
    elif args.supervise:
        supervisor = ReplicaSupervisor(
            args.replica_cmd,
            base_port=args.base_port,
            max_replicas=args.max_replicas,
            **shared_sup,
        )
        controllers.append(ElasticController(
            core, supervisor,
            ScalePolicy(
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                **shared_policy,
            ),
        ))
    reg = get_registry()
    recorder = get_flight_recorder()
    recorder.install_excepthook()
    trace_buffer = get_trace_buffer()
    identity = {
        "replica_id": args.router_id or f"{args.host}:{args.port}",
        "role": "router",
        "scheduler": "disaggregated" if core.disaggregated else "replicated",
        "listen": f"{args.host}:{args.port}",
        "pid": os.getpid(),
    }
    tracing.set_process_identity(
        replica_id=identity["replica_id"], role="router",
    )
    # fleet observability artifact: one sample row per replica per poll
    # cadence + controller scale events — what tools/report.py --fleet
    # renders from the router's artifacts alone (crash-tolerant JSONL)
    core.fleet_log = FleetLog(
        os.path.join(flight_dir(), "fleet_metrics.jsonl")
    )
    # crash-consistent control-plane journal (docs/serving.md
    # "Control-plane recovery"): registry transitions, controller scale
    # decisions, supervisor slot facts, and tenant buckets all survive
    # THIS process — the recovery block below folds the previous
    # incarnation's journal back in before the listener opens
    journal_path = os.path.join(flight_dir(), "fleet_state.jsonl")
    journal = FleetJournal(journal_path)
    core.journal = journal
    for ctl in controllers:
        ctl.journal = journal
        ctl.supervisor.journal = journal
    flags = {"draining": False}
    default_deadline = float(args.deadline)
    max_deadline = float(args.max_deadline)
    # one fleet profile capture at a time: each replica already refuses
    # its own overlaps (409), but the router-level guard keeps a second
    # operator from profiling a DIFFERENT slice of the fleet while the
    # first capture is still distorting it
    profile_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        timeout = 120

        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype, headers=None):
            if code >= 500:
                # one structured line per 5xx (utils/log.log_server_error)
                # joinable against the trace timeline by trace_id
                outcome = None
                if ctype == "application/json":
                    try:
                        outcome = json.loads(body.decode()).get("error")
                    except (ValueError, UnicodeDecodeError):
                        pass
                log_server_error(
                    "router", code, self.path,
                    replica_id=identity["replica_id"],
                    tenant=self.headers.get(TENANT_HEADER),
                    trace_id=(headers or {}).get("X-Trace-Id"),
                    outcome=outcome,
                )
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError, TimeoutError):
                reg.counter("pfx_http_client_gone_total").inc()
            else:
                reg.counter("pfx_http_responses_total", code=str(code)).inc()

        def _json(self, code, obj, headers=None):
            self._send(code, json.dumps(obj).encode(), "application/json",
                       headers)

        def _authorized(self, what: str) -> bool:
            """Gate /admin and /debug on the shared PFX_ADMIN_TOKEN
            (core/router.check_admin): token set -> bearer match; unset
            -> loopback-only, loudly.  Answers 401/403 on failure."""
            ok, code, msg = check_admin(
                self.headers, self.client_address, what=what
            )
            if not ok:
                self._json(code, {"error": msg})
            return ok

        def do_GET(self):
            if self.path == "/healthz":
                states = core.states()
                body = {
                    "ok": not flags["draining"],
                    "state": "draining" if flags["draining"] else "ok",
                    "identity": identity,
                    "mode": identity["scheduler"],
                    "in_flight": core.depth(),
                    "replicas": states,
                    "eligible": sum(
                        1 for v in core.replica_views() if v["eligible"]
                    ),
                }
                if len(controllers) == 1:
                    c = controllers[0]
                    body["controller"] = {
                        "target": c.target,
                        "quarantined": c.supervisor.quarantined_count(),
                        "decisions": len(c.decision_log),
                    }
                elif controllers:
                    body["controller"] = {"pools": {
                        c.role: {
                            "target": c.target,
                            "quarantined":
                                c.supervisor.quarantined_count(),
                            "decisions": len(c.decision_log),
                        }
                        for c in controllers
                    }}
                return self._json(200, body)
            if self.path == "/metrics":
                return self._send(
                    200, reg.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            if self.path == "/replicas":
                # per-tenant occupancy ledgers ride the federation scrape
                # (pfx_tenant_*_seconds_total, labels already folded
                # through the replica's top-k cap) — billing-grade cost
                # attribution per replica without a second poll
                views = core.replica_views()
                for v in views:
                    occ = {}
                    for fam, field in (
                        ("pfx_tenant_slot_seconds_total", "slot_s"),
                        ("pfx_tenant_kv_block_seconds_total",
                         "kv_block_s"),
                    ):
                        for lab, val in core.federation.samples(
                            v["key"], fam
                        ):
                            ten = lab.get("tenant", "?")
                            occ.setdefault(
                                ten, {"slot_s": 0.0, "kv_block_s": 0.0}
                            )[field] = val
                    if occ:
                        v["tenant_occupancy"] = occ
                return self._json(200, {
                    "replicas": views,
                    "tenants": core.tenant_snapshot(),
                })
            if self.path.startswith("/debug/"):
                if not self._authorized("/debug"):
                    return
                if self.path == "/debug/traces":
                    return self._json(
                        200, chrome_trace(trace_buffer.traces())
                    )
                parts = urlsplit(self.path)
                if parts.path == "/debug/trace":
                    # ONE stitched timeline: the router's own routing
                    # events plus every hop's remote spans (each naming
                    # its process) on one wall-clock-anchored axis —
                    # the fleet "why is this request slow" entry point
                    tid = (parse_qs(parts.query).get("id") or [""])[0]
                    if not tid:
                        return self._json(
                            400, {"error": "need ?id=<trace_id>"})
                    tc = trace_buffer.get(tid)
                    if tc is None:
                        return self._json(404, {
                            "error": f"trace {tid!r} not in the sampled "
                                     f"window (cap {trace_buffer.cap}, "
                                     f"sample {trace_buffer.sample:g})"
                        })
                    return self._json(200, tc.timeline())
                if self.path == "/debug/controller":
                    if not controllers:
                        return self._json(404, {
                            "error": "no controller: run with --supervise"
                        })
                    if len(controllers) == 1:
                        return self._json(200, controllers[0].view())
                    return self._json(200, {"pools": {
                        c.role: c.view() for c in controllers
                    }})
                return self._json(404, {"error": "unknown debug path"})
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            parts = urlsplit(self.path)
            if parts.path == "/admin/drain":
                return self._admin_drain()
            if parts.path == "/admin/register":
                return self._admin_register()
            if parts.path == "/admin/profile":
                return self._admin_profile()
            if parts.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            return self._generate(parts)

        def _wants_stream(self, parts) -> bool:
            qs = parse_qs(parts.query or "")
            if (qs.get("stream") or [""])[0] not in ("", "0"):
                return True
            return "text/event-stream" in (self.headers.get("Accept") or "")

        def _admin_drain(self):
            if not self._authorized("/admin"):
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                return self._json(400, {"error": f"bad JSON: {e}"})
            try:
                out = core.drain(req.get("replica"))
            except ValueError as e:
                return self._json(409, {"error": str(e)})
            return self._json(200, out)

        def _admin_profile(self):
            """POST /admin/profile — fan an on-demand profiler
            capture out to selected live replicas (optional body
            filters: {"pool": "decode", "replica": "<key|id>"}) and
            aggregate ONE fleet summary: per-replica outcomes plus a
            merged top-op table (docs/observability.md "On-demand
            profiling").  Each replica enforces its own single-capture
            guard and duration cap; the router adds the fleet-level
            overlap guard (409) so two operators cannot profile
            different slices concurrently."""
            if not self._authorized("/admin"):
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                return self._json(400, {"error": f"bad JSON: {e}"})
            seconds = req.get("seconds", 3.0)
            try:
                seconds = float(seconds)
            except (TypeError, ValueError):
                return self._json(
                    400, {"error": f"seconds must be a number, got "
                                   f"{seconds!r}"})
            top = int(req.get("top", 20))
            pool = req.get("pool")
            want = req.get("replica")
            targets = [
                v for v in core.replica_views()
                if v["url"] and v["healthy"]
                and v["state"] in ("serving", "draining")
                and (pool is None or v["role"] == pool)
                and (want is None or want in (v["key"], v["replica_id"]))
            ]
            if not targets:
                return self._json(404, {
                    "error": "no matching live replica to profile "
                             f"(pool={pool!r}, replica={want!r})"
                })
            if not profile_lock.acquire(blocking=False):
                return self._json(409, {
                    "error": "a fleet profile capture is already "
                             "active; retry after it finishes"
                })
            try:
                results = {}

                def _one(v):
                    payload = json.dumps(
                        {"seconds": seconds, "top": top}
                    ).encode()
                    try:
                        code, data, _, _ = _http_request(
                            v["url"], "POST", "/admin/profile",
                            body=payload,
                            headers={"Content-Type": "application/json",
                                     **admin_headers()},
                            # the replica sleeps `seconds` then parses
                            # the trace in pure Python while its decode
                            # threads keep the GIL busy — on a loaded
                            # host the parse, not the capture, is the
                            # long pole, so the headroom is generous
                            timeout=seconds + 180.0,
                        )
                        try:
                            out = json.loads(data.decode())
                        except ValueError:
                            out = {"error": data[:200].decode("replace")}
                        results[v["key"]] = {"status": code, **out}
                    except Exception as e:  # noqa: BLE001 — per-replica
                        results[v["key"]] = {"status": 0, "error": str(e)}

                threads = [
                    threading.Thread(target=_one, args=(v,), daemon=True)
                    for v in targets
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(seconds + 210.0)
                # merge the per-replica op tables into one fleet view:
                # same op name -> summed occurrences/durations
                merged = {}
                device_us = host_us = 0.0
                captured = 0
                for r in results.values():
                    if r.get("status") != 200:
                        continue
                    captured += 1
                    device_us += float(r.get("device_us", 0.0))
                    host_us += float(r.get("host_us", 0.0))
                    for op in r.get("top_ops", []):
                        m = merged.setdefault(op["op"], {
                            "op": op["op"],
                            "category": op.get("category", "?"),
                            "occurrences": 0,
                            "total_us": 0.0, "self_us": 0.0,
                        })
                        m["occurrences"] += int(op.get("occurrences", 0))
                        m["total_us"] += float(op.get("total_us", 0.0))
                        m["self_us"] += float(op.get("self_us", 0.0))
                top_ops = sorted(
                    merged.values(), key=lambda r: -r["self_us"]
                )[:top]
                total_self = sum(r["self_us"] for r in merged.values()) or 1.0
                for op in top_ops:
                    op["self_frac"] = round(op["self_us"] / total_self, 4)
                body = {
                    "requested": len(targets),
                    "captured": captured,
                    "seconds": seconds,
                    "device_us": round(device_us, 1),
                    "host_us": round(host_us, 1),
                    "top_ops": top_ops,
                    "replicas": results,
                }
                recorder.record({
                    "event": "fleet_profile_capture",
                    "requested": len(targets), "captured": captured,
                    "seconds": seconds,
                })
                # every replica failing is a gateway failure, honestly
                return self._json(200 if captured else 502, body)
            finally:
                profile_lock.release()

        def _admin_register(self):
            # replica self-registration heartbeat (tools/serve.py
            # --router-url): how a router restarted with a lost or
            # stale journal rediscovers its fleet, and how a drained
            # replica says goodbye without waiting out --eject-after
            if not self._authorized("/admin"):
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                return self._json(400, {"error": f"bad JSON: {e}"})
            try:
                out = core.register_replica(req)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            return self._json(200, out)

        def _tenant_headers(self):
            """The request's tenant/priority headers, VERBATIM, for
            forwarding on every downstream hop (including retry and
            re-prefill failover legs)."""
            fwd = {}
            for h in (TENANT_HEADER, PRIORITY_HEADER):
                v = self.headers.get(h)
                if v:
                    fwd[h] = v
            return fwd

        def _generate(self, parts=None):
            t0 = time.monotonic()
            tenant = self.headers.get(TENANT_HEADER)
            try:
                core.acquire(tenant)
            except TenantQuotaExceeded as e:
                # HONEST Retry-After: the tenant's own bucket refill
                # time (plus the machine-precise value in the body)
                retry = max(0.001, e.retry_after_s)
                return self._json(
                    429,
                    {"error": str(e), "tenant": e.tenant,
                     "reason": e.reason, "retry_after_s": retry},
                    headers={"Retry-After": f"{retry:.3f}"},
                )
            except QueueFull:
                return self._json(
                    429,
                    {"error": f"router at capacity "
                              f"({args.max_inflight} in flight)"},
                    headers={"Retry-After": "1"},
                )
            except QueueClosed:
                return self._json(
                    503, {"error": "router draining"},
                    headers={"Retry-After": "5"},
                )
            trace = trace_buffer.maybe_start("route", t0=t0)
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    req = json.loads(body or b"{}")
                except json.JSONDecodeError as e:
                    return self._json(400, {"error": f"bad JSON: {e}"})
                try:
                    deadline_s = float(req.get("deadline_s",
                                               default_deadline))
                    if not (deadline_s > 0 and math.isfinite(deadline_s)):
                        raise ValueError(
                            "deadline_s must be a positive finite number"
                        )
                    deadline_s = min(deadline_s, max_deadline)
                except (ValueError, TypeError) as e:
                    return self._json(400, {"error": str(e)})
                if core.disaggregated:
                    return self._generate_disagg(req, deadline_s, trace)
                # prefix-affinity signal: the request's prompt ids (when
                # the body carries ids — text prompts would need the
                # replica's tokenizer) steer `pick` toward the replica
                # already holding the cached prefill.  Malformed ids are
                # ignored here: the replica answers the 400, affinity
                # just scores 0
                ids = req.get("prompt_ids") or next(
                    iter(req.get("prompts_ids") or []), None
                )
                try:
                    prefix_tokens = ([int(t) for t in ids]
                                     if isinstance(ids, list) and ids
                                     else None)
                except (TypeError, ValueError):
                    prefix_tokens = None
                streaming = parts is not None and self._wants_stream(parts)
                relay = {"started": False, "lost": False}

                def relay_sink(chunk: bytes) -> None:
                    # unbuffered proxy: forward each replica flush the
                    # moment it lands.  Must not raise back into the
                    # dispatch (the _http_request sink contract) — a
                    # gone client just drains the rest of the stream.
                    if relay["lost"]:
                        return
                    try:
                        if not relay["started"]:
                            relay["started"] = True
                            self.send_response(200)
                            self.send_header("Content-Type",
                                             "text/event-stream")
                            self.send_header("Cache-Control", "no-cache")
                            self.send_header("Connection", "close")
                            if trace is not None:
                                self.send_header("X-Trace-Id",
                                                 trace.trace_id)
                            self.end_headers()
                        self.wfile.write(chunk)
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError,
                            TimeoutError, OSError):
                        relay["lost"] = True
                        reg.counter("pfx_http_client_gone_total").inc()

                try:
                    status, data, ctype = core.dispatch(
                        "POST",
                        "/generate?stream=1" if streaming else "/generate",
                        body,
                        role="monolith", deadline_s=deadline_s,
                        # the fleet token rides along so a token-gated
                        # replica honors the trace-propagation headers
                        # (serve.py accepts them only from callers that
                        # pass the admin rule)
                        headers={"Content-Type": "application/json",
                                 **self._tenant_headers(),
                                 **admin_headers()},
                        trace=trace,
                        sink=relay_sink if streaming else None,
                        prefix_tokens=prefix_tokens,
                    )
                except NoReplicaAvailable as e:
                    return self._json(
                        503, {"error": str(e)},
                        headers={"Retry-After": "2"},
                    )
                except ReplicaUnavailable as e:
                    if relay["started"]:
                        # stream torn mid-relay: the status line is
                        # already on the close-delimited wire, so the
                        # truncated stream IS the client's error signal
                        return
                    return self._json(
                        503, {"error": str(e)},
                        headers={"Retry-After": "1"},
                    )
                if relay["started"]:
                    # the relay sink already wrote the whole response
                    reg.counter("pfx_http_responses_total",
                                code="200").inc()
                    return
                headers = (
                    {"Retry-After": "1"} if status in (429, 503) else None
                )
                return self._send(status, data, ctype, headers)
            except Exception as e:  # noqa: BLE001 — last-resort guard
                return self._json(500, {"error": str(e)})
            finally:
                if trace is not None:
                    trace.event("respond")
                    trace.finish()
                core.release(tenant)

        def _generate_disagg(self, req, deadline_s, trace):
            if "prompt_ids" in req:
                prompts, plural = [list(req["prompt_ids"])], False
            elif "prompts_ids" in req:
                prompts, plural = [list(p) for p in req["prompts_ids"]], True
            else:
                return self._json(400, {
                    "error": "disaggregated routing serves token-id "
                             "requests (prompt_ids / prompts_ids); the "
                             "router has no tokenizer"
                })
            if not prompts or any(not p for p in prompts):
                return self._json(400, {
                    "error": "prompts must be non-empty id lists"
                })
            mt = req.get("max_tokens")
            try:
                rows = core.generate_disaggregated(
                    prompts, None if mt is None else int(mt),
                    deadline_s, trace=trace,
                    extra_headers=self._tenant_headers(),
                )
            except _DownstreamError as e:
                try:
                    obj = json.loads(e.body)
                except json.JSONDecodeError:
                    obj = {"error": e.body.decode(errors="replace")}
                headers = (
                    {"Retry-After": "1"} if e.status in (429, 503) else None
                )
                return self._json(e.status, obj, headers)
            except NoReplicaAvailable as e:
                return self._json(503, {"error": str(e)},
                                  headers={"Retry-After": "2"})
            except ReplicaUnavailable as e:
                return self._json(503, {"error": str(e)},
                                  headers={"Retry-After": "1"})
            payload = ({"completions_ids": rows} if plural
                       else {"completion_ids": rows[0]})
            if trace is not None:
                payload["trace_id"] = trace.trace_id
            return self._json(200, payload)

    class Server(ThreadingHTTPServer):
        daemon_threads = False  # drain joins in-flight responses
        block_on_close = True

        def handle_error(self, request, client_address):
            exc = sys.exc_info()[1]
            if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                                TimeoutError)):
                reg.counter("pfx_http_client_gone_total").inc()
                return
            super().handle_error(request, client_address)

    httpd = Server((args.host, args.port), Handler)
    orig_handlers = {}

    def _on_signal(signum, frame):
        for sig, h in orig_handlers.items():
            signal.signal(sig, h)
        flags["draining"] = True
        recorder.record({"event": "drain_start", "signum": signum,
                         "in_flight": core.depth()})
        print(
            f"signal {signum}: router draining — admission closed, "
            f"{core.depth()} request(s) in flight "
            "(send again to force-quit)",
            flush=True,
        )

        def _drain():
            core.close()
            core.join()
            httpd.shutdown()

        threading.Thread(target=_drain, name="router-drain",
                         daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        orig_handlers[sig] = signal.signal(sig, _on_signal)

    # ---- control-plane recovery (docs/serving.md "Control-plane
    # recovery"): fold the previous incarnation's journal back in BEFORE
    # anything spawns — tenant buckets restore with the death window's
    # worth of refill (no free burst allowance mid-429-storm), controller
    # clocks rebase so the restart can neither double-spawn nor
    # insta-rescale, and each supervisor reconciles its journaled slots
    # against what is actually running (adopt, reap, or respawn) --------
    def _journal_snapshot():
        """Full control-plane state for FleetJournal compaction — the
        same shape replay_fleet_state produces, so a compacted journal
        replays identically to the append log it replaced."""
        views = core.replica_views()
        by_url = {v["url"]: v for v in views}
        slots = {}
        ctl_state = {}
        for c in controllers:
            pool = c.role or "monolith"
            rows = {}
            for mv in c.supervisor.views():
                if not mv.get("desired") and mv.get("pid") is None:
                    continue  # empty slot: nothing to recover
                rv = by_url.get(mv["url"]) or {}
                rows[str(mv["slot"])] = {
                    "port": mv["port"], "url": mv["url"],
                    "rid": mv["replica_id"],
                    "cmd_hash": mv.get("cmd_hash"),
                    "pid": mv.get("pid"),
                    "boot_id": rv.get("boot_id"),
                    "phase": ("adopted" if mv.get("adopted")
                              else "spawned"),
                }
            slots[pool] = rows
            ctl_state[pool] = c.journal_state()
        return {
            "replicas": {
                v["key"]: {f: v.get(f) for f in (
                    "url", "role", "state", "replica_id", "pid",
                    "boot_id")}
                for v in views
            },
            "slots": slots,
            "controller": ctl_state,
            "tenants": core.tenant_journal_snapshot(),
        }

    journal_records, journal_note = read_fleet_journal(journal_path)
    if journal_note:
        print(f"recovery: {journal_note}", flush=True)
    replayed = (replay_fleet_state(journal_records)
                if journal_records else None)
    age_s = 0.0
    if replayed is not None and replayed.get("wall"):
        age_s = max(0.0, time.time() - float(replayed["wall"]))
    if replayed is not None:
        restored = core.restore_tenant_buckets(
            (replayed.get("tenants") or {}).get("buckets") or {},
            age_s=age_s,
        )
        print(
            f"recovery: replayed {replayed['records']} journal "
            f"record(s) (death window {age_s:.1f}s); restored "
            f"{restored} tenant bucket(s)", flush=True,
        )
        reg.counter("pfx_router_recoveries_total").inc()
    for ctl in controllers:
        pool = ctl.role or "monolith"
        facts = {}
        if replayed is not None:
            cs = (replayed.get("controller") or {}).get(pool)
            if cs:
                ctl.restore_clocks(
                    target=cs.get("target"), tick=cs.get("tick"),
                    up_age_s=cs.get("up_age_s"),
                    scale_age_s=cs.get("scale_age_s"),
                    extra_age_s=age_s,
                )
            facts = (replayed.get("slots") or {}).get(pool) or {}
        # probe EVERY slot, journaled or not: with facts the full
        # identity triple must match; without (journal lost), a live
        # process answering with the slot's own replica_id is adopted —
        # either way a surviving fleet is re-entered with zero respawns
        probe = {
            str(i): (facts.get(str(i)) or {})
            for i in range(ctl.supervisor.max_replicas)
        }
        adopted = ctl.supervisor.adopt(probe)
        if adopted:
            ctl._register(adopted)
            print(
                f"recovery: re-adopted {len(adopted)} live "
                f"replica(s) into the {pool} pool (zero respawns, "
                "no flap budget spent)", flush=True,
            )
    journal.set_snapshot_fn(_journal_snapshot)

    core.start()
    for ctl in controllers:
        # spawn min_replicas (registered with the core as they come up)
        # and start each control loop; the poller walks each replica
        # booting -> warm -> serving as it answers /healthz
        ctl.start()

    stop_scale_log = threading.Event()

    def _scale_event_log():
        # mirror controller scale decisions into the fleet log so the
        # offline fleet report can mark them on the curves — only NEW
        # non-hold rows are appended, tracked by each row's monotonic
        # `tick` (a LENGTH high-water mark would stall forever once the
        # bounded deque reaches maxlen and len() stops growing)
        seen = {id(c): 0 for c in controllers}
        while not stop_scale_log.wait(1.0):
            for ctl in controllers:
                last = seen[id(ctl)]
                # view() copies the log under the controller's own
                # lock — iterating the live deque would race tick()'s
                # append ("deque mutated during iteration" would kill
                # this thread and silently end scale-event mirroring)
                for row in ctl.view().get("decisions", []):
                    tick = int(row.get("tick", 0))
                    if tick <= last:
                        continue
                    seen[id(ctl)] = max(seen[id(ctl)], tick)
                    if row.get("action") not in (None, "hold"):
                        core.fleet_log.event({
                            "event": "scale",
                            "pool": ctl.role or "fleet",
                            "action": row.get("action"),
                            "reason": row.get("reason", ""),
                            "target": row.get("target"),
                        })

    if controllers:
        threading.Thread(target=_scale_event_log,
                         name="router-scale-log", daemon=True).start()
    mode = identity["scheduler"]
    supervising = ""
    if pool_supervise:
        supervising = (
            f"; supervising prefill {args.min_prefill}.."
            f"{args.max_prefill} from port {args.prefill_base_port}, "
            f"decode {args.min_decode}..{args.max_decode} from port "
            f"{args.decode_base_port}"
        )
    elif controllers:
        supervising = (
            f"; supervising {args.min_replicas}..{args.max_replicas} "
            f"replicas from port {args.base_port}"
        )
    print(
        f"router on {args.host}:{args.port} ({mode}; "
        f"{len(core.replicas)} replica(s), max in-flight "
        f"{args.max_inflight}, retries {args.retries}, "
        f"handoff {args.handoff}" + supervising + ")",
        flush=True,
    )
    def _force_quit(where):
        # os._exit skips every finally: take the managed children down
        # HARD so their ports free up for the next boot — orphans
        # running old code would crash-loop the replacement fleet into
        # quarantine while still answering /healthz
        print(f"force-quit on second interrupt ({where})", flush=True)
        recorder.record({"event": "force_quit"})
        recorder.dump(reason="force_quit")
        for ctl in controllers:
            ctl.supervisor.kill_all()
        os._exit(130)

    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        _force_quit("serving")
    finally:
        try:
            stop_scale_log.set()
            for ctl in controllers:
                # stop scaling first, then drain the children
                # gracefully: each managed replica gets SIGTERM,
                # answers its admitted work, exits 0 (the drain
                # contract) — the router never leaves orphans behind a
                # clean shutdown
                ctl.stop()
            for ctl in controllers:
                ctl.supervisor.stop_all()
            core.stop()
            httpd.server_close()
        except KeyboardInterrupt:
            # the second signal landed while the graceful teardown was
            # already underway (a fast drain finishes before a human's
            # second Ctrl-C): still honor the force-quit contract —
            # never a traceback, never an orphan
            _force_quit("teardown")
    if flags["draining"]:
        print("router drained cleanly: all admitted requests answered",
              flush=True)
    return 0


def cmd_drain(args) -> int:
    """The rolling-deploy primitive: ask a RUNNING router to drain one
    replica, then watch it walk draining -> gone (the replica answers
    its admitted work, exits 0, and its port goes refused).  Repeat per
    replica — redeploying between drains — for a full rolling deploy
    (runbook: docs/serving.md)."""
    import urllib.error
    import urllib.request

    from paddlefleetx_tpu_torch.core.router import admin_headers

    admin = args.admin.rstrip("/")
    req = urllib.request.Request(
        f"{admin}/admin/drain",
        data=json.dumps(
            {"replica": args.replica_id or None}
        ).encode(),
        # the shared PFX_ADMIN_TOKEN rides along so the deploy tooling
        # works against a remote, token-gated router
        headers={"Content-Type": "application/json", **admin_headers()},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            out = json.load(r)
    except urllib.error.HTTPError as e:
        print(f"drain refused: {e.code} "
              f"{(e.read() or b'').decode(errors='replace')}",
              file=sys.stderr, flush=True)
        return 1
    except (urllib.error.URLError, OSError) as e:
        # router down / wrong --admin: a clean rc-1 message, never a
        # traceback from the deploy tooling
        print(f"cannot reach router at {admin}: {e}",
              file=sys.stderr, flush=True)
        return 1
    key = out["replica"]
    print(f"drain initiated: replica {key} (pid {out.get('pid')})",
          flush=True)
    last = None
    t_end = time.time() + args.timeout
    while time.time() < t_end:
        try:
            with urllib.request.urlopen(
                f"{admin}/replicas", timeout=10
            ) as r:
                views = json.load(r)["replicas"]
        except (urllib.error.URLError, OSError) as e:
            # transient: the router itself may be mid-restart; keep
            # polling until the timeout decides
            print(f"router poll failed ({e}); retrying", flush=True)
            time.sleep(1.0)
            continue
        view = next((v for v in views if v["key"] == key), None)
        if view is None:
            print(f"replica {key} disappeared from the router",
                  file=sys.stderr, flush=True)
            return 1
        if view["state"] != last:
            last = view["state"]
            print(f"replica {key}: {last}", flush=True)
        if view["state"] == "gone":
            print(f"replica {key} drained and exited", flush=True)
            return 0
        time.sleep(0.3)
    print(f"timeout: replica {key} still {last!r} after "
          f"{args.timeout:g}s", file=sys.stderr, flush=True)
    return 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", nargs="?", default="serve",
                    choices=("serve", "drain"),
                    help="serve (default): run the front door; drain: "
                    "ask a running router to drain one replica and wait "
                    "for it to exit (rolling deploy)")
    ap.add_argument("--port", type=int, default=0,
                    help="router listen port (serve mode)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (unauthenticated endpoint: "
                    "exposing beyond loopback is an operator decision)")
    ap.add_argument("--replica", action="append", default=[],
                    help="monolith replica base URL (repeatable)")
    ap.add_argument("--prefill", action="append", default=[],
                    help="prefill-pool replica base URL (repeatable; "
                    "requires --decode too)")
    ap.add_argument("--decode", action="append", default=[],
                    help="decode-pool replica base URL (repeatable)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="router admission bound: requests in flight "
                    "beyond this get HTTP 429 (the front-door queue)")
    ap.add_argument("--retries", type=int, default=2,
                    help="max retries on ANOTHER replica after "
                    "connection-refused (partial responses never retry)")
    ap.add_argument("--handoff", choices=("direct", "proxy"),
                    default="direct",
                    help="disaggregated KV-handoff transport: 'direct' "
                    "(default) issues a placement ticket and the "
                    "prefill replica POSTs the payload straight to the "
                    "chosen decode replica — handoff bytes never "
                    "transit the router; 'proxy' carries the payload "
                    "through the router (the drilled fallback a failed "
                    "direct send degrades to)")
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="default per-request routing deadline seconds")
    ap.add_argument("--max-deadline", type=float, default=600.0,
                    help="ceiling on client deadline_s")
    ap.add_argument("--poll-interval", type=float, default=0.5,
                    help="replica /healthz poll cadence seconds")
    ap.add_argument("--eject-after", type=int, default=3,
                    help="consecutive failed polls before a replica is "
                    "marked gone")
    ap.add_argument("--serve-after", type=int, default=1,
                    help="consecutive healthy polls before a warm "
                    "replica starts receiving traffic")
    ap.add_argument("--tenants", default="",
                    help="per-tenant quota/weight config JSON "
                    "(docs/serving.md 'Multi-tenant isolation'); "
                    "unset = one anonymous tenant, no limits")
    # ---- elastic control plane (--supervise; docs/serving.md) ----
    ap.add_argument("--supervise", action="store_true",
                    help="spawn + supervise the replicas as managed "
                    "subprocesses and run the SLO-driven scale "
                    "controller (crash-restart with backoff, flap-"
                    "budget quarantine, warm boot, breach-driven "
                    "scale-up, idle scale-down via remote drains)")
    ap.add_argument("--replica-cmd", default="",
                    help="supervise: replica command template with "
                    "{port} and {replica_id} placeholders, e.g. "
                    "'python -m paddlefleetx_tpu_torch.tools.serve -c cfg.yaml --port {port} "
                    "--replica-id {replica_id}'")
    ap.add_argument("--min-replicas", type=int, default=1,
                    help="supervise: replica floor (boot + scale-down "
                    "bound)")
    ap.add_argument("--max-replicas", type=int, default=4,
                    help="supervise: replica ceiling (scale-up bound)")
    ap.add_argument("--base-port", type=int, default=8101,
                    help="supervise: slot i listens on base-port + i")
    ap.add_argument("--compile-cache-dir", default="",
                    help="supervise: kernel-library directory passed to "
                    "every spawned replica (--compile-cache-dir on "
                    "the serve CLI) — warm boot makes scale-up seconds, not "
                    "a kernel build")
    ap.add_argument("--replica-log-dir", default="",
                    help="supervise: per-replica stdout logs (default "
                    "<PFX_FLIGHT_DIR>/replicas)")
    ap.add_argument("--control-interval", type=float, default=1.0,
                    help="supervise: seconds between control-loop ticks")
    ap.add_argument("--scale-high-depth", type=float, default=4.0,
                    help="supervise: scale up when avg waiting depth "
                    "per serving replica exceeds this")
    ap.add_argument("--scale-low-depth", type=float, default=0.5,
                    help="supervise: fleet counts as idle below this "
                    "avg depth (hysteresis band with --scale-high-depth)")
    ap.add_argument("--scale-up-cooldown", type=float, default=5.0,
                    help="supervise: min seconds between scale-ups")
    ap.add_argument("--scale-down-cooldown", type=float, default=60.0,
                    help="supervise: min seconds after any scale action "
                    "before a scale-down")
    ap.add_argument("--scale-idle", type=float, default=30.0,
                    help="supervise: sustained idle seconds before a "
                    "scale-down")
    ap.add_argument("--flap-budget", type=int, default=5,
                    help="supervise: crash-restarts inside --flap-window "
                    "before a replica is quarantined LOUDLY")
    ap.add_argument("--flap-window", type=float, default=60.0,
                    help="supervise: flap-budget window seconds")
    ap.add_argument("--restart-backoff", type=float, default=0.5,
                    help="supervise: base seconds of the exponential "
                    "crash-restart backoff")
    # ---- disaggregated pool supervision (--supervise with pool cmds;
    # docs/serving.md "Disaggregated operations") ----
    ap.add_argument("--prefill-cmd", default="",
                    help="supervise the PREFILL pool: serve CLI command "
                    "template with {port}/{replica_id} placeholders "
                    "(must include --role prefill); requires "
                    "--decode-cmd too")
    ap.add_argument("--decode-cmd", default="",
                    help="supervise the DECODE pool: serve CLI command "
                    "template (must include --role decode)")
    ap.add_argument("--min-prefill", type=int, default=1,
                    help="prefill-pool replica floor")
    ap.add_argument("--max-prefill", type=int, default=4,
                    help="prefill-pool replica ceiling")
    ap.add_argument("--min-decode", type=int, default=1,
                    help="decode-pool replica floor")
    ap.add_argument("--max-decode", type=int, default=4,
                    help="decode-pool replica ceiling")
    ap.add_argument("--prefill-base-port", type=int, default=8201,
                    help="prefill slot i listens on this + i")
    ap.add_argument("--decode-base-port", type=int, default=8301,
                    help="decode slot i listens on this + i")
    ap.add_argument("--decode-low-blocks", type=int, default=0,
                    help="decode-pool scale-up watermark: any serving "
                    "decode replica reporting available_blocks at or "
                    "below this is arena pressure (0 = occupancy/"
                    "breach signals only)")
    ap.add_argument("--router-id", default="",
                    help="identity for this router's /healthz block")
    ap.add_argument("--admin", default="http://127.0.0.1:9000",
                    help="drain mode: the running router's base URL")
    ap.add_argument("--replica-id", default="",
                    help="drain mode: replica to drain (router key or "
                    "identity id; default: least-loaded serving replica)")
    ap.add_argument("--timeout", type=float, default=180.0,
                    help="drain mode: seconds to wait for the replica "
                    "to reach gone")
    args = ap.parse_args(argv)

    if args.command == "drain":
        return cmd_drain(args)
    if not args.port:
        ap.error("serve mode requires --port")
    if args.supervise:
        if bool(args.prefill_cmd) != bool(args.decode_cmd):
            ap.error("disaggregated pool supervision needs BOTH "
                     "--prefill-cmd and --decode-cmd")
        if args.prefill_cmd and args.replica_cmd:
            ap.error("--replica-cmd (monolith fleet) and --prefill-cmd/"
                     "--decode-cmd (pool fleet) are mutually exclusive")
        if not (args.replica_cmd or args.prefill_cmd):
            ap.error("--supervise requires --replica-cmd (monolith "
                     "fleet) or --prefill-cmd + --decode-cmd "
                     "(disaggregated pools), each a serve CLI command "
                     "template with {port}")
        if args.replica or args.prefill or args.decode:
            ap.error("--supervise manages its own replicas; static "
                     "--replica/--prefill/--decode URLs are exclusive "
                     "with it")
        if args.prefill_cmd:
            # overlapping slot port ranges would surface as bind-failure
            # crash loops and a misleading flap-budget quarantine — make
            # the misconfiguration a config error instead
            pools = [
                ("prefill", args.prefill_base_port, args.max_prefill),
                ("decode", args.decode_base_port, args.max_decode),
            ]
            ranges = [(n, b, b + mx - 1) for n, b, mx in pools]
            (na, alo, ahi), (nb, blo, bhi) = ranges
            if alo <= bhi and blo <= ahi:
                ap.error(
                    f"slot port ranges overlap: {na} {alo}..{ahi} vs "
                    f"{nb} {blo}..{bhi} — replicas would fight for the "
                    "same port and crash-loop into quarantine; move "
                    f"--{nb}-base-port past the {na} pool's "
                    f"--max-{na} slots"
                )
            for name, lo, hi in ranges:
                if lo <= args.port <= hi:
                    ap.error(
                        f"--port {args.port} falls inside the {name} "
                        f"slot range {lo}..{hi}; the router and a "
                        f"{name} replica would fight for it")
    elif not (args.replica or args.prefill or args.decode):
        ap.error("need --replica URLs, --prefill and --decode URLs, "
                 "or --supervise with a replica command template")
    return serve_router(args)


if __name__ == "__main__":
    sys.exit(main())
