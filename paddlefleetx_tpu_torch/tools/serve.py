"""Generation serving CLI of the PyTorch port: an HTTP JSON endpoint.

    python -m paddlefleetx_tpu_torch.tools.serve \\
        -c configs/gpt/pretrain_gpt_345M_single.yaml --port 8000

Counterpart of ``tools/serve.py`` with its two schedulers:

    POST /generate  {"prompt_ids": [...], "max_tokens": 32, "deadline_s": 30}
                    -> {"completion_ids": [...]}
                    ("prompts_ids": [[...], ...] -> {"completions_ids": [...]})
                    POST /generate?stream=1 (or Accept: text/event-stream)
                    -> server-sent events: "token" frames {"row", "index",
                    "tokens"} with per-row contiguous indices, then one
                    "summary" frame (or an "error" frame on a failure
                    mid-stream)
    GET  /healthz   state, queue and serving stats (with speculation:
                    spec_proposed, spec_accepted, spec_accept_rate), the
                    per-tenant rows, and the attention kernels' launch
                    counts since traffic began (flash decode, paged
                    decode, their multi-query launches and their plain
                    versions)
    GET  /metrics   Prometheus text of the metrics registry; /healthz's
                    numbers come from a snapshot of the same registry

Requests go through a bounded admission queue: a full queue answers 429
with Retry-After, an expired deadline 503.  ``--scheduler coalesce``
(default): one scheduler thread merges same-bucket waiting requests into
one batched decode over a contiguous KV cache.  ``--scheduler
continuous``: iteration-level scheduling over the paged KV arena
(``core/continuous_batching.py``; ``--cb-batch`` rows, ``--kv-blocks``
arena blocks, block size PFX_KV_BLOCK): rows join and leave the running
decode batch at every step.  SIGTERM or SIGINT drains: admission closes,
every admitted request is answered, and the process exits 0 (a second
signal force-quits).  ``--draft-k N`` (the override
``Generation.speculative.draft_k=N``) turns on speculative decoding on
either scheduler: n-gram self-drafting, N drafts verified a step in one
t = N + 1 forward; greedy output stays token-identical.

The continuous scheduler also takes the JAX CLI's prompt-reuse flags:
``--prefill-chunk N`` streams prompts into the arena N tokens (a block
multiple) a step, between the decode steps of the other rows;
``--prefix-cache-blocks N`` keeps up to N arena blocks of finished
prompts in a radix index, so a later prompt with the same prefix maps
those blocks and computes only its suffix; ``--prefix-spill-bytes S``
demotes evicted cached blocks to S bytes of host RAM and brings them
back on a later match.  ``/healthz`` ``serving`` then shows
``prefill_chunks``, ``interleaved_chunks`` (those run beside decoding
rows), ``prefill_tokens`` (prompt tokens computed),
``prefix`` {hits, misses, hit_tokens, evictions},
``prefix_cached_blocks``, ``spill`` {spills, readmits, discards},
``prefix_spill_bytes`` and ``prefix_spill_entries``, and ``kernels``
the chunk launches of the paged kernel in ``paged_decode_chunk`` /
``paged_decode_q8_chunk``.

Tenancy: a request's ``X-Tenant`` header names its fair-share queue
(absent: the anonymous tenant) and ``X-Priority`` its class (an integer
clamped to [-100, 100], default 0).  ``--tenants FILE`` gives the
tenants' weights (``core/tenancy.TenantConfig``); both schedulers pick
across tenants by deficit round-robin, FCFS within one.  On the
continuous scheduler a blocked arrival may preempt a running row of
strictly lower priority once it has committed ``--preempt-min-tokens``
tokens; the row resumes later from its committed tokens.  Streaming on
the continuous scheduler sends each step's commits as they land; on the
coalescing one the whole answer arrives in one flush at completion.

``PFX_FAULT`` drills: ``preempt_storm:K`` (the continuous scheduler
preempts its lowest-priority eligible row at iteration K) and
``spill_corrupt:K`` (the Kth spill readmit probe finds its host copy
torn); a value that does not parse, or any other site, fails the boot.

The model runs on the card (``--device cuda``, the default) and the
command fails without one; ``--device cpu`` runs the plain PyTorch path.
Weights are random, drawn from ``Global.seed``.  Not ported yet, and
refused where asked for: beam search, checkpoint and tokenizer loading,
``/debug/*`` and ``/admin/*`` (KV handoff and prefix migration among
them), SLO objectives and their burn rates.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty as SinkEmpty
from queue import Queue as SinkQueue
from urllib.parse import parse_qs, urlsplit

from paddlefleetx_tpu_torch.core.continuous_batching import (
    ContinuousScheduler,
    PagedDecodeEngine,
)
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.request_queue import (
    QUEUE_METRICS,
    DeadlineExceeded,
    QueueClosed,
    QueueFull,
    RequestQueue,
)
from paddlefleetx_tpu_torch.core.serving import GenerationServer, plan_decode
from paddlefleetx_tpu_torch.core.tenancy import (
    PRIORITY_HEADER,
    TENANT_HEADER,
    TenantConfig,
    TenantLabelCap,
    normalize_tenant,
    parse_priority,
)
from paddlefleetx_tpu_torch.models.gpt.generation import bucket_len
from paddlefleetx_tpu_torch.ops import decode_attention
from paddlefleetx_tpu_torch.utils.config import get_config
from paddlefleetx_tpu_torch.utils.device import resolve_device
from paddlefleetx_tpu_torch.utils.log import log_server_error, logger
from paddlefleetx_tpu_torch.utils.resilience import serving_fault_spec
from paddlefleetx_tpu_torch.utils.telemetry import get_registry


def build_server(config: str, overrides, device=None) -> GenerationServer:
    """Config -> seeded model on ``device`` (the card unless "cpu") ->
    ``GenerationServer``.  Raises without a card unless ``device`` is
    "cpu"."""
    dev = resolve_device(device)
    cfg = get_config(config, overrides=overrides)
    if cfg.get("Engine", {}).get("save_load", {}).get("ckpt_dir"):
        raise NotImplementedError(
            "Engine.save_load.ckpt_dir: checkpoint loading is not ported yet; "
            "the port serves random weights drawn from Global.seed"
        )
    module = GPTModule(cfg)
    model = module.init_model(int(cfg.Global.seed), dev)
    return GenerationServer(cfg, module, model, dev)


def clamp_max_tokens(requested, default: int, cap: int) -> int:
    """A request's max_tokens: the configured default when absent, clamped
    to ``cap`` (> 0), floored at 1."""
    val = default if requested is None else int(requested)
    if cap > 0:
        val = min(val, cap)
    return max(1, val)


def plan_request(prompts_ids, max_toks: int, *, bucket: int, context: int):
    """(trim, coalesce_key) for one request, predicted with the helpers
    ``GenerationServer.generate_ids`` pads and clamps with, so requests
    with equal keys pad identically whether served together or apart.
    Raises ValueError (HTTP 400) when the prompt leaves no decode room."""
    pbucket = bucket_len(max(len(p) for p in prompts_ids), bucket)
    trim, run = plan_decode(pbucket, max_toks, context=context)
    return trim, (pbucket, run)


def build_scheduler(server: GenerationServer, scheduler: str, *, queue_depth: int,
                    max_coalesce: int, cb_batch: int = 8, kv_blocks: int = 0,
                    prefill_chunk: int = 0, prefix_cache_blocks: int = 0,
                    prefix_spill_bytes: int = 0, tenant_config=None,
                    preempt_min_tokens: int = 8):
    """The serving scheduler behind ``--scheduler``: ``coalesce`` (a
    ``RequestQueue`` whose runner is ``server.generate_ids``) or
    ``continuous`` (a ``ContinuousScheduler`` over a ``PagedDecodeEngine``
    with ``cb_batch`` rows and ``kv_blocks`` arena blocks, 0 = one full
    context per row plus the null block, and the chunk width, prefix
    cache and spill budget of :class:`PagedDecodeEngine`; the coalescing
    scheduler refuses those three).  Both take ``tenant_config`` (the
    weighted-fair pick); ``preempt_min_tokens`` is the continuous
    scheduler's preemption floor.  Both expose kind / submit /
    try_remove / depth / busy_seconds / stats_snapshot / serving_stats /
    start / close / join, so the HTTP layer is scheduler-agnostic."""
    reuse = {"prefill_chunk": prefill_chunk, "prefix_cache_blocks": prefix_cache_blocks,
             "prefix_spill_bytes": prefix_spill_bytes}
    if scheduler == "coalesce":
        if any(reuse.values()):
            raise ValueError(f"{sorted(k for k, v in reuse.items() if v)} need "
                             "--scheduler continuous")
        return RequestQueue(
            lambda prompts, max_new: server.generate_ids(prompts, max_dec_len=max_new),
            max_depth=queue_depth, max_coalesce=max_coalesce, name="serve",
            serving_stats=lambda: dict(server.stats), tenant_config=tenant_config,
        )
    if scheduler == "continuous":
        engine = PagedDecodeEngine(server, max_batch=cb_batch, num_blocks=kv_blocks, **reuse)
        return ContinuousScheduler(engine, max_depth=queue_depth, name="serve",
                                   tenant_config=tenant_config,
                                   preempt_min_tokens=preempt_min_tokens)
    raise ValueError(f"unknown scheduler {scheduler!r}; valid: coalesce, continuous")


def serve_http(server: GenerationServer, queue, port: int, host: str = "127.0.0.1", *,
               queue_depth: int = 64, max_coalesce: int = 8,
               default_deadline_s: float = 120.0, max_deadline_s: float = 600.0,
               shed_slack_s: float = 2.0, max_tokens_cap: int = 0,
               tenant_config=None) -> int:
    """Serve ``queue`` (a scheduler from :func:`build_scheduler`) until a
    SIGTERM/SIGINT drain completes; returns 0."""
    cap = max_tokens_cap or int(
        server.cfg.get("Generation", {}).get("max_tokens_cap", 0) or 0
    )
    context, bucket = server.context, server.bucket
    flags = {"draining": False}
    reg = get_registry()
    tenant_labels = TenantLabelCap(seed=(tenant_config or TenantConfig()).known_tenants())
    in_flight = reg.gauge("pfx_http_requests_in_flight")
    client_gone = reg.counter("pfx_http_client_gone_total")
    latency_hist = reg.histogram("pfx_request_latency_seconds")
    ttft_hist = reg.histogram("pfx_request_ttft_seconds")
    itl_hist = reg.histogram("pfx_request_itl_seconds")
    draining_gauge = reg.gauge("pfx_serve_draining")
    # only the continuous scheduler has a per-step commit hook; the
    # coalescing one resolves whole completions, so its streams degrade
    # to one flush at completion (the same SSE frames either way)
    stream_capable = queue.kind == "continuous"
    identity = {"listen": f"{host}:{port}", "pid": os.getpid(),
                "device": str(server.device), "started_at": round(time.time(), 3)}

    def observe_ttft(tenant: str, seconds: float) -> None:
        ttft_hist.observe(seconds)
        reg.histogram("pfx_tenant_ttft_seconds",
                      tenant=tenant_labels.label(tenant)).observe(seconds)

    def healthz_body():
        """/healthz from ONE registry snapshot (the one /metrics renders
        on its own call), with the schedulers' instance-local extras."""
        snap = reg.snapshot()

        def val(name, **labels):
            return reg.value(name, snap=snap, **labels)

        def per_label(name):
            return {lab.get("tenant", "?"): int(v)
                    for lab, v in snap.get(name, {"values": []})["values"]}

        counts = {f"http_{lab.get('code', '?')}": int(v)
                  for lab, v in snap.get("pfx_http_responses_total", {"values": []})["values"]}
        if val("pfx_http_client_gone_total"):
            counts["client_gone"] = int(val("pfx_http_client_gone_total"))
        qstats = queue.stats_snapshot()
        qstats.update({k: int(val(m)) for k, m in QUEUE_METRICS.items() if k in qstats})
        serving = queue.serving_stats()
        for k, m in (("requests", "pfx_serving_requests_total"),
                     ("tokens_out", "pfx_serving_tokens_out_total")):
            serving[k] = int(val(m))
        tenants = {}
        for key, name in (("admitted", "pfx_tenant_admitted_total"),
                          ("preemptions", "pfx_tenant_preemptions_total"),
                          ("queue_depth", "pfx_tenant_queue_depth")):
            for lab, v in per_label(name).items():
                tenants.setdefault(lab, {})[key] = v
        ttft = val("pfx_request_ttft_seconds", default={"p50": 0.0, "p99": 0.0})
        return {
            "ok": True,
            "state": "draining" if flags["draining"] else "ok",
            "identity": identity,
            "in_flight": int(val("pfx_http_requests_in_flight")),
            "queue_depth": int(val("pfx_queue_depth")),
            "busy_s": round(val("pfx_queue_busy_seconds"), 3),
            "queue": qstats,
            "counters": counts,
            "ttft_p50_s": round(ttft["p50"], 4),
            "ttft_p99_s": round(ttft["p99"], 4),
            "serving": serving,
            "tenants": tenants,
            "kernels": dict(decode_attention.COUNTS),
        }

    class Handler(BaseHTTPRequestHandler):
        timeout = 120  # a silent client cannot pin a handler thread

        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=None):
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
                reg.counter("pfx_http_responses_total", code=str(code)).inc()
            except (BrokenPipeError, ConnectionResetError, TimeoutError):
                client_gone.inc()

        def _json(self, code: int, obj, headers=None):
            if code >= 500:
                log_server_error("serve", code, self.path, outcome=obj.get("error"))
            self._send(code, json.dumps(obj).encode(), "application/json", headers)

        def _not_ported(self, what: str):
            self._json(501, {"error": f"{what} is not ported to the PyTorch "
                                      "serve CLI yet"})

        def do_GET(self):
            path = urlsplit(self.path).path
            if path == "/healthz":
                return self._json(200, healthz_body())
            if path == "/metrics":
                return self._send(200, reg.render_prometheus().encode(),
                                  "text/plain; version=0.0.4; charset=utf-8")
            if path.startswith("/debug/"):
                return self._not_ported(path)
            self._json(404, {"error": "unknown path"})

        def do_POST(self):
            parts = urlsplit(self.path)
            if parts.path.startswith("/admin/"):
                return self._not_ported(parts.path)
            if parts.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            in_flight.add(1)
            try:
                self._generate(parts)
            except Exception as e:  # noqa: BLE001 — last-resort guard, report it
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                in_flight.add(-1)

        def _parse(self, req):
            if "prompt" in req or "prompts" in req:
                raise ValueError("no tokenizer in the PyTorch port yet; send "
                                 "prompt_ids / prompts_ids")
            if "prompt_ids" in req:
                ids, mode = [req["prompt_ids"]], "prompt_ids"
            elif "prompts_ids" in req:
                ids, mode = list(req["prompts_ids"]), "prompts_ids"
            else:
                raise ValueError("need prompt_ids or prompts_ids")
            if not ids or any(not p for p in ids):
                raise ValueError("prompts must be a non-empty list of non-empty id lists")
            if len(ids) > max_coalesce:
                raise ValueError(f"too many prompts in one request ({len(ids)} > "
                                 f"{max_coalesce}); split the batch")
            return [[int(t) for t in p] for p in ids], mode

        def _tenant_of(self):
            """The request's tenant label and clamped priority, from the
            X-Tenant / X-Priority headers (absent: the anonymous tenant
            at priority 0)."""
            return (normalize_tenant(self.headers.get(TENANT_HEADER)),
                    parse_priority(self.headers.get(PRIORITY_HEADER)))

        def _wants_stream(self, parts) -> bool:
            """``POST /generate?stream=1`` or ``Accept: text/event-stream``."""
            if parse_qs(parts.query).get("stream", ["0"])[0] not in ("0", ""):
                return True
            return "text/event-stream" in (self.headers.get("Accept") or "")

        def _submit(self, prompts, trim, kw):
            """Admission: the future, or None once a 400/429/503 went out."""
            try:
                return queue.submit(prompts, trim, **kw)
            except ValueError as e:  # a prompt the paged arena can never hold
                self._json(400, {"error": str(e)})
            except QueueFull as e:
                self._json(429, {"error": f"{e}; retry later"}, headers={"Retry-After": "1"})
            except QueueClosed:
                self._json(503, {"error": "draining: not admitting new requests"},
                           headers={"Retry-After": "5"})
            return None

        def _generate(self, parts):
            t0 = time.monotonic()
            tenant, priority = self._tenant_of()
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                prompts, mode = self._parse(req)
                max_toks = clamp_max_tokens(req.get("max_tokens"), server.gen.max_dec_len, cap)
                deadline_s = float(req.get("deadline_s", default_deadline_s))
                if not (deadline_s > 0 and math.isfinite(deadline_s)):
                    raise ValueError("deadline_s must be a positive finite number")
                deadline_s = min(deadline_s, max_deadline_s)
                trim, key = plan_request(prompts, max_toks, bucket=bucket, context=context)
            except (ValueError, TypeError) as e:
                return self._json(400, {"error": str(e)})
            kw = {"coalesce_key": key, "deadline_s": deadline_s, "tenant": tenant,
                  "priority": priority}
            if self._wants_stream(parts):
                return self._generate_stream(prompts, trim, kw, deadline_s, t0, tenant)
            fut = self._submit(prompts, trim, kw)
            if fut is None:
                return
            try:
                rows = fut.result(timeout=deadline_s + shed_slack_s)
            except TimeoutError:
                queue.try_remove(fut)
                return self._json(503, {"error": f"deadline {deadline_s:g}s exceeded"},
                                  headers={"Retry-After": "1"})
            except (DeadlineExceeded, QueueClosed) as e:
                return self._json(503, {"error": str(e)}, headers={"Retry-After": "1"})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            # non-streamed: the first token reaches the client with the rest
            observe_ttft(tenant, time.monotonic() - t0)
            latency_hist.observe(time.monotonic() - t0)
            payload = ({"completion_ids": rows[0]} if mode == "prompt_ids"
                       else {"completions_ids": rows})
            self._json(200, payload)

        def _generate_stream(self, prompts, trim, kw, deadline_s, t0, tenant):
            """Server-sent events: ``event: token`` frames ``{"row",
            "index", "tokens"}`` as the engine commits them (per-row
            contiguous indices), then ``event: summary`` with the usage.
            A failure after the 200 went out (deadline, eviction, drain)
            ends the stream with an ``event: error`` frame that says how
            many tokens were sent.  The body is close-delimited.  The
            scheduler pushes into a per-request queue, so a slow client
            never blocks the scheduler thread."""
            sink = SinkQueue()
            if stream_capable:
                kw["stream"] = lambda row, start, toks: sink.put((row, start, list(toks)))
            fut = self._submit(prompts, trim, kw)
            if fut is None:
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, TimeoutError):
                client_gone.inc()
                queue.try_remove(fut)
                return
            reg.counter("pfx_http_responses_total", code="200").inc()
            st = {"first": None, "last": None, "flushes": 0, "sent": 0, "lost": False}

            def emit(event, obj):
                if st["lost"]:
                    return False
                try:
                    self.wfile.write(f"event: {event}\ndata: {json.dumps(obj)}\n\n".encode())
                    self.wfile.flush()
                    return True
                except (BrokenPipeError, ConnectionResetError, TimeoutError):
                    client_gone.inc()
                    st["lost"] = True
                    return False

            def flush_tokens(row, start, toks):
                now = time.monotonic()
                if st["first"] is None:
                    st["first"] = now  # TTFT: when bytes leave for the client
                    observe_ttft(tenant, now - t0)
                else:
                    itl_hist.observe(now - st["last"])
                st["last"] = now
                st["flushes"] += 1
                st["sent"] += len(toks)
                return emit("token", {"row": row, "index": start, "tokens": toks})

            code, err, rows = 200, None, None
            hard_deadline = t0 + deadline_s + shed_slack_s
            while not (fut.done() and sink.empty()):
                try:
                    item = sink.get(timeout=0.05)
                except SinkEmpty:
                    if time.monotonic() > hard_deadline and not fut.done():
                        queue.try_remove(fut)
                        code, err = 503, f"deadline {deadline_s:g}s exceeded"
                        break
                    continue
                if not flush_tokens(*item):
                    break  # the client hung up; the decode still finishes
            if err is None:
                try:
                    rows = fut.result(timeout=deadline_s + shed_slack_s)
                except TimeoutError:
                    queue.try_remove(fut)
                    code, err = 503, f"deadline {deadline_s:g}s exceeded"
                except (DeadlineExceeded, QueueClosed) as e:
                    code, err = 503, str(e)
                except ValueError as e:
                    code, err = 400, str(e)
                except Exception as e:  # noqa: BLE001 — reported in the error frame
                    code, err = 500, f"{type(e).__name__}: {e}"
            if err is not None:
                emit("error", {"error": err, "code": code, "tokens_committed": st["sent"]})
                return
            if st["flushes"] == 0:
                # one flush at completion: the coalescing scheduler, or a
                # completion without tokens
                for i, r in enumerate(rows):
                    if not flush_tokens(i, 0, list(r)):
                        break
            latency_hist.observe(time.monotonic() - t0)
            emit("summary", {"usage": {"prompts": len(rows),
                                       "tokens": sum(len(r) for r in rows)},
                             "flushes": st["flushes"]})

    class Server(ThreadingHTTPServer):
        daemon_threads = False
        block_on_close = True  # a drain joins in-flight responses

    httpd = Server((host, port), Handler)
    drain_lock = threading.Lock()

    def _drain():
        queue.close()
        queue.join()
        httpd.shutdown()

    def _on_signal(signum, frame):
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_DFL)  # a second signal force-quits
        with drain_lock:
            if flags["draining"]:
                return
            flags["draining"] = True
            draining_gauge.set(1)
        print(f"signal {signum}: draining — admission closed, {queue.depth()} "
              "queued request(s) will finish", flush=True)
        threading.Thread(target=_drain, name="serve-drain", daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    queue.start()
    print(f"serving on {host}:{port} (POST /generate, GET /healthz, GET /metrics; device "
          f"{server.device}, scheduler {queue.kind}, queue depth {queue_depth}, "
          f"max prompts {max_coalesce})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    if flags["draining"]:
        print("drained cleanly: all admitted requests answered", flush=True)
    return 0


def _csv_ints(raw: str):
    return [int(x) for x in raw.split(",") if x.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.serve")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--port", type=int, required=True, help="HTTP port")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (use 0.0.0.0 to expose externally)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; fails without a card) or cpu (the "
                    "plain PyTorch path)")
    ap.add_argument("--draft-k", type=int, default=-1,
                    help="speculative decoding: draft tokens per verify step "
                    "(overrides Generation.speculative.draft_k; 0 disables, -1 "
                    "leaves the config value)")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default="",
                    help="KV-cache storage dtype (overrides Generation."
                    "speculative.kv_dtype); int8 runs the q8 kernel")
    ap.add_argument("--max-coalesce", type=int, default=8,
                    help="max prompts merged into one batched decode")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="bounded admission queue depth (full -> HTTP 429)")
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="default per-request deadline seconds")
    ap.add_argument("--max-deadline", type=float, default=600.0,
                    help="ceiling on a client's deadline_s")
    ap.add_argument("--shed-slack", type=float, default=2.0,
                    help="slack past the deadline before the handler answers 503")
    ap.add_argument("--max-tokens-cap", type=int, default=0,
                    help="per-request max_tokens ceiling (0 = "
                    "Generation.max_tokens_cap, else the context)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warmup-buckets", default="",
                    help="comma-separated prompt lengths to run before "
                    "serving (default 8)")
    ap.add_argument("--warmup-batches", default="",
                    help="comma-separated batch sizes per prompt bucket "
                    "(default: powers of two up to --max-coalesce)")
    ap.add_argument("--scheduler", choices=("coalesce", "continuous"), default="coalesce",
                    help="coalesce: batch same-bucket waiting requests; "
                    "continuous: iteration-level batching over the paged KV arena")
    ap.add_argument("--cb-batch", type=int, default=8,
                    help="continuous scheduler: running-batch row capacity")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="continuous scheduler: KV arena blocks (0 = cb-batch "
                    "full-context rows + the null block); block size PFX_KV_BLOCK")
    ap.add_argument("--prefix-cache-blocks", type=int, default=0,
                    help="continuous scheduler: shared-prefix KV cache budget in arena "
                    "blocks (finished rows publish their prompt-prefix blocks; later "
                    "admissions reuse them and prefill only the suffix; 0 disables)")
    ap.add_argument("--prefix-spill-bytes", type=int, default=0,
                    help="continuous scheduler: host-RAM budget (bytes) for the "
                    "prefix-spill tier: LRU-evicted prefix blocks demote to host memory "
                    "and readmit on a later prefix match instead of recomputing "
                    "(requires --prefix-cache-blocks; 0 disables)")
    ap.add_argument("--tenants", default="",
                    help="per-tenant weight/quota config JSON (core/tenancy.TenantConfig); "
                    "both schedulers serve tenants deficit-round-robin by weight; unset = "
                    "one anonymous tenant, FCFS")
    ap.add_argument("--preempt-min-tokens", type=int, default=8,
                    help="continuous scheduler: an active row must have committed at "
                    "least this many tokens since its last admission before a "
                    "higher-priority arrival may preempt it")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous scheduler: admit long prompts in chunks of this "
                    "many tokens (multiple of PFX_KV_BLOCK), one chunk per scheduler "
                    "iteration interleaved with decode steps; 0 = monolithic prefill")
    args = ap.parse_args(argv)
    # a drill against a site this path does not wire would exercise
    # nothing: refuse it (and a value that does not parse) before booting
    fault = serving_fault_spec()
    if fault is not None:
        logger.warning(f"PFX_FAULT drill armed: {fault[0]} at step {fault[1]} "
                       f"({fault[2]} fire(s))")
    tenant_config = TenantConfig.from_file(args.tenants) if args.tenants else None
    # the spec and KV flags are plain config overrides, so both schedulers
    # read one Generation.speculative section
    if args.draft_k >= 0:
        args.override.append(f"Generation.speculative.draft_k={args.draft_k}")
    if args.kv_dtype:
        args.override.append(f"Generation.speculative.kv_dtype={args.kv_dtype}")

    server = build_server(args.config, args.override, args.device)
    queue = build_scheduler(
        server, args.scheduler, queue_depth=args.queue_depth,
        max_coalesce=args.max_coalesce, cb_batch=args.cb_batch, kv_blocks=args.kv_blocks,
        prefill_chunk=args.prefill_chunk, prefix_cache_blocks=args.prefix_cache_blocks,
        prefix_spill_bytes=args.prefix_spill_bytes, tenant_config=tenant_config,
        preempt_min_tokens=args.preempt_min_tokens,
    )
    if not args.no_warmup and queue.kind == "continuous":
        queue.warmup(_csv_ints(args.warmup_buckets) or [8])
    elif not args.no_warmup:
        batches = _csv_ints(args.warmup_batches)
        if not batches:
            b, batches = 1, []
            while b < max(1, args.max_coalesce):
                batches.append(b)
                b *= 2
            batches.append(b)
        server.warmup(_csv_ints(args.warmup_buckets) or [8], batch_sizes=batches)
    # /healthz reports launches made by traffic, not by the warmup
    decode_attention.reset_counts()
    logger.info(f"model {server.module.config} on {server.device}")
    return serve_http(
        server, queue, args.port, args.host,
        queue_depth=args.queue_depth, max_coalesce=args.max_coalesce,
        default_deadline_s=args.deadline, max_deadline_s=args.max_deadline,
        shed_slack_s=args.shed_slack, max_tokens_cap=args.max_tokens_cap,
        tenant_config=tenant_config,
    )


if __name__ == "__main__":
    sys.exit(main())
