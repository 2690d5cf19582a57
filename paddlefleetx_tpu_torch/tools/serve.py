"""Generation serving CLI of the PyTorch port: a stdin REPL or an HTTP
JSON endpoint.

    python -m paddlefleetx_tpu_torch.tools.serve \\
        -c configs/gpt/pretrain_gpt_345M_single.yaml --port 8000

Counterpart of ``tools/serve.py`` with its two schedulers.  ``--port 0``
(the default) reads one prompt a line from stdin (space-separated token
ids, or text with a tokenizer) and prints the completion, until an empty
line or EOF.  With a port:

    POST /generate  {"prompt_ids": [...], "max_tokens": 32, "deadline_s": 30}
                    -> {"completion_ids": [...]}
                    ("prompts_ids": [[...], ...] -> {"completions_ids": [...]};
                    with a tokenizer, "prompt": "..." -> {"completion": "..."}
                    and "prompts": [...] -> {"completions": [...]})
                    POST /generate?stream=1 (or Accept: text/event-stream)
                    -> server-sent events: "token" frames {"row", "index",
                    "tokens"} with per-row contiguous indices (text prompts:
                    also "text", the frame's tokens decoded), then one
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
    GET  /debug/state    the scheduler's live view: waiting entries (ages,
                    sizes, tenants; never prompt contents), and on the
                    continuous scheduler the rows, the arena, the dispatch
                    path, the goodput ledgers and the decision log
    GET  /debug/trace?id=  one sampled request's timeline (a 200's body
                    carries its ``trace_id``)
    GET  /debug/traces   the retained traces as Chrome trace JSON
    POST /admin/drain    answered first, then the SIGTERM drain (exit 0)
    POST /admin/profile  {"seconds": T, "top": N}: a ``torch.profiler``
                    capture of the live process, answered with its op table
                    (``utils/profiler.py``; 409 while one runs, 400 past
                    ``PFX_PROFILE_MAX_SECONDS``)

``/debug/*`` and ``/admin/*`` take ``Authorization: Bearer
$PFX_ADMIN_TOKEN`` when the token is set, else loopback clients only
(``core/router.check_admin``: 401 / 403).  ``/admin/adopt_prefixes``
answers 501: prefix migration is not ported.

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
preempts its lowest-priority eligible row at iteration K),
``spill_corrupt:K`` (the Kth spill readmit probe finds its host copy
torn), ``cb_commit_crash:K`` (the commit of engine step K fails: the
arena resets and every live row's request fails), ``gen_crash:K``
(generation request K raises: one 500, the server keeps serving),
``gen_hang:K`` / ``cb_step_hang:K`` (generation request K, or continuous
step K, sleeps ``PFX_FAULT_HANG_S`` seconds) and ``boot_crash:0`` (exit
23 right after the arguments parse); a value that does not parse, or any
other site, fails the boot.

Operations (the JAX CLI's): every response feeds the request span
histograms (``pfx_request_queue_wait_seconds``, ``_decode_seconds``,
``_per_token_seconds``) and the flight recorder; a sampled request's
trace (``PFX_TRACE_SAMPLE``, default 1.0; ``PFX_TRACE_CAP`` retained)
gets its respond stamp.  ``--slo-ttft-p99 S`` / ``--slo-error-rate F``
over ``--slo-windows`` (default 60,600) evaluate burn rates: ``/healthz``
grows an ``slo`` block and ``/metrics`` the ``pfx_slo_*`` gauges.
``--watchdog S`` (default 300): a generation busy past S seconds flips
``/healthz`` to ``degraded`` (``ok`` false, ``pfx_serve_degraded`` 1) and
dumps the flight recorder; it flips back once the scheduler comes
unstuck.  The flight recorder (``PFX_FLIGHT_DIR``, default
``./artifacts/``; ``PFX_FLIGHT_RECORDER`` names the file) dumps on an
uncaught exception on any thread, at a watchdog degrade, after a drain
and at exit.

The continuous scheduler dispatches ahead (``PFX_DISPATCH_AHEAD``, default
1; 0 steps synchronously, with a warning) and scans its queue every
``PFX_SCHED_QUANTUM``-th step (default 1); on the card each decode or
verify step is a CUDA graph replay.  ``/healthz`` ``serving`` shows
``dispatch_ahead``, ``quantum``, ``inflight``, ``host_gap_s`` over
``gap_steps``, and ``graphs`` captured, ``graph_replays`` and
``graph_capture_s``; ``kernels`` counts a replay's launches as an eager
step's.

The model runs on the card (``--device cuda``, the default) and the
command fails without one; ``--device cpu`` runs the plain PyTorch path.
Weights come from ``Engine.save_load.ckpt_dir`` when it is set: a
training step directory of the train CLI (``step_<N>``) or a params-only
directory of ``tools/convert_hf_gpt2.py`` (``utils/checkpoint.py``), cast
to the serving dtype; a checkpoint of another Model config fails the
boot naming the first mismatched parameter.  Without it they are random,
drawn from ``Global.seed``.  ``Generation.tokenizer_dir`` (a directory
with ``vocab.json`` and ``merges.txt``) loads the GPT BPE tokenizer, for
text prompts.  ``Generation.decode_strategy: beam_search`` decodes with
beam search on the coalescing scheduler; the continuous scheduler treats
it as sampling, as the JAX CLI's does (its paged step argmaxes only
``greedy_search``).  Not ported yet: the disaggregated roles and the KV
handoff, prefix migration (``/admin/adopt_prefixes``), router
registration (``--router-url``, ``--role``, ``--replica-id``).
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
from paddlefleetx_tpu_torch.core.router import check_admin
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
from paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
from paddlefleetx_tpu_torch.models.gpt.generation import bucket_len
from paddlefleetx_tpu_torch.models.gpt.model import GPTModel
from paddlefleetx_tpu_torch.ops import decode_attention
from paddlefleetx_tpu_torch.utils.checkpoint import load_params_into, load_pretrained_params
from paddlefleetx_tpu_torch.utils.config import get_config
from paddlefleetx_tpu_torch.utils.device import resolve_device
from paddlefleetx_tpu_torch.utils.log import log_server_error, logger
from paddlefleetx_tpu_torch.utils import tracing
from paddlefleetx_tpu_torch.utils.profiler import ProfileBusy, capture_profile
from paddlefleetx_tpu_torch.utils.resilience import maybe_fire, serving_fault_spec
from paddlefleetx_tpu_torch.utils.telemetry import (
    SLOTracker,
    Span,
    atomic_artifact_write,
    flight_dir,
    get_flight_recorder,
    get_registry,
)


def build_server(config: str, overrides, device=None) -> GenerationServer:
    """Config -> model on ``device`` (the card unless "cpu"): the params of
    ``Engine.save_load.ckpt_dir`` when set, else seeded random weights ->
    ``GenerationServer``, with the tokenizer of
    ``Generation.tokenizer_dir`` when set.  Raises without a card unless
    ``device`` is "cpu"."""
    dev = resolve_device(device)
    cfg = get_config(config, overrides=overrides)
    module = GPTModule(cfg)
    params = load_pretrained_params(cfg)
    if params is None:
        model = module.init_model(int(cfg.Global.seed), dev)
    else:
        ckpt_dir = cfg.Engine.save_load.ckpt_dir
        model = load_params_into(GPTModel(module.config), params, f"ckpt_dir {ckpt_dir}")
        model = model.to(dev)
        del params
        logger.info(f"serving the params of {ckpt_dir}")
    tok = None
    tokenizer_dir = (cfg.get("Generation", {}) or {}).get("tokenizer_dir")
    if tokenizer_dir:
        tok = GPTTokenizer.from_pretrained(tokenizer_dir)
    return GenerationServer(cfg, module, model, dev, tokenizer=tok)


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


def _record_request_span(reg, recorder, t0, fut, code, tokens=None, streamed=False):
    """One /generate lifecycle as telemetry (JAX ``tools/serve.py:140``):
    span phases admission -> queue_wait -> decode -> respond from the
    future's monotonic stamps, the queue-wait, decode and per-token
    histograms, the TTFT of a non-streamed success (its whole completion
    lands at resolution; a streamed one observes its own at the first
    flush), and a flight-recorder event.  A request shed before pickup
    has no decode phase (``shed``).  The request's sampled trace gets its
    ``respond`` stamp and is finished."""
    trace = getattr(fut, "trace", None) if fut is not None else None
    if trace is not None:
        trace.event("respond", code=code, tokens=tokens)
        trace.finish()
    span = Span("request", t0=t0)
    times = dict(getattr(fut, "times", {}) or {}) if fut is not None else {}
    if "enqueued" in times:
        span.mark("admission", t=times["enqueued"])
    if "picked" in times:
        span.mark("queue_wait", t=times["picked"])
    if "resolved" in times:
        span.mark("decode" if "picked" in times else "shed", t=times["resolved"])
    span.mark("respond")
    phases = span.phases()
    if "queue_wait" in phases:
        reg.histogram("pfx_request_queue_wait_seconds").observe(phases["queue_wait"])
    if "decode" in phases:
        reg.histogram("pfx_request_decode_seconds").observe(phases["decode"])
        if tokens:
            reg.histogram("pfx_request_per_token_seconds").observe(
                phases["decode"] / max(1, tokens))
    if "resolved" in times and code == 200 and not streamed:
        reg.histogram("pfx_request_ttft_seconds").observe(max(0.0, times["resolved"] - t0))
    recorder.record(span.event(code=code, tokens=tokens))


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
               tenant_config=None, watchdog_s: float = 300.0,
               slo_ttft_p99_s: float = 0.0, slo_error_rate: float = 0.0,
               slo_windows_s=(60.0, 600.0)) -> int:
    """Serve ``queue`` (a scheduler from :func:`build_scheduler`) until a
    drain (SIGTERM/SIGINT or ``POST /admin/drain``) completes; returns 0."""
    cap = max_tokens_cap or int(
        server.cfg.get("Generation", {}).get("max_tokens_cap", 0) or 0
    )
    context, bucket = server.context, server.bucket
    flags = {"draining": False, "degraded": False}
    stop_event = threading.Event()
    reg = get_registry()
    recorder = get_flight_recorder()
    # an uncaught exception on any thread leaves a postmortem ring
    recorder.install_excepthook()
    trace_buffer = tracing.get_trace_buffer()
    tenant_labels = TenantLabelCap(seed=(tenant_config or TenantConfig()).known_tenants())
    # the SLO burn rates: observed per response in the HTTP layer, never
    # on the decode path
    slo = SLOTracker(ttft_p99_s=slo_ttft_p99_s, error_rate=slo_error_rate,
                     windows_s=slo_windows_s, tenant_label_fn=tenant_labels.label)
    if slo.enabled:
        reg.register_collector(slo)
    in_flight = reg.gauge("pfx_http_requests_in_flight")
    client_gone = reg.counter("pfx_http_client_gone_total")
    latency_hist = reg.histogram("pfx_request_latency_seconds")
    ttft_hist = reg.histogram("pfx_request_ttft_seconds")
    itl_hist = reg.histogram("pfx_request_itl_seconds")
    draining_gauge = reg.gauge("pfx_serve_draining")
    degraded_gauge = reg.gauge("pfx_serve_degraded")
    # only the continuous scheduler has a per-step commit hook; the
    # coalescing one resolves whole completions, so its streams degrade
    # to one flush at completion (the same SSE frames either way)
    stream_capable = queue.kind == "continuous"
    identity = {"listen": f"{host}:{port}", "pid": os.getpid(),
                "device": str(server.device), "started_at": round(time.time(), 3)}
    tracing.set_process_identity(replica_id=identity["listen"])

    def observe_tenant_ttft(tenant: str, seconds: float) -> None:
        reg.histogram("pfx_tenant_ttft_seconds",
                      tenant=tenant_labels.label(tenant)).observe(seconds)

    def _slo_observe(code, fut, t0, tenant=None):
        """A response's SLO outcome (JAX ``tools/serve.py:368``): the
        tenant TTFT of a 200 from its resolution stamp; 200 is
        budget-neutral, 429 / 500 / 503 spend the budget, 400 / 404 are the
        client's and observe nothing."""
        ttft = None
        times = getattr(fut, "times", {}) if fut is not None else {}
        if code == 200 and "resolved" in times:
            ttft = max(0.0, times["resolved"] - t0)
            observe_tenant_ttft(normalize_tenant(tenant), ttft)
        if slo.enabled and code not in (400, 404):
            slo.observe_request(ttft_s=ttft, ok=code == 200, tenant=tenant)

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
        body = {
            "ok": not flags["degraded"],
            "state": ("draining" if flags["draining"]
                      else "degraded" if flags["degraded"] else "ok"),
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
        if slo.enabled:
            # the burn rates with the breach's reason
            body["slo"] = slo.evaluate()
        return body

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

        def do_GET(self):
            path = urlsplit(self.path).path
            if path == "/healthz":
                return self._json(200, healthz_body())
            if path == "/metrics":
                return self._send(200, reg.render_prometheus().encode(),
                                  "text/plain; version=0.0.4; charset=utf-8")
            if path.startswith("/debug/"):
                return self._debug_get()
            self._json(404, {"error": "unknown path"})

        def _authorized(self, what: str) -> bool:
            """Gate an /admin or /debug request on ``core/router.check_admin``
            (the PFX_ADMIN_TOKEN rule); answers 401 / 403 itself."""
            ok, code, msg = check_admin(self.headers, self.client_address, what=what)
            if not ok:
                self._json(code, {"error": msg})
            return ok

        def _debug_get(self):
            """Read-only snapshots that never block the scheduler thread
            and never carry prompt or token contents (JAX
            ``tools/serve.py:773-838``)."""
            if not self._authorized("/debug"):
                return
            parts = urlsplit(self.path)
            if parts.path == "/debug/state":
                snap = reg.snapshot()  # one read beside the view
                dbg = queue.debug_state()
                dbg["serving"] = {"requests": int(server.stats["requests"]),
                                  "gen_errors": int(server.stats["gen_errors"])}
                dbg["flags"] = dict(flags)
                dbg["trace_buffer"] = {"sample": trace_buffer.sample, "cap": trace_buffer.cap,
                                       "retained": len(trace_buffer.traces())}
                if slo.enabled:
                    dbg["slo"] = slo.evaluate()
                dbg["metrics"] = {
                    name: reg.value(name, snap=snap) for name in (
                        "pfx_queue_depth", "pfx_queue_busy_seconds",
                        "pfx_http_requests_in_flight", "pfx_batch_occupancy",
                        "pfx_kv_blocks_used", "pfx_kv_blocks_free", "pfx_prefill_admits_total",
                        "pfx_request_evictions_total", "pfx_spec_accept_rate",
                        "pfx_spec_accepted_total", "pfx_spec_proposed_total",
                        "pfx_prefix_hits_total", "pfx_prefix_misses_total",
                        "pfx_prefix_hit_tokens_total", "pfx_prefix_evictions_total",
                        "pfx_prefix_cached_blocks", "pfx_prefill_chunks_total",
                        "pfx_prefix_spill_bytes", "pfx_prefix_spill_entries",
                        "pfx_prefix_spills_total", "pfx_prefix_readmits_total",
                        "pfx_prefix_spill_discards_total")
                    if name in snap}
                return self._json(200, dbg)
            if parts.path == "/debug/trace":
                tid = (parse_qs(parts.query).get("id") or [""])[0]
                if not tid:
                    return self._json(400, {"error": "need ?id=<trace_id>"})
                tc = trace_buffer.get(tid)
                if tc is None:
                    return self._json(404, {
                        "error": f"trace {tid!r} not in the sampled window (cap "
                                 f"{trace_buffer.cap}, sample {trace_buffer.sample:g})"})
                return self._json(200, tc.timeline())
            if parts.path == "/debug/traces":
                # the retained window as Perfetto / chrome://tracing JSON
                return self._json(200, tracing.chrome_trace(trace_buffer.traces()))
            return self._json(404, {"error": "unknown debug path"})

        def do_POST(self):
            parts = urlsplit(self.path)
            if parts.path.startswith("/admin/"):
                return self._admin(parts)
            if parts.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            in_flight.add(1)
            try:
                self._generate(parts)
            except Exception as e:  # noqa: BLE001 — last-resort guard, report it
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                in_flight.add(-1)

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _admin(self, parts):
            """The authenticated operations surface.  ``/admin/drain`` is
            the remote SIGTERM: answered first (the caller learns the drain
            started), then admission closes, every admitted request is
            answered and the process exits 0."""
            if not self._authorized("/admin"):
                return
            if parts.path == "/admin/drain":
                try:
                    self._read_json()  # a body (migrate_to) is read and ignored
                except json.JSONDecodeError:
                    pass
                self._json(200, {"state": "draining", "already_draining": flags["draining"],
                                 "queued": queue.depth()})
                initiate_drain("admin drain")
                return
            if parts.path == "/admin/profile":
                return self._profile()
            if parts.path == "/admin/adopt_prefixes":
                return self._json(501, {"error": "/admin/adopt_prefixes (prefix migration) is "
                                                 "not ported to the PyTorch serve CLI yet"})
            return self._json(404, {"error": "unknown admin path"})

        def _profile(self):
            """``POST /admin/profile {"seconds": T, "top": N}``: a capture
            of this live process (``utils/profiler.capture_profile``),
            answered with its summary, which is also kept under the flight
            directory."""
            try:
                req = self._read_json()
                seconds = req.get("seconds", 3.0)
                top = int(req.get("top", 20))
            except (json.JSONDecodeError, TypeError, ValueError, AttributeError):
                return self._json(400, {"error": "body must be a JSON object"})
            prof_dir = os.path.join(flight_dir(), "profiles",
                                    time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}")
            try:
                summary = capture_profile(seconds, prof_dir, top=top, device=server.device)
            except ProfileBusy as e:
                print(f"[serve] /admin/profile refused: {e}", flush=True)
                return self._json(409, {"error": str(e)})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except RuntimeError as e:  # the card's capture saw no device event
                return self._json(500, {"error": str(e)})
            summary["replica_id"] = identity["listen"]
            atomic_artifact_write(os.path.join(prof_dir, "profile_summary.json"),
                                  lambda f: json.dump(summary, f, indent=1))
            recorder.record({"event": "profile_capture", "seconds": summary["seconds"],
                             "trace_dir": prof_dir, "source": summary["source"]})
            return self._json(200, summary)

        def _parse(self, req):
            """(prompts_ids, mode) from a /generate body; raises ValueError
            with a client-facing message (HTTP 400)."""
            if "prompt" in req or "prompts" in req:
                if server.tokenizer is None:
                    raise ValueError("no tokenizer configured (Generation.tokenizer_dir); "
                                     "send prompt_ids/prompts_ids")
                if "prompt" in req:
                    texts, mode = [req["prompt"]], "prompt"
                else:
                    texts, mode = list(req["prompts"]), "prompts"
                if not texts or not all(isinstance(t, str) and t for t in texts):
                    raise ValueError("prompts must be non-empty strings")
                ids = [server.tokenizer.encode(t) for t in texts]
            elif "prompt_ids" in req:
                ids, mode = [req["prompt_ids"]], "prompt_ids"
            elif "prompts_ids" in req:
                ids, mode = list(req["prompts_ids"]), "prompts_ids"
            else:
                raise ValueError("need prompt(s) or prompt(s)_ids")
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

        def _submit(self, prompts, trim, kw, t0):
            """Admission: the future, or None once a 400/429/503 went out
            (a 429 or 503 spends SLO budget)."""
            try:
                return queue.submit(prompts, trim, **kw)
            except ValueError as e:  # a prompt the paged arena can never hold
                self._json(400, {"error": str(e)})
            except QueueFull as e:
                _slo_observe(429, None, t0)
                self._json(429, {"error": f"{e}; retry later"}, headers={"Retry-After": "1"})
            except QueueClosed:
                _slo_observe(503, None, t0)
                self._json(503, {"error": "draining: not admitting new requests"},
                           headers={"Retry-After": "5"})
            return None

        def _fail(self, code, msg, fut, t0, tenant, retry=None):
            """A failed request's epilogue: span, SLO (a 400 spends none)
            and the response."""
            _record_request_span(reg, recorder, t0, fut, code)
            _slo_observe(code, fut, t0, tenant=tenant)
            self._json(code, {"error": msg}, headers={"Retry-After": retry} if retry else None)

        def _await_result(self, fut, deadline_s, t0, tenant):
            """The result, bounded by the deadline plus the slack; on a
            failure the honest error (503 shed, 400, 500) and None."""
            try:
                return fut.result(timeout=deadline_s + shed_slack_s)
            except TimeoutError:
                queue.try_remove(fut)  # shed it if still queued
                self._fail(503, f"deadline {deadline_s:g}s exceeded", fut, t0, tenant, "1")
            except (DeadlineExceeded, QueueClosed) as e:
                self._fail(503, str(e), fut, t0, tenant, "1")
            except ValueError as e:
                self._fail(400, str(e), fut, t0, tenant)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._fail(500, f"{type(e).__name__}: {e}", fut, t0, tenant)
            return None

        def _generate(self, parts):
            t0 = time.monotonic()
            tenant, priority = self._tenant_of()
            try:
                req = self._read_json()
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
                return self._generate_stream(prompts, trim, kw, deadline_s, t0, tenant, mode)
            fut = self._submit(prompts, trim, kw, t0)
            if fut is None:
                return
            rows = self._await_result(fut, deadline_s, t0, tenant)
            if rows is None:
                return
            try:
                if mode in ("prompt", "prompts"):
                    texts = [server.tokenizer.decode(r) for r in rows]
                    payload = ({"completion": texts[0]} if mode == "prompt"
                               else {"completions": texts})
                else:
                    payload = ({"completion_ids": rows[0]} if mode == "prompt_ids"
                               else {"completions_ids": rows})
            except Exception as e:  # noqa: BLE001 — a failure after the decode still fails
                return self._fail(500, f"{type(e).__name__}: {e}", fut, t0, tenant)
            if fut.trace is not None:
                payload["trace_id"] = fut.trace.trace_id  # the /debug/trace?id= handle
            latency_hist.observe(time.monotonic() - t0)
            _record_request_span(reg, recorder, t0, fut, 200, tokens=sum(len(r) for r in rows))
            _slo_observe(200, fut, t0, tenant=tenant)
            self._json(200, payload)

        def _generate_stream(self, prompts, trim, kw, deadline_s, t0, tenant, mode):
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
            fut = self._submit(prompts, trim, kw, t0)
            if fut is None:
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                if fut.trace is not None:
                    self.send_header("X-Trace-Id", fut.trace.trace_id)
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
                    ttft_hist.observe(now - t0)
                else:
                    itl_hist.observe(now - st["last"])
                st["last"] = now
                st["flushes"] += 1
                st["sent"] += len(toks)
                obj = {"row": row, "index": start, "tokens": toks}
                if mode in ("prompt", "prompts"):
                    obj["text"] = server.tokenizer.decode(toks)
                return emit("token", obj)

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
                _record_request_span(reg, recorder, t0, fut, code, tokens=st["sent"] or None,
                                     streamed=True)
                _slo_observe(code, fut, t0, tenant=tenant)
                return
            if st["flushes"] == 0:
                # one flush at completion: the coalescing scheduler, or a
                # completion without tokens
                for i, r in enumerate(rows):
                    if not flush_tokens(i, 0, list(r)):
                        break
            latency_hist.observe(time.monotonic() - t0)
            _record_request_span(reg, recorder, t0, fut, 200,
                                 tokens=sum(len(r) for r in rows), streamed=True)
            ttft = None if st["first"] is None else st["first"] - t0
            if ttft is not None:
                observe_tenant_ttft(tenant, ttft)
            if slo.enabled:
                slo.observe_request(ttft_s=ttft, ok=True, tenant=tenant)
            summary = {"usage": {"prompts": len(rows), "tokens": sum(len(r) for r in rows)},
                       "flushes": st["flushes"]}
            if fut.trace is not None:
                summary["trace_id"] = fut.trace.trace_id
            emit("summary", summary)

    class Server(ThreadingHTTPServer):
        daemon_threads = False
        block_on_close = True  # a drain joins in-flight responses

    httpd = Server((host, port), Handler)
    drain_lock = threading.Lock()

    def _watchdog():
        # a generation busy past the budget flips /healthz to degraded, so
        # an orchestrator stops routing here, and dumps the flight ring
        # while the wedge is live; it flips back once the scheduler is
        # unstuck (compared with the budget: a 1 Hz sampler may never see
        # an idle scheduler under a steady backlog)
        while not stop_event.wait(1.0):
            busy = queue.busy_seconds()
            if busy > watchdog_s and not flags["degraded"]:
                flags["degraded"] = True
                degraded_gauge.set(1)
                print(f"WATCHDOG: generation wedged for {busy:.0f}s (budget "
                      f"{watchdog_s:.0f}s); /healthz degraded", flush=True)
                recorder.record({"event": "watchdog_degraded", "busy_s": round(busy, 3),
                                 "budget_s": watchdog_s})
                recorder.dump(reason="watchdog_degraded")
            elif flags["degraded"] and busy < watchdog_s:
                flags["degraded"] = False
                degraded_gauge.set(0)
                recorder.record({"event": "watchdog_recovered"})
                print("WATCHDOG: generation recovered; /healthz ok", flush=True)

    def initiate_drain(source: str) -> bool:
        """The drain, shared by the signal handler and ``POST
        /admin/drain``: close admission, answer every admitted request,
        dump the flight ring, stop the listener.  False when a drain is
        already under way."""
        with drain_lock:
            if flags["draining"]:
                return False
            flags["draining"] = True
            draining_gauge.set(1)
        recorder.record({"event": "drain_start", "source": source, "queued": queue.depth()})
        print(f"{source}: draining — admission closed, {queue.depth()} queued request(s) "
              "will finish", flush=True)

        def _drain():
            queue.close()
            queue.join()
            recorder.record({"event": "drain_done", "source": source})
            recorder.dump(reason="drain")
            httpd.shutdown()

        threading.Thread(target=_drain, name="serve-drain", daemon=True).start()
        return True

    def _on_signal(signum, frame):
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_DFL)  # a second signal force-quits
        initiate_drain(f"signal {signum}")

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    queue.start()
    threading.Thread(target=_watchdog, name="serve-watchdog", daemon=True).start()
    print(f"serving on {host}:{port} (POST /generate, GET /healthz, GET /metrics; device "
          f"{server.device}, scheduler {queue.kind}, queue depth {queue_depth}, "
          f"max prompts {max_coalesce}, watchdog {watchdog_s:g}s)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        stop_event.set()
        # joins the in-flight handler threads: every admitted request gets
        # its response bytes before the process exits
        httpd.server_close()
        recorder.record({"event": "serve_exit", "drained": flags["draining"]})
        recorder.dump(reason="exit")
    if flags["draining"]:
        print("drained cleanly: all admitted requests answered", flush=True)
    return 0


def _csv_ints(raw: str):
    return [int(x) for x in raw.split(",") if x.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.serve")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--port", type=int, default=0, help="HTTP port (0 = stdin REPL)")
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
    ap.add_argument("--watchdog", type=float, default=300.0,
                    help="seconds a single generation may run before /healthz flips to "
                    "degraded (wedged-decode detector)")
    ap.add_argument("--slo-ttft-p99", type=float, default=0.0,
                    help="SLO objective: p99 time-to-first-token seconds (0 = off); breach "
                    "when >1%% of requests exceed it on every --slo-windows window")
    ap.add_argument("--slo-error-rate", type=float, default=0.0,
                    help="SLO objective: allowed fraction of failed requests (429/500/503; "
                    "0 = off), burn-rate evaluated like --slo-ttft-p99")
    ap.add_argument("--slo-windows", default="60,600",
                    help="comma-separated rolling burn-rate window seconds, short first")
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
    # a replica that can never come up (exit 23)
    maybe_fire("boot_crash", 0)
    tenant_config = TenantConfig.from_file(args.tenants) if args.tenants else None
    # the spec and KV flags are plain config overrides, so both schedulers
    # read one Generation.speculative section
    if args.draft_k >= 0:
        args.override.append(f"Generation.speculative.draft_k={args.draft_k}")
    if args.kv_dtype:
        args.override.append(f"Generation.speculative.kv_dtype={args.kv_dtype}")

    server = build_server(args.config, args.override, args.device)
    if not args.port:
        return repl(server)
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
        tenant_config=tenant_config, watchdog_s=args.watchdog,
        slo_ttft_p99_s=args.slo_ttft_p99, slo_error_rate=args.slo_error_rate,
        slo_windows_s=tuple(float(x) for x in args.slo_windows.split(",") if x.strip()),
    )


def repl(server: GenerationServer, stdin=None) -> int:
    """The stdin REPL (JAX ``tools/serve.py:2187-2210``): one prompt a line
    (space-separated token ids, or text with a tokenizer) -> the
    completion on one line, until an empty line or EOF.  A bad line
    prints its error and the session goes on."""
    try:
        print("prompt> ", end="", flush=True)
        for line in stdin or sys.stdin:
            line = line.strip()
            if not line:
                break
            try:
                if server.tokenizer is not None:
                    print(server.generate_text([line])[0], flush=True)
                else:
                    ids = [int(t) for t in line.split()]
                    print(" ".join(map(str, server.generate_ids([ids])[0])), flush=True)
            except ValueError as e:  # bad ids or an empty prompt
                print(f"error: {e}", flush=True)
            except Exception as e:  # noqa: BLE001 — reported, the session goes on
                print(f"generation failed ({type(e).__name__}): {e}", flush=True)
            print("prompt> ", end="", flush=True)
    except (EOFError, KeyboardInterrupt):
        pass
    print("", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
