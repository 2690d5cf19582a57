"""Generation serving CLI of the PyTorch port: an HTTP JSON endpoint.

    python -m paddlefleetx_tpu_torch.tools.serve \\
        -c configs/gpt/pretrain_gpt_345M_single.yaml --port 8000

Counterpart of ``tools/serve.py`` with its two schedulers:

    POST /generate  {"prompt_ids": [...], "max_tokens": 32, "deadline_s": 30}
                    -> {"completion_ids": [...]}
                    ("prompts_ids": [[...], ...] -> {"completions_ids": [...]})
    GET  /healthz   state, queue and serving stats (with speculation:
                    spec_proposed, spec_accepted, spec_accept_rate), and
                    the attention kernels' launch counts since traffic
                    began (flash decode, paged decode, their multi-query
                    launches and their plain versions)

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

The model runs on the card (``--device cuda``, the default) and the
command fails without one; ``--device cpu`` runs the plain PyTorch path.
Weights are random, drawn from ``Global.seed``.  Not ported yet, and
refused where asked for: beam search, checkpoint and tokenizer loading,
token streaming, tenancy headers, ``/metrics``, ``/debug/*`` and
``/admin/*`` (KV handoff and prefix migration among them).
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
from urllib.parse import parse_qs, urlsplit

from paddlefleetx_tpu_torch.core.continuous_batching import (
    ContinuousScheduler,
    PagedDecodeEngine,
)
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.request_queue import (
    DeadlineExceeded,
    QueueClosed,
    QueueFull,
    RequestQueue,
)
from paddlefleetx_tpu_torch.core.serving import GenerationServer, plan_decode
from paddlefleetx_tpu_torch.models.gpt.generation import bucket_len
from paddlefleetx_tpu_torch.ops import decode_attention
from paddlefleetx_tpu_torch.utils.config import get_config
from paddlefleetx_tpu_torch.utils.device import resolve_device
from paddlefleetx_tpu_torch.utils.log import log_server_error, logger


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
                    prefix_spill_bytes: int = 0):
    """The serving scheduler behind ``--scheduler``: ``coalesce`` (a
    ``RequestQueue`` whose runner is ``server.generate_ids``) or
    ``continuous`` (a ``ContinuousScheduler`` over a ``PagedDecodeEngine``
    with ``cb_batch`` rows and ``kv_blocks`` arena blocks, 0 = one full
    context per row plus the null block, and the chunk width, prefix
    cache and spill budget of :class:`PagedDecodeEngine`; the coalescing
    scheduler refuses those three).  Both expose kind / submit /
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
            serving_stats=lambda: server.stats,
        )
    if scheduler == "continuous":
        engine = PagedDecodeEngine(server, max_batch=cb_batch, num_blocks=kv_blocks, **reuse)
        return ContinuousScheduler(engine, max_depth=queue_depth, name="serve")
    raise ValueError(f"unknown scheduler {scheduler!r}; valid: coalesce, continuous")


def serve_http(server: GenerationServer, queue, port: int, host: str = "127.0.0.1", *,
               queue_depth: int = 64, max_coalesce: int = 8,
               default_deadline_s: float = 120.0, max_deadline_s: float = 600.0,
               shed_slack_s: float = 2.0, max_tokens_cap: int = 0) -> int:
    """Serve ``queue`` (a scheduler from :func:`build_scheduler`) until a
    SIGTERM/SIGINT drain completes; returns 0."""
    cap = max_tokens_cap or int(
        server.cfg.get("Generation", {}).get("max_tokens_cap", 0) or 0
    )
    context, bucket = server.context, server.bucket
    flags = {"draining": False}
    counters = {}
    counters_lock = threading.Lock()
    identity = {"listen": f"{host}:{port}", "pid": os.getpid(),
                "device": str(server.device), "started_at": round(time.time(), 3)}

    class Handler(BaseHTTPRequestHandler):
        timeout = 120  # a silent client cannot pin a handler thread

        def log_message(self, *a):
            pass

        def _json(self, code: int, obj, headers=None):
            body = json.dumps(obj).encode()
            if code >= 500:
                log_server_error("serve", code, self.path, outcome=obj.get("error"))
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
                key = f"http_{code}"
            except (BrokenPipeError, ConnectionResetError, TimeoutError):
                key = "client_gone"
            with counters_lock:
                counters[key] = counters.get(key, 0) + 1

        def _not_ported(self, what: str):
            self._json(501, {"error": f"{what} is not ported to the PyTorch "
                                      "serve CLI yet"})

        def do_GET(self):
            path = urlsplit(self.path).path
            if path == "/healthz":
                with counters_lock:
                    http = dict(counters)
                return self._json(200, {
                    "ok": True,
                    "state": "draining" if flags["draining"] else "ok",
                    "identity": identity,
                    "queue_depth": queue.depth(),
                    "busy_s": round(queue.busy_seconds(), 3),
                    "queue": queue.stats_snapshot(),
                    "counters": http,
                    "serving": queue.serving_stats(),
                    "kernels": dict(decode_attention.COUNTS),
                })
            if path == "/metrics" or path.startswith("/debug/"):
                return self._not_ported(path)
            self._json(404, {"error": "unknown path"})

        def do_POST(self):
            parts = urlsplit(self.path)
            if parts.path.startswith("/admin/"):
                return self._not_ported(parts.path)
            if parts.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            try:
                self._generate(parts)
            except Exception as e:  # noqa: BLE001 — last-resort guard, report it
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

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

        def _generate(self, parts):
            stream = parse_qs(parts.query).get("stream", ["0"])[0] not in ("0", "")
            if stream or "text/event-stream" in (self.headers.get("Accept") or ""):
                return self._json(400, {"error": "token streaming is not ported "
                                                 "yet"})
            if self.headers.get("X-Tenant") or self.headers.get("X-Priority"):
                return self._json(400, {"error": "tenancy headers are not "
                                                 "supported by the PyTorch port yet"})
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
            try:
                fut = queue.submit(prompts, trim, coalesce_key=key, deadline_s=deadline_s)
            except ValueError as e:  # a prompt the paged arena can never hold
                return self._json(400, {"error": str(e)})
            except QueueFull as e:
                return self._json(429, {"error": f"{e}; retry later"},
                                  headers={"Retry-After": "1"})
            except QueueClosed:
                return self._json(503, {"error": "draining: not admitting new requests"},
                                  headers={"Retry-After": "5"})
            try:
                rows = fut.result(timeout=deadline_s + shed_slack_s)
            except TimeoutError:
                queue.try_remove(fut)
                return self._json(503, {"error": f"deadline {deadline_s:g}s exceeded"},
                                  headers={"Retry-After": "1"})
            except DeadlineExceeded as e:
                return self._json(503, {"error": str(e)}, headers={"Retry-After": "1"})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            payload = ({"completion_ids": rows[0]} if mode == "prompt_ids"
                       else {"completions_ids": rows})
            self._json(200, payload)

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
        print(f"signal {signum}: draining — admission closed, {queue.depth()} "
              "queued request(s) will finish", flush=True)
        threading.Thread(target=_drain, name="serve-drain", daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    queue.start()
    print(f"serving on {host}:{port} (POST /generate, GET /healthz; device "
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
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="continuous scheduler: admit long prompts in chunks of this "
                    "many tokens (multiple of PFX_KV_BLOCK), one chunk per scheduler "
                    "iteration interleaved with decode steps; 0 = monolithic prefill")
    args = ap.parse_args(argv)
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
        prefix_spill_bytes=args.prefix_spill_bytes,
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
    )


if __name__ == "__main__":
    sys.exit(main())
