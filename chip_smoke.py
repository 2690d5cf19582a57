#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (the quickest proof
that the port still starts on the card).

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed).  Phases, each fatal on failure:

  1. card and toolchain: nvidia-smi name and power limit, torch / CUDA /
     nvcc versions;
  2. build the CUDA kernels from paddlefleetx_tpu_torch/csrc with nvcc
     (sm_90a) and print the ptxas register/spill lines;
  3. every kernel against its plain PyTorch version on the card at
     GPT-345M shapes (16 heads, head dim 64, cache 1024; decode t=1 at
     limit 128/512/1024 and prefill t=512 with mixed left pads, batch 1
     and 8), with CUDA-event times of the kernel, the plain version and
     one PyTorch library call (scaled_dot_product_attention over the
     visible cache; int8 has none), and the least time the card could
     take (bytes / 3.35 TB/s against operations / peak of the input
     type);
  4. the slice at full width: ``python -m paddlefleetx_tpu_torch.tools.serve
     -c configs/gpt/pretrain_gpt_345M_single.yaml`` (24 layers, hidden
     1024, 16 heads, vocab 50304, bf16, random weights from Global.seed,
     greedy, 32 new tokens) answers four /generate requests, two of them
     coalesced; /healthz must show decode-kernel launches > 0 and no
     plain-version call; then again with --kv-dtype int8 for the q8
     kernel; SIGTERM must drain with exit 0;
  5. the same two prompts through the port in float32 on the card
     (kernels) and on the CPU (plain version), same weights: first-step
     logits within 1e-3 and identical greedy tokens;
  6. the paged decode kernel (K9), through the wrapper the engine calls,
     against its plain version on the card at
     GPT-345M shapes (16 heads, head dim 64, block 16, batch 8, positions
     5 .. 1023 over shuffled pool blocks, null-padded tables), decode t=1
     and verify t=4 in bf16, f32 and int8, plus a NaN-poison case, with
     CUDA-event times of the kernel, the plain version and
     scaled_dot_product_attention over the same rows' K/V already gathered
     into a dense cache (the gather not timed; int8 has none), and the
     bound;
  7. the continuous path at full width: ``tools.serve --scheduler
     continuous`` answers eight /generate requests of 32 new tokens sent
     at staggered times, so rows join the running batch while others
     decode; /healthz must show paged-kernel launches (24 per engine step)
     and no plain-version call; then again with --kv-dtype int8; SIGTERM
     must drain with exit 0;
  8. two prompts through PagedDecodeEngine in float32 on the card (K9)
     and on the CPU (plain version), same weights: first-step logits
     within 1e-3 and identical greedy tokens; then again with int8 pools
     (paged_decode_q8 against the plain int8 version).

Prints one ``kernels`` JSON line, the card line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a card, or outside a checkout of the repo.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = "configs/gpt/pretrain_gpt_345M_single.yaml"
SOURCES = {
    "flash_decode": "paddlefleetx_tpu_torch/csrc/decode_attention.cu",
    "flash_decode_q8": "paddlefleetx_tpu_torch/csrc/decode_attention.cu",
    "paged_decode": "paddlefleetx_tpu_torch/csrc/paged_attention.cu",
    "paged_decode_q8": "paddlefleetx_tpu_torch/csrc/paged_attention.cu",
}
REPLACES = {
    "flash_decode": "paddlefleetx_tpu/ops/decode_attention.py:256",
    "flash_decode_q8": "paddlefleetx_tpu/ops/decode_attention.py:295",
    "paged_decode": "paddlefleetx_tpu/ops/decode_attention.py:524",
    "paged_decode_q8": "paddlefleetx_tpu/ops/decode_attention.py:524",
}
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 1e-4}
MAX_NEW = 32
# request D: eight prompts in the 64-token bucket, mixed left pads
D_LENS = [12, 20, 28, 36, 44, 52, 60, 64]
# phase 6: paged rows (block 16) at these positions, one per row
KV_BLOCK = 16
PAGED_POS = [5, 17, 80, 200, 511, 700, 1000, 1023]
N_LAYERS = 24


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_toolchain(torch, build):
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    t0 = time.time()
    build.build()
    log(f"build: {time.time() - t0:.1f}s ({', '.join(build.SOURCES)})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain version
# ---------------------------------------------------------------------------


def make_inputs(torch, da, kind, b, n, t, d, L, limit, vf, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn(b, n, t, d, generator=g, device="cuda").to(qdt)
    k = torch.randn(b, n, L, d, generator=g, device="cuda")
    v = torch.randn(b, n, L, d, generator=g, device="cuda")
    ks = vs = None
    if kind == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    vft = torch.tensor(vf, dtype=torch.int32, device="cuda")
    return q, k, v, vft, ks, vs


def event_ms(torch, fn, iters):
    """Mean device time of ``fn`` with the L2 cache flushed before each
    call (a decode step finds the layer's cache cold: the whole model's
    weights stream between two visits).  The 512 MiB flush also keeps the
    card busy while the host enqueues ``fn``, so launch latency stays
    out of the timed interval."""
    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(kind, b, n, t, d, limit, vf):
    """Least time for the work these inputs need: each needed byte moved
    once (q, the visible K/V and scales, the f32 output) against the
    unmasked (query, key) pairs' 4*d operations per head."""
    elt = {"float32": 4, "bfloat16": 2, "int8": 1}[kind]
    q_elt = 4 if kind == "float32" else 2
    keys = sum(max(0, limit - v) for v in vf)
    nbytes = b * n * t * d * (q_elt + 4) + 2 * n * keys * d * elt + 4 * b
    if kind == "int8":
        nbytes += 2 * n * keys * 4
    pairs = 0
    for v in vf:
        for r in range(t):
            pairs += max(0, (limit - t + r) - v + 1)
    ops = 4 * d * n * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_case(torch, F, da, kind, b, n, t, d, L, limit, vf, seed=0, iters=20):
    q, k, v, vft, ks, vs = make_inputs(torch, da, kind, b, n, t, d, L, limit, vf, seed)
    scale = 1.0 / d**0.5
    got = da.flash_decode(q, k, v, limit, vft, scale, ks, vs)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k, v, limit, vft, da.decode_block(L), scale, ks, vs)
    check(bool(torch.isfinite(got).all()), f"{kind} kernel output not finite")
    err = (got - ref).abs().max().item()
    check(err <= TOL[kind], f"{kind} kernel vs plain: max |err| {err} > {TOL[kind]} "
                            f"at b={b} t={t} L={L} limit={limit}")
    ms = event_ms(torch, lambda: da.flash_decode(q, k, v, limit, vft, scale, ks, vs), iters)
    plain_ms = event_ms(torch, lambda: da.decode_attention_plain(
        q, k, v, limit, vft, da.decode_block(L), scale, ks, vs), max(3, iters // 4))
    library_ms = None
    if kind != "int8":
        col = torch.arange(limit, device="cuda")
        qpos = limit - t + torch.arange(t, device="cuda")
        mask = (col[None, :] <= qpos[:, None])[None, None] & (
            col[None, None, None, :] >= vft[:, None, None, None])
        kk, vv = k[:, :, :limit], v[:, :, :limit]
        library_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=mask), iters)
    bound_ms, bound_by = bound(kind, b, n, t, d, limit, vf)
    return {"kind": kind, "b": b, "t": t, "L": L, "limit": limit,
            "max_abs_err": err, "tol": TOL[kind], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def sweep_cases():
    n, d, L = 16, 64, 1024
    cases = []
    for b in (1, 8):
        for limit in (128, 512, 1024):
            cases.append((b, n, 1, d, L, limit, [0] * b))
    cases.append((1, n, 512, d, L, 512, [37]))
    cases.append((8, n, 512, d, L, 512, [0, 17, 100, 255, 0, 3, 400, 511]))
    return cases


def main_path_shape():
    """The decode step of request D in phase 4: batch 8 in the 64-token
    bucket, 32 new tokens (cache 96), halfway through the decode."""
    return (8, 16, 1, 64, 64 + MAX_NEW, 64 + MAX_NEW // 2, [64 - n for n in D_LENS])


def phase_kernels(torch, F, da):
    rows = []
    for kind in ("bfloat16", "float32", "int8"):
        for b, n, t, d, L, limit, vf in sweep_cases():
            row = kernel_case(torch, F, da, kind, b, n, t, d, L, limit, vf)
            rows.append(row)
            lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
            log(f"  {kind:8s} b={b} t={t:3d} limit={limit:4d}: err {row['max_abs_err']:.2e} "
                f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} library {lib} "
                f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
    main = {}
    for name, kind in (("flash_decode", "bfloat16"), ("flash_decode_q8", "int8")):
        main[name] = kernel_case(torch, F, da, kind, *main_path_shape(), iters=50)
    log("kernel_cases " + json.dumps({"cases": rows}))
    return main


# ---------------------------------------------------------------------------
# phase 4: the serve CLI at full width
# ---------------------------------------------------------------------------


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(port, path, body=None, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def prompts(seed, lens, vocab=50304):
    import random

    rnd = random.Random(seed)
    return [[rnd.randrange(1, vocab - 100) for _ in range(n)] for n in lens]


def check_rows(rows, what):
    check(isinstance(rows, list) and rows, f"{what}: no completions")
    for row in rows:
        check(isinstance(row, list) and 0 < len(row) <= MAX_NEW
              and all(isinstance(x, int) and 0 <= x < 50304 for x in row),
              f"{what}: bad completion {str(row)[:200]}")


def serve_once(kv_dtype, env):
    port = free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), "-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}"]
    if kv_dtype:
        cmd += ["--kv-dtype", kv_dtype]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out_lines = []
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        health = None
        while health is None:
            check(proc.poll() is None,
                  f"server exited {proc.returncode}: {''.join(out_lines)[-3000:]}")
            check(time.time() - t0 < 420, "server did not come up in 420 s")
            try:
                health = http(port, "/healthz", timeout=5)
            except OSError:
                time.sleep(1)
        boot_s = time.time() - t0
        check(health["identity"]["device"].startswith("cuda"), f"server device {health}")
        # the counts start at 0 when traffic begins (warmup launches excluded)
        check(all(v == 0 for v in health["kernels"].values()),
              f"kernel counts not 0 before traffic: {health['kernels']}")
        t1 = time.time()
        a = http(port, "/generate", {"prompt_ids": prompts(1, [20])[0], "max_tokens": MAX_NEW})
        check_rows([a["completion_ids"]], "request A")
        results = {}

        def post(name, body):
            try:
                results[name] = http(port, "/generate", body)
            except Exception as e:  # noqa: BLE001 — reported below
                results[name] = e

        bc = prompts(2, [30, 40])
        threads = [threading.Thread(target=post, args=("D", {
            "prompts_ids": prompts(3, D_LENS), "max_tokens": MAX_NEW}))]
        threads[0].start()
        time.sleep(0.05)  # D holds the scheduler: B and C wait and coalesce
        for name, p in zip("BC", bc):
            threads.append(threading.Thread(target=post, args=(name, {
                "prompt_ids": p, "max_tokens": MAX_NEW})))
            threads[-1].start()
        for th in threads:
            th.join(timeout=600)
        for name in "DBC":
            check(isinstance(results.get(name), dict), f"request {name}: {results.get(name)}")
        check_rows(results["D"]["completions_ids"], "request D")
        check(len(results["D"]["completions_ids"]) == 8, "request D: rows")
        check_rows([results["B"]["completion_ids"], results["C"]["completion_ids"]], "B/C")
        traffic_s = time.time() - t1
        health = http(port, "/healthz", timeout=30)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        check(rc == 0, f"server drain exit {rc}: {''.join(out_lines)[-3000:]}")
        check("drained cleanly" in "".join(out_lines), "no clean-drain line")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(health["queue"]["coalesced_requests"] >= 2,
          f"B and C did not coalesce: {health['queue']}")
    check(health["kernels"]["plain"] == 0, f"plain version ran on the card: {health}")
    key = "flash_decode_q8" if kv_dtype == "int8" else "flash_decode"
    check(health["kernels"][key] > 0, f"{key} never launched: {health['kernels']}")
    log(f"  serve kv={kv_dtype or 'bf16'}: boot {boot_s:.1f}s, 4 requests in "
        f"{traffic_s:.2f}s, kernels {health['kernels']}, queue {health['queue']}")
    return health["kernels"], {"B": results["B"]["completion_ids"],
                               "C": results["C"]["completion_ids"]}, bc


# ---------------------------------------------------------------------------
# phase 5: card against CPU at full width, float32
# ---------------------------------------------------------------------------


def phase_card_vs_cpu(torch, bc):
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.ops import decode_attention as da
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG), ["Model.dtype=float32"])
    module = GPTModule(cfg)
    check(module.config.dtype == "float32" and module.config.num_layers == 24, "config")
    gen = G.GenerationConfig(max_dec_len=MAX_NEW, decode_strategy="greedy_search",
                             eos_token_id=50256, pad_token_id=0)
    ids, lens = G.pad_prompts(bc, 0, 64)
    out = {}
    for dev in ("cuda", "cpu"):
        model = module.init_model(cfg.Global.seed, dev)
        before = dict(da.COUNTS)
        with torch.inference_mode():
            cache = G.init_cache(module.config, 2, 64 + MAX_NEW, torch.device(dev))
            pad_len, pos_ids = G._left_pad_prefill(64, lens.to(dev))
            logits = G.forward_cached(model, ids.to(dev), cache, 0,
                                      position_ids=pos_ids, kv_valid_from=pad_len)
            first = logits[:, -1].float().cpu()
        toks = G.generate(model, ids.to(dev), gen, prompt_lens=lens.to(dev)).cpu()
        used = {k: da.COUNTS[k] - before[k] for k in da.COUNTS}
        out[dev] = (first, toks, used)
        del model
    check(out["cuda"][2]["flash_decode"] > 0 and out["cuda"][2]["plain"] == 0,
          f"card run did not take the kernel: {out['cuda'][2]}")
    check(out["cpu"][2]["plain"] > 0, "cpu run did not take the plain version")
    err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    check(err <= 1e-3, f"first-step logits card vs cpu: max |err| {err} > 1e-3")
    same = torch.equal(out["cuda"][1], out["cpu"][1])
    if not same:
        diff = (out["cuda"][1] != out["cpu"][1]).nonzero()[0].tolist()
        log(f"  DIVERGENCE at row {diff[0]} step {diff[1]}")
    check(same, "greedy tokens differ between card and cpu at float32")
    log(f"  card vs cpu f32: first-step logits max |err| {err:.3e}, greedy tokens identical")


# ---------------------------------------------------------------------------
# phase 6: the paged kernel against its plain version
# ---------------------------------------------------------------------------


def paged_inputs(torch, da, kind, b, n, t, d, bs, positions, seed):
    """Pools [nb, n, bs, d] holding each row's blocks at shuffled pool
    ids, tables [b, M] null-padded past each row's last needed block (M a
    power of two, as the engine's width bucket), q [b, t, n, d]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    need = [(p + t - 1) // bs + 1 for p in positions]
    M = 1
    while M < max(need):
        M *= 2
    nb = sum(need) + 1
    ids = (torch.randperm(nb - 1, device="cuda", generator=g) + 1).tolist()
    tables = torch.zeros((b, M), dtype=torch.int32)
    at = 0
    for i, k in enumerate(need):
        tables[i, :k] = torch.tensor(ids[at:at + k], dtype=torch.int32)
        at += k
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn(b, t, n, d, generator=g, device="cuda").to(qdt)
    k = torch.randn(nb, n, bs, d, generator=g, device="cuda")
    v = torch.randn(nb, n, bs, d, generator=g, device="cuda")
    ks = vs = None
    if kind == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, k, v, tables.cuda(), pos, ks, vs


def paged_bound(kind, b, n, t, d, positions, M):
    """Least time for the work these inputs need: q, each row's visible
    K/V (and scales) and its table read once, the f32 output written once,
    against the 4*d operations per head of every unmasked (query, key)."""
    elt = {"float32": 4, "bfloat16": 2, "int8": 1}[kind]
    q_elt = 4 if kind == "float32" else 2
    keys = sum(p + t for p in positions)
    nbytes = b * n * t * d * (q_elt + 4) + 2 * n * keys * d * elt + 4 * b * (M + 1)
    if kind == "int8":
        nbytes += 2 * n * keys * 4
    pairs = sum(p + r + 1 for p in positions for r in range(t))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * d * n * pairs / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def paged_case(torch, F, da, kind, t, positions, seed=0, iters=20):
    """Two checks against the plain version on the same inputs: the
    kernel's own float32 output [b, n, t, d] (``max_abs_err``, at the
    input type's tolerance), and the wrapper the engine calls
    (``paged_decode_attention``: q [b, t, n, d] in, the kernel's output
    transposed back and cast to q's dtype) against the plain output given
    the same layout and cast (``wrapper_err``, at the output type's
    tolerance: bf16 for an int8 cache read by a bf16 model).  ``ms`` times
    the wrapper, ``launch_ms`` the bare kernel launch, ``plain_ms`` the
    plain version with the wrapper's layout work."""
    b, n, d, bs = len(positions), 16, 64, KV_BLOCK
    q, k, v, tables, pos, ks, vs = paged_inputs(torch, da, kind, b, n, t, d, bs,
                                                positions, seed)
    q_t = q.transpose(1, 2).contiguous()
    scale = 1.0 / d**0.5

    def launch():
        return da._paged_launch(q_t, k, v, tables, pos, scale, ks, vs)

    def kernel():
        return da.paged_decode_attention(q, k, v, tables, pos, k_scale=ks, v_scale=vs)

    def plain():
        out = da.paged_decode_attention_plain(q.transpose(1, 2).contiguous(), k, v, tables,
                                              pos, scale, ks, vs)
        return out.transpose(1, 2).to(q.dtype)

    raw = launch()
    got = kernel()
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"paged {kind} t={t}: wrapper gave {got.dtype} {tuple(got.shape)}")
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, pos, scale, ks, vs)
    check(bool(torch.isfinite(raw).all() and torch.isfinite(got).all()),
          f"paged {kind} t={t}: output not finite")
    err = (raw - ref).abs().max().item()
    check(err <= TOL[kind], f"paged {kind} t={t} kernel vs plain: max |err| {err} > "
                            f"{TOL[kind]}")
    out_kind = "float32" if q.dtype == torch.float32 else "bfloat16"
    wrapper_err = (got.float() - ref.transpose(1, 2).to(q.dtype).float()).abs().max().item()
    check(wrapper_err <= TOL[out_kind], f"paged {kind} t={t} wrapper vs plain: max |err| "
                                        f"{wrapper_err} > {TOL[out_kind]}")
    ms = event_ms(torch, kernel, iters)
    launch_ms = event_ms(torch, launch, iters)
    plain_ms = event_ms(torch, plain, max(3, iters // 4))
    library_ms = None
    if kind != "int8":
        # the same rows' K/V gathered into a dense [b, n, L, d] cache first
        # (not timed), then one SDPA call with the per-query causal mask
        L = max(positions) + t
        kd = torch.zeros((b, n, L, d), dtype=k.dtype, device="cuda")
        vd = torch.zeros_like(kd)
        for i, p in enumerate(positions):
            row = tables[i, : (p + t - 1) // bs + 1].long()
            kd[i, :, : p + t] = k[row].transpose(0, 1).reshape(n, -1, d)[:, : p + t]
            vd[i, :, : p + t] = v[row].transpose(0, 1).reshape(n, -1, d)[:, : p + t]
        col = torch.arange(L, device="cuda")
        qpos = pos[:, None] + torch.arange(t, device="cuda")[None, :]
        mask = (col[None, None, :] <= qpos[:, :, None])[:, None]  # [b, 1, t, L]
        lib = F.scaled_dot_product_attention(q_t, kd, vd, attn_mask=mask)
        lib_err = (lib.float() - ref).abs().max().item()
        check(lib_err <= 2 * TOL[kind] + 1e-2, f"gathered SDPA disagrees: {lib_err}")
        library_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(
            q_t, kd, vd, attn_mask=mask), iters)
    bound_ms, bound_by = paged_bound(kind, b, n, t, d, positions, tables.shape[1])
    return {"kind": kind, "b": b, "t": t, "bs": bs, "positions": positions,
            "max_abs_err": err, "tol": TOL[kind], "wrapper_err": wrapper_err,
            "wrapper_tol": TOL[out_kind], "ms": ms, "launch_ms": launch_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def paged_poison(torch, da):
    """NaN in every pool block no row can see (the null block that pads
    the tables included, and one spare block past the rows' own): the
    wrapper must give the same finite result, which agrees with the plain
    version on the clean pools."""
    positions = PAGED_POS
    b, t, n, d, bs = len(positions), 4, 16, 64, KV_BLOCK
    q, k, v, tables, pos, _, _ = paged_inputs(torch, da, "float32", b, n, t, d, bs,
                                              positions, 5)
    k = torch.cat([k, k[:1]])
    v = torch.cat([v, v[:1]])
    ref = da.paged_decode_attention_plain(q.transpose(1, 2).contiguous(), k, v, tables, pos,
                                          1.0 / d**0.5).transpose(1, 2)
    clean = da.paged_decode_attention(q, k, v, tables, pos)
    seen = set()
    for i, p in enumerate(positions):
        seen.update(tables[i, : (p + t - 1) // bs + 1].tolist())
    unseen = [x for x in range(k.shape[0]) if x not in seen]
    k[unseen] = float("nan")
    v[unseen] = float("nan")
    got = da.paged_decode_attention(q, k, v, tables, pos)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and torch.equal(got, clean),
          "paged kernel read a block past a row's bound (NaN poison)")
    err = (got - ref).abs().max().item()
    check(err <= TOL["float32"], f"paged NaN poison vs plain on clean pools: {err}")
    log(f"  paged NaN poison: {len(unseen)} unseen pool blocks poisoned, result unchanged, "
        f"vs plain {err:.2e}")


def paged_main_positions():
    """The decode step of phase 7 halfway through: its eight prompts at 16
    generated tokens each."""
    return [n + MAX_NEW // 2 for n in D_LENS]


def phase_paged(torch, F, da):
    rows = []
    for kind in ("bfloat16", "float32", "int8"):
        for t in (1, 4):
            row = paged_case(torch, F, da, kind, t, PAGED_POS)
            rows.append(row)
            lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
            log(f"  paged {kind:8s} b=8 t={t}: err {row['max_abs_err']:.2e} (wrapper "
                f"{row['wrapper_err']:.2e}) wrapper "
                f"{row['ms']:.4f} ms (launch {row['launch_ms']:.4f}) plain "
                f"{row['plain_ms']:.4f} library {lib} bound {row['bound_ms']:.4f} "
                f"({row['bound_by']})")
    paged_poison(torch, da)
    main = {}
    for name, kind in (("paged_decode", "bfloat16"), ("paged_decode_q8", "int8")):
        main[name] = row = paged_case(torch, F, da, kind, 1, paged_main_positions(), iters=50)
        log(f"  {name} main-path step: err {row['max_abs_err']:.2e} (wrapper "
            f"{row['wrapper_err']:.2e}) wrapper "
            f"{row['ms']:.4f} ms (launch {row['launch_ms']:.4f}) plain "
            f"{row['plain_ms']:.4f} bound {row['bound_ms']:.5f} ({row['bound_by']})")
    log("paged_cases " + json.dumps({"cases": rows}))
    return main


# ---------------------------------------------------------------------------
# phase 7: the continuous path at full width
# ---------------------------------------------------------------------------


def serve_continuous(kv_dtype, env):
    port = free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), "--scheduler", "continuous", "--cb-batch", "8",
           "-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}"]
    if kv_dtype:
        cmd += ["--kv-dtype", kv_dtype]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out_lines = []
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    ps = prompts(7, D_LENS)
    results, sent, done = {}, {}, {}

    def post(i):
        sent[i] = time.time()
        try:
            results[i] = http(port, "/generate", {"prompt_ids": ps[i], "max_tokens": MAX_NEW})
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = e
        done[i] = time.time()

    try:
        health = None
        while health is None:
            check(proc.poll() is None,
                  f"server exited {proc.returncode}: {''.join(out_lines)[-3000:]}")
            check(time.time() - t0 < 420, "server did not come up in 420 s")
            try:
                health = http(port, "/healthz", timeout=5)
            except OSError:
                time.sleep(1)
        boot_s = time.time() - t0
        check(health["identity"]["device"].startswith("cuda"), f"server device {health}")
        check(all(v == 0 for v in health["kernels"].values()),
              f"kernel counts not 0 before traffic: {health['kernels']}")
        steps0 = health["serving"]["steps"]
        t1 = time.time()
        threads = [threading.Thread(target=post, args=(0,))]
        threads[0].start()
        # the first row is decoding before the others arrive, one by one
        while http(port, "/healthz", timeout=30)["serving"]["steps"] < steps0 + 2:
            check(time.time() - t1 < 120, "the first request never stepped")
            time.sleep(0.01)
        for i in range(1, len(ps)):
            threads.append(threading.Thread(target=post, args=(i,)))
            threads[-1].start()
            time.sleep(0.03)
        for th in threads:
            th.join(timeout=600)
        traffic_s = time.time() - t1
        for i in range(len(ps)):
            check(isinstance(results.get(i), dict), f"request {i}: {results.get(i)}")
            check_rows([results[i]["completion_ids"]], f"request {i}")
        health = http(port, "/healthz", timeout=30)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        check(rc == 0, f"server drain exit {rc}: {''.join(out_lines)[-3000:]}")
        check("drained cleanly" in "".join(out_lines), "no clean-drain line")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    kernels, serving = health["kernels"], health["serving"]
    key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
    steps = serving["steps"] - steps0
    check(kernels["paged_plain"] == 0 and kernels["plain"] == 0,
          f"plain version ran on the card: {kernels}")
    check(kernels[key] > 0 and kernels[key] == N_LAYERS * steps,
          f"{key}: {kernels[key]} launches for {steps} engine steps")
    check(kernels["flash_decode"] > 0, f"the prefill did not run flash_decode: {kernels}")
    check(serving["mid_decode_admits"] >= 1, f"no row joined mid-decode: {serving}")
    check(health["queue"]["completed"] == len(D_LENS), f"queue {health['queue']}")
    lat = [done[i] - sent[i] for i in range(len(D_LENS))]
    log(f"  continuous kv={kv_dtype or 'bf16'}: boot {boot_s:.1f}s, 8 requests in "
        f"{traffic_s:.2f}s (latency {min(lat):.2f}-{max(lat):.2f}s), {steps} engine "
        f"steps, {serving['mid_decode_admits']} mid-decode admissions, kernels {kernels}")
    return kernels, {"boot_s": boot_s, "traffic_s": traffic_s, "latency_s": lat,
                     "steps": steps, "mid_decode_admits": serving["mid_decode_admits"]}


# ---------------------------------------------------------------------------
# phase 8: the paged engine on the card against the CPU, float32
# ---------------------------------------------------------------------------


def phase_paged_card_vs_cpu(torch, bc, kv_dtype):
    """float32 model; ``kv_dtype`` "" keeps float32 pools (paged_decode),
    "int8" quantizes them (paged_decode_q8).  The first step's logits come
    from the prefill; the second's from the paged kernel over the arena."""
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.ops import decode_attention as da
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG), [
        "Model.dtype=float32", "Generation.decode_strategy=greedy_search",
        f"Generation.max_dec_len={MAX_NEW}"])
    module = GPTModule(cfg)
    check(module.config.dtype == "float32" and module.config.num_layers == N_LAYERS, "config")
    out = {}
    for dev in ("cuda", "cpu"):
        server = GenerationServer(cfg, module, module.init_model(cfg.Global.seed, dev),
                                  torch.device(dev))
        eng = PagedDecodeEngine(server, max_batch=2, block=KV_BLOCK, kv_dtype=kv_dtype)
        before = dict(da.COUNTS)
        slots = [eng.admit(p, MAX_NEW) for p in bc]
        first = eng._logits[slots].cpu()
        eng.step()
        second = eng._logits[slots].cpu()
        while eng.active.any():
            eng.step()
        used = {k: da.COUNTS[k] - before[k] for k in da.COUNTS}
        out[dev] = (first, second, [eng.slots[s].tokens for s in slots], used)
        del eng, server
    key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
    check(out["cuda"][3][key] > 0 and out["cuda"][3]["paged_plain"] == 0,
          f"card run did not take {key}: {out['cuda'][3]}")
    check(out["cpu"][3]["paged_plain"] > 0, "cpu run did not take the plain version")
    errs = [(out["cuda"][i] - out["cpu"][i]).abs().max().item() for i in (0, 1)]
    # float32 pools: both steps at 1e-3; int8 pools: the first step (the
    # second reads K/V quantized separately on each device)
    checked = errs if kv_dtype == "" else errs[:1]
    check(max(checked) <= 1e-3,
          f"paged logits card vs cpu (kv {kv_dtype or 'f32'}): max |err| {errs} > 1e-3")
    check(out["cuda"][2] == out["cpu"][2],
          f"paged greedy tokens differ: {out['cuda'][2]} vs {out['cpu'][2]}")
    check(all(0 < len(r) <= MAX_NEW for r in out["cuda"][2]), "paged rows empty")
    log(f"  paged card vs cpu, f32 model, kv {kv_dtype or 'f32'}: logits max |err| step 1 "
        f"{errs[0]:.3e}, step 2 {errs[1]:.3e}; greedy tokens identical "
        f"({[len(r) for r in out['cuda'][2]]} tokens)")


# ---------------------------------------------------------------------------


def main():
    import torch

    check(torch.cuda.is_available(), "no CUDA device visible to torch")
    check((REPO / "paddlefleetx_tpu_torch" / "csrc").is_dir() and (REPO / CONFIG).is_file(),
          f"{REPO} is not a checkout of the repo (paddlefleetx_tpu_torch/ missing)")
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    from paddlefleetx_tpu_torch.ops import _build
    from paddlefleetx_tpu_torch.ops import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    log(f"card: {card}")
    log("== phase 1-2: toolchain and build")
    phase_toolchain(torch, _build)
    log("== phase 3: kernels against their plain version")
    main_rows = phase_kernels(torch, F, da)
    log("== phase 4: serve GPT-345M at full width")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    counts_bf16, _, bc = serve_once("", env)
    counts_q8, _, _ = serve_once("int8", env)
    log("== phase 5: card against cpu, float32, full width")
    phase_card_vs_cpu(torch, bc)
    log("== phase 6: paged kernel against its plain version")
    paged_rows = phase_paged(torch, F, da)
    log("== phase 7: continuous serving of GPT-345M at full width")
    cb_bf16, wall_bf16 = serve_continuous("", env)
    cb_q8, wall_q8 = serve_continuous("int8", env)
    log("continuous_wall " + json.dumps({"bf16": wall_bf16, "int8": wall_q8}))
    log("== phase 8: paged engine, card against cpu, float32, full width")
    phase_paged_card_vs_cpu(torch, bc, "")
    phase_paged_card_vs_cpu(torch, bc, "int8")
    launches = {"flash_decode": counts_bf16["flash_decode"],
                "flash_decode_q8": counts_q8["flash_decode_q8"],
                "paged_decode": cb_bf16["paged_decode"],
                "paged_decode_q8": cb_q8["paged_decode_q8"]}
    kernels = []
    for name, row in {**main_rows, **paged_rows}.items():
        if name.startswith("paged"):
            shape = {"b": row["b"], "n": 16, "t": row["t"], "d": 64, "bs": row["bs"],
                     "positions": row["positions"], "dtype": row["kind"]}
        else:
            shape = {"b": row["b"], "n": 16, "t": row["t"], "d": 64, "L": row["L"],
                     "limit": row["limit"], "dtype": row["kind"]}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape,
        })
    log(f"total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
