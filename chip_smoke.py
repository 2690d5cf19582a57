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
     type); bf16 q takes the sm90 route (csrc/decode_attention_sm90.cu:
     split-K for t <= 16, tensor cores above) over bf16 caches (K7) and
     int8 caches (K8), each held also at request D's prefill (t=64), t=16
     and t=17, head dim 128, batch 1 at limit 1024, left pads that cut a
     tile and that skip whole tiles; a NaN poison past ``limit`` (in the
     caches, or for int8 in the scales; t=1 over several splits and t=64)
     leaves the output unchanged, and a repeat call gives the same bits;
     the main-path rows of K8 (request D's decode step and its prefill)
     carry bf16 K7's time at the same shape as a yardstick; int8 caches
     under f32 q (the sweep's shapes and the decode step's) and under bf16
     q at head dim 32 take K8's CUDA-core kernel (csrc/decode_attention.cu);
  4. the slice at full width: ``python -m paddlefleetx_tpu_torch.tools.serve
     -c configs/gpt/pretrain_gpt_345M_single.yaml`` (24 layers, hidden
     1024, 16 heads, vocab 50304, bf16, random weights from Global.seed,
     greedy, 32 new tokens) answers four /generate requests, two of them
     coalesced; /healthz must show decode-kernel launches > 0, every bf16
     K7 launch on the sm90 route and no plain-version call; then again
     with --kv-dtype int8 for the q8 kernel (K8), every launch on the sm90
     route; SIGTERM must drain with exit 0 (the traffic runs
     ``TIMED_ROUNDS`` times a server: the first round is the one checked,
     every round is timed for tokens/s);
  5. the same two prompts through the port in float32 on the card
     (kernels) and on the CPU (plain version), same weights: first-step
     logits within 1e-3 and identical greedy tokens;
  6. the paged decode kernel (K9), through the wrapper the engine calls,
     against its plain version on the card at
     GPT-345M shapes (16 heads, head dim 64, block 16, batch 8, positions
     5 .. 1023 over shuffled pool blocks, null-padded tables), decode t=1
     and verify t=4 in bf16, f32 and int8, and at phase 7's decode step in
     bf16 and int8; bf16 q takes the sm90 route
     (csrc/paged_attention_sm90.cu: split-K over the block tables), f32 q
     the CUDA-core one (csrc/paged_attention.cu), and at each sm90 shape
     the CUDA-core kernel is held and timed on the same inputs too, and the
     sm90 kernel timed at 128, 256 and 512 keys a split; CUDA-event times
     of the kernel, the plain version and scaled_dot_product_attention
     over the same rows' K/V already gathered into a dense cache (the
     gather not timed; int8 has none), and the bound; NaN in every pool
     block no row sees and in each row's last block past its bound (int8:
     in the scales there) leaves the output of either route unchanged at
     t=1 and t=4, and a repeat call of the sm90 kernel is bitwise equal;
  7. the continuous path at full width: ``tools.serve --scheduler
     continuous`` answers eight /generate requests of 32 new tokens sent
     at staggered times, so rows join the running batch while others
     decode; /healthz must show paged-kernel launches (24 per engine step),
     every one on the sm90 route, the paged prefills' K7 launches all on
     the sm90 route, and no plain-version call; then again with
     --kv-dtype int8; SIGTERM must drain with exit 0;
  8. two prompts through PagedDecodeEngine in float32 on the card (K9 on
     its CUDA-core route) and on the CPU (plain version), same weights:
     first-step logits within 1e-3 and identical greedy tokens; then again
     with int8 pools (paged_decode_q8 against the plain int8 version);
  9. the flash attention kernels (K3 forward, K4 + K5 split backward, K6
     fused backward) against their plain versions on the card: at the
     training step's shape (micro-batch 8 x 16 heads, seq 1024, head dim
     64, bf16), at batch 16, in f32 at batch 2, and at seqs 40 and 200
     (partial tiles); bf16 K3-K6 take the tensor-core route
     (csrc/flash_attention_sm90.cu), f32 the CUDA-core one; each plain
     version at its kernel's own tile (a partial last tile too: bf16 K3
     128 x 128, K4 128 x 64, K5 and K6 64 x 128, f32 64 x 64); bf16 held
     per row and by the share of elements that differ (``BF16_ROW_TOL``,
     ``BF16_DIFFER_TOL``); with CUDA-event times of the kernel, the plain
     version and scaled_dot_product_attention (forward for K3, its
     autograd backward for K4 + K5 and for K6), and the bound; at the
     training shape also the K4 + K5 pair as one split backward against
     SDPA's backward and the pair's bound;
  10. GPT-345M pretraining at full width through ``Engine(cfg,
     GPTModule(cfg)).train_step``: seq 1024, global batch 16 in two
     micro-batches of 8, bf16 over float32 masters, flash attention,
     selective recompute, AdamW with clip 1.0 at a constant 1e-4, random
     weights from Global.seed and one fixed random batch; 10 steps with
     flash_bwd split (the stock config, F.layer_norm) and 10 with fused and
     use_fused_ln.  Every step must launch K3 and K4 + K5 (split: 48 each)
     or K6 (fused: 48), every launch on the tensor-core route, K1 194 and
     K2 98 times with use_fused_ln (else none), and no plain version; the
     loss must be finite and fall; prints step ms, tokens/s and peak
     memory;
  11. the training step on the card against the CPU at float32: the
     345M width cut to 2 layers, batch 1, seq 512, dropout 0, both
     schedules: loss within 1e-5 relative, every grad within 1e-3 of its
     leaf's largest value, params after one AdamW step from the same
     grads within 1e-5, and params after each device's own train step
     within Adam's first-step sensitivity to the grads' difference;
  12. the fused LayerNorm kernels (K1 forward, K2 backward) against their
     plain versions on the card: the training path's 8192 x 1024 rows in
     bf16 and f32, with and without a residual, and 8191 x 1000 (no
     multiple of a power of two above 8) on the kernels' register paths,
     8191 x 1001 on their strided paths (the path of each row from
     fused_layernorm.register_vecs, the training row's on the register
     path); with CUDA-event times of the kernel, the plain version and
     torch.nn.functional.layer_norm (forward for K1, its autograd backward
     for K2), and the bound; repeat K1 and K2 calls give the same bits;
  13. the train CLI at full width: ``python -m
     paddlefleetx_tpu_torch.tools.train -c
     configs/gpt/pretrain_gpt_345M_single.yaml`` on a synthetic corpus
     (vocab 50304) written under a temporary directory: seq 1024, global
     batch 16 in micro-batches of 8, bf16, flash attention with the fused
     backward, selective recompute, use_fused_ln, AdamW at a constant
     1e-4; 12 steps with a record per step, eval every 6 and checkpoints
     at steps 9 and 12.  Every step launches K1, K2, K3 and K6 (the counts the
     records carry), K3/K6 on the tensor-core route only, and no plain
     version; the loss is finite and falls;
     the records carry tokens/s, mfu and peak memory.  Then a second
     launch resumes from step_9 through auto_resume: steps 10-12 read the
     same batches (consumed_samples and token digests) and their losses
     agree within ``RESUME_LOSS_TOL`` (K6's reduce-adds make the card's
     sums vary from run to run); the checkpoints are deleted;
  14. phase 11 once more with use_fused_ln (K1/K2 on the card against
     their plain versions on the CPU);
  15. K7, K8 and K9 at the speculative verify chunk, t = draft_k + 1 = 5
     (and 8, 16, 17: the last t of the split-K kernels and the first past
     them, K7/K8's tensor-core prefill, K9's CUDA-core kernel): K7/K8 at
     request D's rows halfway, K9 at phase 7's, against their plain
     versions with CUDA-event times, SDPA's (bf16; the int8 rows carry the
     bf16 kernel's time) and the bound; the stale tail a rewind leaves
     (NaN past every query's causal bound: in the cache past pos + t, in
     each row's last block and its reserved slack blocks) leaves the
     output of each unchanged at t = 5;
  16. phases 4 and 7 again with ``--draft-k 4`` (n-gram self-drafting,
     greedy), bf16 and int8 KV, the same requests: /healthz must show
     drafts proposed, every K7/K8 launch a prefill or a multi-query
     verify chunk on the sm90 route (continuous: every K9 launch a t = 5
     launch on the sm90 route), no plain-version call, and SIGTERM must
     drain with exit 0.  Against the plain answers: each row identical up
     to its first difference, and every token of either answer within
     ``SPEC_ULPS`` bf16 ulps of the argmax under teacher forcing of its
     own prefix (the verify chunk's t = 5 GEMMs and attention round
     differently from the t = 1 step's, which flips near-ties of the top
     two logits); prints tokens/s with and without speculation and the
     accept rate;
  17. K9 at chunk width (a chunked prefill's chunk, a prefix hit's suffix):
     one row, 16 heads, d = 64, block 16, bf16 and int8 pools, t = 256 at
     slot 0 and at slot 512 (over a 512-token cached prefix), t = 64 and
     t = 16 at slot 512, against the plain version (bf16 2e-2, int8 1e-4),
     with CUDA-event times of the kernel, the plain version and SDPA over
     the gathered keys with the causal-offset mask (bf16), and the bound;
     t > 16 takes the CUDA-core kernel and counts in ``*_chunk``; NaN in
     the null block, a spare block and past the last query's bound leaves
     the output bitwise unchanged, and a repeat call gives the same bits;
  18. chunked prefill and prefix reuse served at full width:
     ``tools.serve --scheduler continuous --prefill-chunk 256
     --prefix-cache-blocks 40 --prefix-spill-bytes 256 MiB``, bf16 and
     int8 KV, greedy, 32 new tokens.  Two prompt families of a 512-token
     shared prefix and 32-128-token suffixes, sent one at a time as A A A
     B B B A A (the index holds one family's blocks, not two: B evicts A
     to host RAM, A's return reads it back), and a 900-token prompt sent
     while the seventh request decodes.  /healthz must show prefix hits,
     spills, readmits and chunks, prompt tokens computed below the prompts'
     sum, the long prompt's later chunks each run beside a decode step,
     every K9 chunk launch (t = 256) on the CUDA-core route and every
     other K9 launch on the sm90 one, no contiguous prefill and no plain
     call; every answered token within ``SPEC_ULPS`` bf16 ulps of its
     prefix's argmax under teacher forcing;
  19. the same engine flags in float32 on the card, at full width cut to
     ``PFX_F32_LAYERS`` layers: families A, A, B, A (a hit, a spill, a
     readmit) and the 900-token prompt streaming in while A decodes (one
     chunk a step, the decoding row one token a step).  float32 pools:
     greedy tokens identical to the card's own monolithic uncached run,
     each prompt's first-step logits within 1e-3; int8 pools: the reuse
     accounting identical to the float32 pools' run, every chunk on the
     q8 kernel's CUDA-core route;
  20. multi-tenant serving at full width: ``tools.serve --scheduler
     continuous --prefix-cache-blocks`` with a ``--tenants`` file of gold
     (weight 4) and brz (weight 1), bf16 and int8 KV, greedy.  brz fills
     the 8 rows with 96-token requests (the first streamed, in slot 0);
     once every row has committed ``TEN_MIN_TOKENS``, a streamed gold
     request at ``X-Priority: 5`` arrives and must preempt a brz row, which
     resumes as a prefix hit (its suffix a K9 chunk).  /healthz must show
     the preemption, equal to /metrics' ``pfx_tenant_preemptions_total``,
     the admissions per tenant, K9 launches of 24 per engine step and
     chunk with no plain call; streamed frames carry contiguous indices
     across the preemption; every answer token within ``SPEC_ULPS`` bf16
     ulps of its prefix's argmax.  Then ``PFX_FAULT=preempt_storm`` in
     float32 on the card (``PFX_F32_LAYERS`` layers, the prefix cache on):
     the forced preemption's resume gives the undisturbed run's tokens.

Each phase's seconds are printed after it, and all of them in a
``phase_seconds`` line.
Prints one ``kernels`` JSON line, the card line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a card, or outside a checkout of the repo.
"""

import json
import os
import re
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
    "flash_decode": "paddlefleetx_tpu_torch/csrc/decode_attention_sm90.cu",
    "flash_decode_q8": "paddlefleetx_tpu_torch/csrc/decode_attention_sm90.cu",
    "paged_decode": "paddlefleetx_tpu_torch/csrc/paged_attention_sm90.cu",
    "paged_decode_q8": "paddlefleetx_tpu_torch/csrc/paged_attention_sm90.cu",
    "flash_fwd": "paddlefleetx_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_bwd_dq": "paddlefleetx_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_bwd_dkv": "paddlefleetx_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_bwd_fused": "paddlefleetx_tpu_torch/csrc/flash_attention_sm90.cu",
    "fused_ln_fwd": "paddlefleetx_tpu_torch/csrc/fused_layernorm.cu",
    "fused_ln_bwd": "paddlefleetx_tpu_torch/csrc/fused_layernorm.cu",
}
REPLACES = {
    "flash_decode": "paddlefleetx_tpu/ops/decode_attention.py:256",
    "flash_decode_q8": "paddlefleetx_tpu/ops/decode_attention.py:295",
    "paged_decode": "paddlefleetx_tpu/ops/decode_attention.py:524",
    "paged_decode_q8": "paddlefleetx_tpu/ops/decode_attention.py:524",
    "flash_fwd": "paddlefleetx_tpu/ops/flash_attention.py:121",
    "flash_bwd_dq": "paddlefleetx_tpu/ops/flash_attention.py:215",
    "flash_bwd_dkv": "paddlefleetx_tpu/ops/flash_attention.py:249",
    "flash_bwd_fused": "paddlefleetx_tpu/ops/flash_attention.py:305",
    "fused_ln_fwd": "paddlefleetx_tpu/ops/fused_layernorm.py:45",
    "fused_ln_bwd": "paddlefleetx_tpu/ops/fused_layernorm.py:61",
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")
# kernel vs plain, the plain version at each kernel's own tile, a partial
# last tile included (fa.kernel_tile: bf16 on the tensor-core route K3 128
# x 128, K4 128 x 64, K5 and K6 64 x 128; f32 64 x 64).  float32: forward
# max |err|, grads max |err| over the leaf's max (summation order only).
# bfloat16, per kernel: the largest error of a row over that row's largest
# value (one bf16 ulp is up to 2**-7 of it), and the share of elements that
# differ at all (p, ds and the outputs round where float32 sums of another
# order straddle a rounding boundary).  The bf16 limits were set at 2-4x the
# CUDA-core kernels' readings; the tensor-core K4-K6 read up to 0.93 of the
# share's limit at head dim 128 (PERF.md).
FLASH_TOL = {"float32": (1e-4, 2e-4)}
BF16_ROW_TOL = dict.fromkeys(FLASH_KERNELS, 2.0**-6)
BF16_DIFFER_TOL = {"flash_fwd": 5e-4, "flash_bwd_dq": 1.5e-3, "flash_bwd_dkv": 1.5e-3,
                   "flash_bwd_fused": 1.5e-3}
# SDPA against the plain forward (another kernel's rounding order)
SDPA_TOL = {"float32": 1e-2, "bfloat16": 5e-2}
# phase 10: micro-batch 8 of the global 16 at seq 1024; 16 heads of 64
TRAIN_MICRO, TRAIN_GLOBAL, TRAIN_SEQ, TRAIN_STEPS = 8, 16, 1024, 10
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 1e-4}
MAX_NEW = 32
# request D: eight prompts in the 64-token bucket, mixed left pads
D_LENS = [12, 20, 28, 36, 44, 52, 60, 64]
# phase 6: paged rows (block 16) at these positions, one per row
KV_BLOCK = 16
PAGED_POS = [5, 17, 80, 200, 511, 700, 1000, 1023]
# phase 6: keys a split of the sm90 paged kernel, timed against each other
PAGED_SPLIT_KEYS = (128, 256, 512)
# phases 15-16: speculative decoding, draft_k 4 served (t = 5), the kernels
# also held at t = 8, 16 and 17 (K7/K8's prefill kernel, K9's CUDA-core one)
SPEC_K = 4
VERIFY_TS = (SPEC_K + 1, 8, 16, 17)
# an answer token's logit under its prefix's argmax, in bf16 ulps of the
# argmax: ties and near-ties flip with rounding (PERF.md), a wrong token
# sits far below
SPEC_ULPS = 4.0
# phase 17: K9 at chunk width, one row: (t, slot of its first query)
CHUNK_CASES = ((256, 0), (256, 512), (64, 512), (16, 512))
# phases 18-19: prompt families of a PFX_LEN-token shared prefix, chunks of
# PFX_CHUNK, an index of PFX_BLOCKS blocks (one family's published blocks,
# not two), PFX_SPILL bytes of host RAM, and a LONG_PROMPT-token prompt
PFX_LEN, PFX_CHUNK, PFX_BLOCKS, PFX_SPILL = 512, 256, 40, 256 << 20
PFX_FAMILIES = "AAABBBAA"
PFX_SUFFIXES = (32, 64, 96, 128, 48, 80, 112, 40)
LONG_PROMPT = 900
PFX_F32_LAYERS = 4
# phase 20: tenants gold (weight 4) and brz (weight 1).  brz fills the
# TEN_ROWS rows with requests of TEN_BRZ_NEW new tokens (prompts of
# TEN_BRZ_LENS tokens, request 0 streamed and admitted first, so it holds
# slot 0: the victim, whose stream then spans the preemption); a gold
# request of TEN_GOLD_LEN tokens at priority TEN_GOLD_PRIORITY arrives once
# every row has committed TEN_MIN_TOKENS (the preemption floor), streamed
TEN_ROWS, TEN_BRZ_NEW, TEN_MIN_TOKENS, TEN_GOLD_PRIORITY = 8, 96, 8, 5
TEN_BRZ_LENS = (100, 112, 80, 128, 64, 96, 90, 120)
TEN_GOLD_LEN = 72
TEN_PREFIX_BLOCKS = 96
TENANTS = {"tenants": {"gold": {"weight": 4}, "brz": {"weight": 1}}}
# phase 20's float32 preempt_storm drill: 4 rows, fired at iteration
# STORM_ITER, PFX_F32_LAYERS layers
STORM_ITER, STORM_NEW = 12, 24
# phases 4, 7 and 16: the traffic runs this many times a server, the first
# round checked, every round timed (tokens/s: the rounds' median)
TIMED_ROUNDS = 3
N_LAYERS = 24
# phase 12: K1/K2 against their plain versions.  float32: summation order
# only; bfloat16 outputs within one bf16 ulp (2**-7 of the value) of the
# plain version's; dscale/dbias (float32 sums over the rows) 1e-4 of the
# largest.  (abs, rel) for y and dx.
LN_TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-5, 2.0**-7)}
LN_SUM_TOL = 1e-4
# phase 13: the train CLI, a checkpoint at step CLI_SAVE (and the final
# one) that the resume starts from (the step count stays: the data order
# depends on it)
CLI_STEPS, CLI_EVAL_FREQ, CLI_EVAL_ITERS, CLI_SAVE = 12, 6, 2, 9
# losses of steps 10-12, resumed run against the first, relative: K6 adds
# dq with reductions in L2, so the card's sums differ from run to run.  15-20x
# the largest differences read (4.6e-6 and 6.7e-6, PERF.md)
RESUME_LOSS_TOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


PHASE_S = {}
_PHASE = {"name": None, "t0": 0.0}


def begin(name, title=""):
    """Start phase ``name`` (None: end the last one): logs the header and
    the seconds the previous phase took."""
    now = time.time()
    if _PHASE["name"] is not None:
        PHASE_S[str(_PHASE["name"])] = round(now - _PHASE["t0"], 1)
        log(f"   (phase {_PHASE['name']}: {PHASE_S[str(_PHASE['name'])]:.1f}s)")
    _PHASE.update(name=name, t0=now)
    if name is not None:
        log(f"== phase {name}: {title}")


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
        kernel = "?"
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                kernel = ptxas_kernel(line.split("'")[1])
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")


def ptxas_kernel(mangled):
    """``name<template args>`` of a kernel's mangled entry name: the
    length-prefixed identifier that ends in ``_kernel``, and the integer
    and bool arguments of its template (``flash_bwd_kv_sm90_kernel<64,0>``)."""
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        at = m.start() + len(m.group(1))
        name = mangled[at:at + int(m.group(1))]
        if name.endswith("_kernel"):
            args = re.findall(r"L[a-z](\d+)E", mangled[at + len(name):].split("Ev", 1)[0])
            return f"{name}<{','.join(args)}>" if args else name
    return mangled


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain version
# ---------------------------------------------------------------------------


def make_inputs(torch, da, kind, b, n, t, d, L, limit, vf, seed, q_kind=None):
    """q in ``q_kind`` (by default float32 for float32 caches, else bf16)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qdt = torch.float32 if (q_kind or kind) == "float32" else torch.bfloat16
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


def event_ms(torch, fn, iters, flush_mib=512):
    """Mean device time of ``fn`` with the L2 cache flushed before each
    call (a decode step finds the layer's cache cold: the whole model's
    weights stream between two visits).  The flush (512 MiB by default)
    also keeps the card busy while the host enqueues ``fn``, so launch
    latency stays out of the timed interval."""
    flush = torch.empty(flush_mib * 2**20, dtype=torch.uint8, device="cuda")
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


def bound(kind, b, n, t, d, limit, vf, q_kind=None):
    """Least time for the work these inputs need: each needed byte moved
    once (q, the visible K/V and scales, the f32 output) against the
    unmasked (query, key) pairs' 4*d operations per head."""
    elt = {"float32": 4, "bfloat16": 2, "int8": 1}[kind]
    q_elt = 4 if (q_kind or kind) == "float32" else 2
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


def kernel_case(torch, F, da, kind, b, n, t, d, L, limit, vf, seed=0, iters=20, q_kind=None):
    q, k, v, vft, ks, vs = make_inputs(torch, da, kind, b, n, t, d, L, limit, vf, seed, q_kind)
    scale = 1.0 / d**0.5
    route = da.kernel_route(q.dtype, d)  # int8 caches: by q's dtype, as bf16 ones
    key = "flash_decode_q8" if kind == "int8" else "flash_decode"
    before = dict(da.COUNTS)
    got = da.flash_decode(q, k, v, limit, vft, scale, ks, vs)
    torch.cuda.synchronize()
    sm90 = int(route == "sm90")
    multi = int(1 < t <= da.SPLIT_MAX_ROWS)
    check(da.COUNTS[key] - before[key] == 1
          and da.COUNTS[f"{key}_sm90"] - before[f"{key}_sm90"] == sm90
          and da.COUNTS[f"{key}_sm90_prefill"] - before[f"{key}_sm90_prefill"]
          == sm90 * int(t > da.SPLIT_MAX_ROWS)
          and da.COUNTS[f"{key}_multi"] - before[f"{key}_multi"] == multi
          and da.COUNTS[f"{key}_sm90_multi"] - before[f"{key}_sm90_multi"] == multi * sm90,
          f"{kind} b={b} t={t} d={d}: launch off its route {route}")
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
    bound_ms, bound_by = bound(kind, b, n, t, d, limit, vf, q_kind)
    return {"kind": kind, "q": str(q.dtype).split(".")[1], "b": b, "n": n, "t": t, "d": d, "L": L, "limit": limit,
            "valid_from": vf, "route": route, "max_abs_err": err, "tol": TOL[kind],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def sweep_cases():
    n, d, L = 16, 64, 1024
    cases = []
    for b in (1, 8):
        for limit in (128, 512, 1024):
            cases.append((b, n, 1, d, L, limit, [0] * b))
    cases.append((1, n, 512, d, L, 512, [37]))
    cases.append((8, n, 512, d, L, 512, [0, 17, 100, 255, 0, 3, 400, 511]))
    return cases


def sm90_cases():
    """K7 and K8 on the sm90 route at the shapes around its two regimes:
    request D's prefill, each side of t = 16 (split-K / tensor cores), head
    dim 128 on both, and left pads that cut a key stage / tile or skip
    whole ones (batch 1 at limit 1024, where split-K matters, is in
    :func:`sweep_cases`)."""
    n, L = 16, 1024
    d_pads = [64 - x for x in D_LENS]
    return [
        (8, n, 64, 64, 64 + MAX_NEW, 64, d_pads),
        (8, n, 16, 64, L, 300, [0, 5, 40, 70, 100, 130, 200, 280]),
        (8, n, 17, 64, L, 300, [0, 5, 40, 70, 100, 130, 200, 280]),
        (8, n, 1, 128, L, 1024, [0, 17, 100, 255, 0, 3, 400, 700]),
        (8, n, 256, 128, L, 512, [0, 17, 100, 255, 0, 3, 400, 511]),
        (2, n, 1, 64, L, 1000, [70, 3]),
        (2, n, 1, 64, L, 1000, [300, 600]),
        (2, n, 200, 64, L, 700, [70, 3]),
        (2, n, 300, 64, L, 700, [260, 530]),
    ]


def cuda_core_q8_cases():
    """int8 caches under bf16 q at head dim 32 (not an sm90 head dim):
    a decode step with left pads and a prefill."""
    return [(2, 16, 1, 32, 300, 290, [0, 37]), (2, 16, 40, 32, 300, 290, [0, 37])]


def main_path_shape():
    """The decode step of request D in phase 4: batch 8 in the 64-token
    bucket, 32 new tokens (cache 96), halfway through the decode."""
    return (8, 16, 1, 64, 64 + MAX_NEW, 64 + MAX_NEW // 2, [64 - n for n in D_LENS])


def main_prefill_shape():
    """Request D's prefill in phase 4: its eight prompts left-padded into
    the 64-token bucket, the cache 96 (the bucket and 32 new tokens)."""
    return (8, 16, 64, 64, 64 + MAX_NEW, 64, [64 - n for n in D_LENS])


def decode_poison(torch, da, shapes=None):
    """K7 and K8 on the sm90 route: NaN in every cache slot at or past
    ``limit`` (int8: in every scale there, the slots at the int8 extremes)
    leaves the output unchanged, at t = 1 (split-K, several splits) and at
    t = 64 (the tensor-core prefills, whose copies end at ``limit``), or at
    ``shapes``; and a repeat call gives the same bits."""
    shapes = shapes or ((2, 16, 1, 64, 1024, 700, [0, 37]), main_prefill_shape())
    for kind, name in (("bfloat16", "K7"), ("int8", "K8")):
        for b, n, t, d, L, limit, vf in shapes:
            q, k, v, vft, ks, vs = make_inputs(torch, da, kind, b, n, t, d, L, limit, vf, 3)
            scale = 1.0 / d**0.5
            clean = da.flash_decode(q, k, v, limit, vft, scale, ks, vs)
            again = da.flash_decode(q, k, v, limit, vft, scale, ks, vs)
            if kind == "int8":
                ks[:, :, limit:] = float("nan")
                vs[:, :, limit:] = float("nan")
                k[:, :, limit:] = 127
                v[:, :, limit:] = -128
            else:
                k[:, :, limit:] = float("nan")
                v[:, :, limit:] = float("nan")
            got = da.flash_decode(q, k, v, limit, vft, scale, ks, vs)
            torch.cuda.synchronize()
            check(torch.equal(again, clean), f"{name} sm90 t={t}: a repeat call differs")
            check(bool(torch.isfinite(got).all()) and torch.equal(got, clean),
                  f"{name} sm90 t={t}: a NaN past limit={limit} changed the output")
            log(f"  {name} sm90 t={t} limit={limit} L={L}: NaN past limit leaves the output "
                f"unchanged; a repeat call is bitwise equal")


def log_case(row):
    lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    log(f"  {row['kind']:8s} q {row['q']:8s} {row['route']:9s} b={row['b']} t={row['t']:3d} d={row['d']} "
        f"limit={row['limit']:4d}: err {row['max_abs_err']:.2e} kernel {row['ms']:.4f} ms "
        f"plain {row['plain_ms']:.4f} library {lib} bound {row['bound_ms']:.4f} "
        f"({row['bound_by']})")


def phase_kernels(torch, F, da):
    rows = []
    for kind in ("bfloat16", "float32", "int8"):
        for case in sweep_cases() + (sm90_cases() if kind != "float32" else []):
            rows.append(kernel_case(torch, F, da, kind, *case))
            log_case(rows[-1])
    # K8's CUDA-core kernel (csrc/decode_attention.cu): int8 caches under f32 q,
    # or under bf16 q at a head dim the sm90 route does not take
    for case, q_kind in ([(c, "float32") for c in sweep_cases()]
                         + [(c, "bfloat16") for c in cuda_core_q8_cases()]):
        rows.append(kernel_case(torch, F, da, "int8", *case, q_kind=q_kind))
        check(rows[-1]["route"] == "cuda_core", f"int8 {case} q {q_kind}: {rows[-1]['route']}")
        log_case(rows[-1])
    decode_poison(torch, da)
    main = {}
    for name, kind in (("flash_decode", "bfloat16"), ("flash_decode_q8", "int8")):
        main[name] = kernel_case(torch, F, da, kind, *main_path_shape(), iters=50)
        log_case(main[name])
        main[name]["prefill"] = kernel_case(torch, F, da, kind, *main_prefill_shape(), iters=50)
        log_case(main[name]["prefill"])
    # K8's CUDA-core route at the decode step's shape, under f32 q
    q8 = main["flash_decode_q8"]
    q8["cuda_core"] = kernel_case(torch, F, da, "int8", *main_path_shape(), iters=50,
                                  q_kind="float32")
    log_case(q8["cuda_core"])
    # K8's yardstick: bf16 K7 at the same shapes (no PyTorch call takes int8 K/V)
    q8["bf16_k7_ms"] = main["flash_decode"]["ms"]
    q8["prefill"]["bf16_k7_ms"] = main["flash_decode"]["prefill"]["ms"]
    for what, row in (("decode step", q8), ("prefill", q8["prefill"])):
        log(f"  K8 main-path {what}: {row['route']} {row['ms']:.4f} ms, bf16 K7 "
            f"{row['bf16_k7_ms']:.4f} ms, plain {row['plain_ms']:.4f}, bound "
            f"{row['bound_ms']:.5f} ({row['bound_by']})")
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


def serve_once(kv_dtype, env, draft_k=0):
    """Phase 4 (and, with ``draft_k``, phase 16): requests A, D (eight
    prompts), B and C through the coalescing scheduler.  Returns (the
    traffic's kernel counts, the answers by request, B and C's prompts,
    the run's numbers)."""
    port = free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), "-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}"]
    if kv_dtype:
        cmd += ["--kv-dtype", kv_dtype]
    if draft_k:
        cmd += ["--draft-k", str(draft_k)]
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
        serving0 = health["serving"]
        bc = prompts(2, [30, 40])

        def traffic():
            t1 = time.time()
            a = http(port, "/generate", {"prompt_ids": prompts(1, [20])[0],
                                         "max_tokens": MAX_NEW})
            check_rows([a["completion_ids"]], "request A")
            results = {}

            def post(name, body):
                try:
                    results[name] = http(port, "/generate", body)
                except Exception as e:  # noqa: BLE001 — reported below
                    results[name] = e

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
                check(isinstance(results.get(name), dict),
                      f"request {name}: {results.get(name)}")
            check_rows(results["D"]["completions_ids"], "request D")
            check(len(results["D"]["completions_ids"]) == 8, "request D: rows")
            check_rows([results["B"]["completion_ids"], results["C"]["completion_ids"]], "B/C")
            return {"A": [a["completion_ids"]], "D": results["D"]["completions_ids"],
                    "B": [results["B"]["completion_ids"]],
                    "C": [results["C"]["completion_ids"]]}, time.time() - t1

        # the checked round; its counts and answers are the phase's
        answers, traffic_s = traffic()
        health = http(port, "/healthz", timeout=30)
        walls = [traffic_s] + [traffic()[1] for _ in range(TIMED_ROUNDS - 1)]
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
    kernels = health["kernels"]
    check(kernels["plain"] == 0, f"plain version ran on the card: {health}")
    key = "flash_decode_q8" if kv_dtype == "int8" else "flash_decode"
    check(kernels[key] > 0, f"{key} never launched: {kernels}")
    # the bf16 model: every K7 and K8 launch on the sm90 route
    for name in ("flash_decode", "flash_decode_q8"):
        check(kernels[f"{name}_sm90"] == kernels[name],
              f"{name} launches off the sm90 route: {kernels}")
    info = serve_numbers(answers, walls, serving0, health["serving"])
    if draft_k:
        # the 64-token prompt buckets take K7/K8's prefill kernel, every
        # verify chunk (t = draft_k + 1) the split-K kernel: nothing else
        check(info["spec_proposed"] > 0, f"no drafts proposed: {health['serving']}")
        check(kernels[f"{key}_sm90_multi"] == kernels[f"{key}_multi"] > 0
              and kernels[key] == kernels[f"{key}_multi"] + kernels[f"{key}_sm90_prefill"],
              f"{key}: verify chunks off the sm90 split-K kernel: {kernels}")
    log(f"  serve kv={kv_dtype or 'bf16'} draft_k={draft_k}: boot {boot_s:.1f}s, 4 requests "
        f"in {traffic_s:.2f}s ({info['tokens']} tokens; {info['tokens_per_s']:.1f} tokens/s, "
        f"the median of {TIMED_ROUNDS} rounds {[round(w, 3) for w in walls]} s; accept rate "
        f"{info['accept_rate']}), kernels {kernels}, queue {health['queue']}")
    return kernels, answers, bc, info


def serve_numbers(answers, walls, serving0, serving1):
    """Tokens generated a round, tokens/s over each round's wall (and
    their median), and the drafts proposed and accepted during the checked
    round (warmup excluded)."""
    tokens = sum(len(row) for rows in answers.values() for row in rows)
    prop = serving1.get("spec_proposed", 0) - serving0.get("spec_proposed", 0)
    acc = serving1.get("spec_accepted", 0) - serving0.get("spec_accepted", 0)
    rates = sorted(tokens / w for w in walls)
    return {"tokens": tokens, "traffic_s": walls, "tokens_per_s": rates[len(rates) // 2],
            "tokens_per_s_rounds": [tokens / w for w in walls], "spec_proposed": prop,
            "spec_accepted": acc, "accept_rate": round(acc / prop, 4) if prop else None}


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


def paged_inputs(torch, da, kind, b, n, t, d, bs, positions, seed, slack=0):
    """Pools [nb, n, bs, d] holding each row's blocks at shuffled pool
    ids, tables [b, M] null-padded past each row's last needed block, or
    past ``slack`` slots more (a speculative row's reservation; M a power
    of two, as the engine's width bucket), q [b, t, n, d]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    need = [(p + t - 1 + slack) // bs + 1 for p in positions]
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
    the wrapper, ``launch_ms`` the bare kernel launch on its route,
    ``plain_ms`` the plain version with the wrapper's layout work.  On the
    sm90 route, the CUDA-core kernel is held and timed on the same inputs
    too (``cuda_core``), and the sm90 launch at each PAGED_SPLIT_KEYS
    (``split_ms``)."""
    b, n, d, bs = len(positions), 16, 64, KV_BLOCK
    q, k, v, tables, pos, ks, vs = paged_inputs(torch, da, kind, b, n, t, d, bs,
                                                positions, seed)
    q_t = q.transpose(1, 2).contiguous()
    scale = 1.0 / d**0.5
    route = da.paged_kernel_route(q.dtype, d, t, bs)
    key = "paged_decode_q8" if kind == "int8" else "paged_decode"

    def launch(route=route, split_keys=da.PAGED_SPLIT_KEYS):
        return da._paged_launch(q_t, k, v, tables, pos, scale, ks, vs, route=route,
                                split_keys=split_keys)

    def kernel():
        return da.paged_decode_attention(q, k, v, tables, pos, k_scale=ks, v_scale=vs)

    def plain():
        out = da.paged_decode_attention_plain(q.transpose(1, 2).contiguous(), k, v, tables,
                                              pos, scale, ks, vs)
        return out.transpose(1, 2).to(q.dtype)

    before = dict(da.COUNTS)
    raw = launch()
    got = kernel()
    torch.cuda.synchronize()
    check(da.COUNTS[key] - before[key] == 2
          and da.COUNTS[f"{key}_sm90"] - before[f"{key}_sm90"] == 2 * (route == "sm90"),
          f"paged {kind} t={t}: launches off their route {route}")
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"paged {kind} t={t}: wrapper gave {got.dtype} {tuple(got.shape)}")
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, pos, scale, ks, vs)
    check(bool(torch.isfinite(raw).all() and torch.isfinite(got).all()),
          f"paged {kind} t={t}: output not finite")
    err = (raw - ref).abs().max().item()
    check(err <= TOL[kind], f"paged {kind} t={t} kernel ({route}) vs plain: max |err| {err} > "
                            f"{TOL[kind]}")
    out_kind = "float32" if q.dtype == torch.float32 else "bfloat16"
    wrapper_err = (got.float() - ref.transpose(1, 2).to(q.dtype).float()).abs().max().item()
    check(wrapper_err <= TOL[out_kind], f"paged {kind} t={t} wrapper vs plain: max |err| "
                                        f"{wrapper_err} > {TOL[out_kind]}")
    ms = event_ms(torch, kernel, iters)
    launch_ms = event_ms(torch, launch, iters)
    plain_ms = event_ms(torch, plain, max(3, iters // 4))
    cuda_core = split_ms = None
    if route == "sm90":
        cc = launch("cuda_core")
        torch.cuda.synchronize()
        cc_err = (cc - ref).abs().max().item()
        check(cc_err <= TOL[kind], f"paged {kind} t={t} CUDA-core kernel vs plain: {cc_err}")
        cuda_core = {"max_abs_err": cc_err,
                     "launch_ms": event_ms(torch, lambda: launch("cuda_core"), iters)}
        split_ms = {}
        for sk in PAGED_SPLIT_KEYS:
            split_err = (launch(split_keys=sk) - ref).abs().max().item()
            check(split_err <= TOL[kind], f"paged {kind} t={t} split {sk}: {split_err}")
            split_ms[sk] = event_ms(torch, lambda: launch(split_keys=sk), iters)
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
    return {"kind": kind, "b": b, "t": t, "bs": bs, "positions": positions, "route": route,
            "max_abs_err": err, "tol": TOL[kind], "wrapper_err": wrapper_err,
            "wrapper_tol": TOL[out_kind], "ms": ms, "launch_ms": launch_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "cuda_core": cuda_core, "split_ms": split_ms}


def paged_poison(torch, da, positions=PAGED_POS, ts=(1, 4),
                 kinds=("float32", "bfloat16", "int8"), slack=0):
    """NaN in every pool block no row can see (the null block that pads
    the tables included, a row's reserved ``slack`` blocks past its bound,
    and one spare block past the rows' own) and in the slots of each row's
    last block past its bound, positions + t - 1 (int8 pools: NaN scales
    there, the payload at the int8 extremes): the wrapper must give the
    same finite result, on either route (f32: the CUDA-core kernel; bf16,
    int8: sm90 for t <= 16), at each of ``ts``; the f32 result agrees with
    the plain version on the clean pools; a repeat call of the sm90 kernel
    (rows over several splits) gives the same bits."""
    b, n, d, bs = len(positions), 16, 64, KV_BLOCK
    for kind in kinds:
        for t in ts:
            q, k, v, tables, pos, ks, vs = paged_inputs(torch, da, kind, b, n, t, d, bs,
                                                        positions, 5, slack)
            k = torch.cat([k, k[:1]])
            v = torch.cat([v, v[:1]])
            if ks is not None:
                ks = torch.cat([ks, ks[:1]])
                vs = torch.cat([vs, vs[:1]])
            ref = None if kind != "float32" else da.paged_decode_attention_plain(
                q.transpose(1, 2).contiguous(), k, v, tables, pos, 1.0 / d**0.5).transpose(1, 2)
            clean = da.paged_decode_attention(q, k, v, tables, pos, k_scale=ks, v_scale=vs)
            again = da.paged_decode_attention(q, k, v, tables, pos, k_scale=ks, v_scale=vs)
            seen, cuts = set(), []
            for i, p in enumerate(positions):
                last = (p + t - 1) // bs
                seen.update(tables[i, : last + 1].tolist())
                cuts.append((int(tables[i, last]), slice((p + t - 1) % bs + 1, None)))
            unseen = [x for x in range(k.shape[0]) if x not in seen]
            cuts += [(x, slice(None)) for x in unseen]
            for blk, sl in cuts:
                if ks is None:
                    k[blk, :, sl] = float("nan")
                    v[blk, :, sl] = float("nan")
                else:
                    ks[blk, :, sl] = float("nan")
                    vs[blk, :, sl] = float("nan")
                    k[blk, :, sl] = 127
                    v[blk, :, sl] = -128
            got = da.paged_decode_attention(q, k, v, tables, pos, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            route = da.paged_kernel_route(q.dtype, d, t, bs)
            check(route == ("cuda_core" if kind == "float32" or t > da.SPLIT_MAX_ROWS
                            else "sm90"), f"{kind} t={t}: {route}")
            check(torch.equal(again, clean), f"paged {kind} t={t} ({route}): a repeat call "
                                             "differs")
            check(bool(torch.isfinite(got).all()) and torch.equal(got, clean),
                  f"paged {kind} t={t} ({route}): a NaN past a row's bound changed the output")
            if ref is not None:
                err = (got - ref).abs().max().item()
                check(err <= TOL["float32"], f"paged NaN poison vs plain on clean pools: {err}")
            log(f"  paged {kind:8s} t={t} {route:9s}: NaN in {len(unseen)} unseen pool blocks and "
                f"in {b} last blocks past the bound leaves the output unchanged; a repeat call "
                f"is bitwise equal")


def paged_main_positions():
    """The decode step of phase 7 halfway through: its eight prompts at 16
    generated tokens each."""
    return [n + MAX_NEW // 2 for n in D_LENS]


def log_paged(what, row):
    lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    extra = ""
    if row["cuda_core"] is not None:
        cc = row["cuda_core"]
        splits = " ".join(f"{k}:{v:.4f}" for k, v in row["split_ms"].items())
        extra = (f"; cuda_core launch {cc['launch_ms']:.4f} (err {cc['max_abs_err']:.2e}); "
                 f"split keys {splits}")
    log(f"  {what} {row['kind']:8s} {row['route']:9s} t={row['t']}: err "
        f"{row['max_abs_err']:.2e} (wrapper {row['wrapper_err']:.2e}) wrapper {row['ms']:.4f} "
        f"ms (launch {row['launch_ms']:.4f}) plain {row['plain_ms']:.4f} library {lib} bound "
        f"{row['bound_ms']:.5f} ({row['bound_by']}){extra}")


def phase_paged(torch, F, da):
    rows = []
    for kind in ("bfloat16", "float32", "int8"):
        for t in (1, 4):
            rows.append(paged_case(torch, F, da, kind, t, PAGED_POS))
            log_paged("paged b=8 PAGED_POS", rows[-1])
    paged_poison(torch, da)
    main = {}
    for name, kind in (("paged_decode", "bfloat16"), ("paged_decode_q8", "int8")):
        main[name] = row = paged_case(torch, F, da, kind, 1, paged_main_positions(), iters=50)
        log_paged(f"{name} main-path step", row)
    log("paged_cases " + json.dumps({"cases": rows}))
    return main


# ---------------------------------------------------------------------------
# phase 7: the continuous path at full width
# ---------------------------------------------------------------------------


def serve_continuous(kv_dtype, env, draft_k=0):
    """Phase 7 (and, with ``draft_k``, phase 16): eight staggered requests
    through the continuous scheduler.  Returns (the traffic's kernel
    counts, the run's numbers and answers)."""
    port = free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), "--scheduler", "continuous", "--cb-batch", "8",
           "-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}"]
    if kv_dtype:
        cmd += ["--kv-dtype", kv_dtype]
    if draft_k:
        cmd += ["--draft-k", str(draft_k)]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out_lines = []
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    ps = prompts(7, D_LENS)

    def traffic():
        """The first request decoding before the others arrive, one by one;
        returns (answers, latencies, wall)."""
        results, sent, done = {}, {}, {}

        def post(i):
            sent[i] = time.time()
            try:
                results[i] = http(port, "/generate", {"prompt_ids": ps[i],
                                                      "max_tokens": MAX_NEW})
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = e
            done[i] = time.time()

        steps_at = http(port, "/healthz", timeout=30)["serving"]["steps"]
        t1 = time.time()
        threads = [threading.Thread(target=post, args=(0,))]
        threads[0].start()
        while http(port, "/healthz", timeout=30)["serving"]["steps"] < steps_at + 2:
            check(time.time() - t1 < 120, "the first request never stepped")
            time.sleep(0.01)
        for i in range(1, len(ps)):
            threads.append(threading.Thread(target=post, args=(i,)))
            threads[-1].start()
            time.sleep(0.03)
        for th in threads:
            th.join(timeout=600)
        wall = time.time() - t1
        for i in range(len(ps)):
            check(isinstance(results.get(i), dict), f"request {i}: {results.get(i)}")
            check_rows([results[i]["completion_ids"]], f"request {i}")
        return ({"P7": [results[i]["completion_ids"] for i in range(len(ps))]},
                [done[i] - sent[i] for i in range(len(ps))], wall)

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
        serving0 = health["serving"]
        # the checked round; its counts and answers are the phase's
        answers, lat, traffic_s = traffic()
        health = http(port, "/healthz", timeout=30)
        walls = [traffic_s] + [traffic()[2] for _ in range(TIMED_ROUNDS - 1)]
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
    check(kernels[f"{key}_sm90"] == kernels[key],
          f"{key}: launches off the sm90 route (the CUDA-core kernel ran): {kernels}")
    if draft_k:  # every engine step is a verify chunk, t = draft_k + 1
        check(kernels[f"{key}_sm90_multi"] == kernels[f"{key}_multi"] == kernels[key],
              f"{key}: engine steps that were not multi-query sm90 launches: {kernels}")
    check(kernels["flash_decode"] > 0, f"the prefill did not run flash_decode: {kernels}")
    check(kernels["flash_decode_sm90"] == kernels["flash_decode"],
          f"the prefill's bf16 K7 launches off the sm90 route: {kernels}")
    check(serving["mid_decode_admits"] >= 1, f"no row joined mid-decode: {serving}")
    check(health["queue"]["completed"] == len(D_LENS), f"queue {health['queue']}")
    info = serve_numbers(answers, walls, serving0, serving)
    if draft_k:
        check(info["spec_proposed"] > 0, f"no drafts proposed: {serving}")
    log(f"  continuous kv={kv_dtype or 'bf16'} draft_k={draft_k}: boot {boot_s:.1f}s, 8 "
        f"requests in {traffic_s:.2f}s (latency {min(lat):.2f}-{max(lat):.2f}s; "
        f"{info['tokens_per_s']:.1f} tokens/s, the median of {TIMED_ROUNDS} rounds "
        f"{[round(w, 3) for w in walls]} s; accept rate {info['accept_rate']}), {steps} "
        f"engine steps, {serving['mid_decode_admits']} mid-decode admissions, kernels {kernels}")
    info.update({"boot_s": boot_s, "latency_s": lat, "steps": steps,
                 "mid_decode_admits": serving["mid_decode_admits"], "answers": answers})
    return kernels, info


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
    check(out["cuda"][3][f"{key}_sm90"] == 0,
          f"f32 q took the sm90 route, not the CUDA-core one: {out['cuda'][3]}")
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
# phase 9: flash attention kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_bound(name, kind, bh, s, d):
    """Least time for the work: every input read once and every output
    written once (K6's dq as the float32 slab it writes), against the
    causal (query, key) pairs' operations: 4d per pair forward (q.k and
    p.v), 6d for K4 (q.k, do.v, ds.k), 8d for K5 (q.k, do.v, p.do,
    ds.q), 10d for K6 (all five); the split pair K4 + K5 ("flash_bwd_split")
    reads q, k, v, do once and does both kernels' 14d."""
    elt = 4 if kind == "float32" else 2
    one = bh * s * d * elt
    stats = bh * s * 4
    nbytes, per_pair = {
        "flash_fwd": (4 * one + stats, 4 * d),
        "flash_bwd_dq": (5 * one + 2 * stats, 6 * d),
        "flash_bwd_dkv": (6 * one + 2 * stats, 8 * d),
        "flash_bwd_fused": (6 * one + bh * s * d * 4 + 2 * stats, 10 * d),
        "flash_bwd_split": (7 * one + 2 * stats, 14 * d),
    }[name]
    ops = bh * s * (s + 1) // 2 * per_pair
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_event_ms(torch, fn, iters):
    """:func:`event_ms` with a 2 GiB flush, which covers the host work in
    front of an autograd backward (the SDPA yardstick)."""
    return event_ms(torch, fn, iters, flush_mib=2048)


def flash_errors(got, ref):
    """(max |err|, max |err| over the largest |ref| (at least 1), the
    largest error of a row over that row's largest |ref|, the share of
    elements that differ) over the outputs of one kernel."""
    out = []
    for a, r in zip(got, ref):
        a, r = a.float(), r.float()
        diff = (a - r).abs()
        row = (diff.amax(-1) / r.abs().amax(-1).clamp_min(1e-30)).max()
        out.append((diff.max().item(), (diff.max() / max(1.0, r.abs().max().item())).item(),
                    row.item(), (diff > 0).float().mean().item()))
    return tuple(max(x[i] for x in out) for i in range(4))


def flash_blocks(fa, dt):
    """The block each kernel's plain version runs at to round as the
    kernel does: the kernel's own tile on its route for ``dt``."""
    return {name: fa.kernel_tile(name, dt) for name in FLASH_KERNELS}


def flash_case(torch, F, fa, kind, b, n, s, d, iters=10, seed=0, pair=False):
    """Each of K3-K6 on [b*n, s, d] inputs against its plain version at
    that kernel's own tile, so both round alike (the backward kernels on
    the plain forward's lse and delta), with times and bounds.  The plain
    versions are timed at the block the ladder gives ``s``, as the CPU
    path runs them.  Returns (rows, the K4 + K5 pair's row if ``pair``
    else None)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.float32 if kind == "float32" else torch.bfloat16
    q, k, v, do = (torch.randn(b * n, s, d, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    scale, ladder = 1.0 / d**0.5, fa._block_sizes(s)
    blocks = flash_blocks(fa, dt)
    out, lse = fa.launch_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward(q, k, v, scale, blocks["flash_fwd"])
    delta = (do.float() * ref_out.float()).sum(-1)
    args = (q, k, v, do, ref_lse, delta, scale)

    def held(name, got, ref):
        errs = flash_errors(got, ref)
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        if kind == "float32":
            tol = FLASH_TOL[kind][0 if name == "flash_fwd" else 1]
            ok = errs[0 if name == "flash_fwd" else 1] <= tol
        else:
            ok = errs[2] <= BF16_ROW_TOL[name] and errs[3] <= BF16_DIFFER_TOL[name]
        check(finite and ok, f"{name} {kind} s={s}: errors (abs, of max, row, differ) {errs}")
        return errs

    errs = {"flash_fwd": held("flash_fwd", (out,), (ref_out,))}
    lse_err = (lse - ref_lse).abs().max().item()
    check(lse_err <= 1e-4, f"K3 {kind} s={s}: lse err {lse_err}")
    launches = {"flash_bwd_dq": fa.launch_bwd_dq, "flash_bwd_dkv": fa.launch_bwd_dkv,
                "flash_bwd_fused": fa.launch_bwd_fused}
    plains = {"flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv,
              "flash_bwd_fused": fa.flash_bwd_fused}
    for name, launch in launches.items():
        got = launch(*args)
        torch.cuda.synchronize()
        ref = plains[name](*args, blocks[name])
        errs[name] = held(name, got if isinstance(got, tuple) else (got,),
                          ref if isinstance(ref, tuple) else (ref,))
    ms = {"flash_fwd": flash_event_ms(torch, lambda: fa.launch_fwd(q, k, v, scale), iters)}
    plain_ms = {"flash_fwd": event_ms(
        torch, lambda: fa.flash_forward(q, k, v, scale, ladder), max(3, iters // 3))}
    for name, launch in launches.items():
        ms[name] = flash_event_ms(torch, lambda: launch(*args), iters)
        plain_ms[name] = flash_event_ms(torch, lambda: plains[name](*args, ladder),
                                        max(3, iters // 3))
    # the library yardstick: SDPA on the same [b, n, s, d] tensors
    qs, ks, vs, dos = (x.view(b, n, s, d) for x in (q, k, v, do))
    lib_fwd = flash_event_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), iters)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qs, ks, vs))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = flash_event_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dos, retain_graph=True), iters)
    lib_err = (lib_out.detach().reshape(b * n, s, d).float() - ref_out.float()).abs().max().item()
    check(lib_err <= SDPA_TOL[kind], f"SDPA disagrees with the plain forward: {lib_err}")
    rows = {}
    for name in FLASH_KERNELS:
        bound_ms, bound_by = flash_bound(name, kind, b * n, s, d)
        e = errs[name]
        rows[name] = {"kind": kind, "b": b, "n": n, "s": s, "d": d,
                      "route": fa.kernel_route(name, dt), "block": list(blocks[name]),
                      "max_abs_err": e[0], "err_of_max": e[1], "row_err": e[2],
                      "differ": e[3], "ms": ms[name], "plain_ms": plain_ms[name],
                      "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    rows["flash_fwd"]["lse_err"] = lse_err
    split = None
    if pair:  # the split backward as the training step calls it, K4 then K5
        bound_ms, bound_by = flash_bound("flash_bwd_split", kind, b * n, s, d)
        split = {"kind": kind, "b": b, "n": n, "s": s, "d": d,
                 "ms": flash_event_ms(torch, lambda: fa.launch_bwd_split(*args), iters),
                 "k4_plus_k5_ms": ms["flash_bwd_dq"] + ms["flash_bwd_dkv"],
                 "library_ms": lib_bwd, "bound_ms": bound_ms, "bound_by": bound_by,
                 "fused_ms": ms["flash_bwd_fused"],
                 "fused_bound_ms": rows["flash_bwd_fused"]["bound_ms"]}
    return rows, split


def phase_flash(torch, F, fa):
    """The training step's shape first (its rows go to the kernels line),
    then the others."""
    cases = [("bfloat16", TRAIN_MICRO, TRAIN_SEQ), ("bfloat16", 16, TRAIN_SEQ),
             ("float32", 2, TRAIN_SEQ), ("bfloat16", 16, 200), ("float32", 16, 200),
             ("bfloat16", 16, 40), ("float32", 16, 40)]
    main, table = None, []
    for kind, b, s in cases:
        rows, split = flash_case(torch, F, fa, kind, b, 16, s, 64, pair=main is None)
        main = main or rows
        if split:
            log(f"  K4 + K5 (split backward) {kind} b={b} s={s}: {split['ms']:.4f} ms "
                f"(K4 {rows['flash_bwd_dq']['ms']:.4f} + K5 {rows['flash_bwd_dkv']['ms']:.4f}), "
                f"SDPA backward {split['library_ms']:.4f} ms "
                f"({split['ms'] / split['library_ms']:.2f}x), bound {split['bound_ms']:.4f} "
                f"({split['bound_by']}); K6 {split['fused_ms']:.4f}")
            log("flash_split_pair " + json.dumps(split))
        for name, row in rows.items():
            table.append(dict(row, name=name))
            log(f"  {name:16s} {kind:8s} {row['route']:9s} b={b:2d} s={s:4d}: err {row['max_abs_err']:.2e} "
                f"(row {row['row_err']:.2e}, differ {row['differ']:.2e}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} library "
                f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} ({row['bound_by']})")
    log("flash_cases " + json.dumps({"cases": table}))
    return main


# ---------------------------------------------------------------------------
# phase 10: GPT-345M pretraining steps at full width
# ---------------------------------------------------------------------------


def train_config(get_config, extra):
    return get_config(str(REPO / CONFIG), [
        f"Global.global_batch_size={TRAIN_GLOBAL}", f"Global.local_batch_size={TRAIN_GLOBAL}",
        f"Global.micro_batch_size={TRAIN_MICRO}", "Model.attn_impl=flash",
        "Model.use_recompute=True", "Model.recompute_granularity=selective",
        'Optimizer.lr={"name": "Constant", "learning_rate": 1.0e-4}',
        "Optimizer.grad_clip.clip_norm=1.0", *extra])


def host_batch(np, b, s, vocab=50304, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int64),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int64),
            "loss_mask": np.ones((b, s), np.float32),
            "position_ids": np.tile(np.arange(s), (b, 1))}


def phase_train(torch, fa, fl):
    import numpy as np

    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.utils.config import get_config

    batch = host_batch(np, TRAIN_GLOBAL, TRAIN_SEQ)
    out = {}
    # split: the stock config (F.layer_norm); fused: with use_fused_ln (K1/K2)
    for mode in ("split", "fused"):
        fused_ln = mode == "fused"
        cfg = train_config(get_config, [f"Model.flash_bwd={mode}",
                                        f"Model.use_fused_ln={fused_ln}"])
        module = GPTModule(cfg)
        mc = module.config
        check((mc.num_layers, mc.hidden_size, mc.num_attention_heads, mc.vocab_size, mc.dtype)
              == (N_LAYERS, 1024, 16, 50304, "bfloat16"), f"train config {mc}")
        check(cfg.Engine.accumulate_steps == TRAIN_GLOBAL // TRAIN_MICRO, "accumulate_steps")
        t0 = time.time()
        engine = Engine(cfg, module)
        init_s = time.time() - t0
        check(engine.device.type == "cuda", f"engine on {engine.device}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wanted = ("flash_fwd",) + (("flash_bwd_fused",) if mode == "fused"
                                   else ("flash_bwd_dq", "flash_bwd_dkv"))
        fa.reset_counts()
        fl.reset_counts()
        losses, step_s, totals = [], [], dict.fromkeys({**fa.COUNTS, **fl.COUNTS}, 0)
        for _ in range(TRAIN_STEPS):
            before = {**fa.COUNTS, **fl.COUNTS}
            t1 = time.perf_counter()
            m = engine.train_step(batch)  # ends in a host read of the metrics
            step_s.append(time.perf_counter() - t1)
            used = {k: v - before[k] for k, v in {**fa.COUNTS, **fl.COUNTS}.items()}
            # one backward launch per layer and micro-batch, none of the other schedule
            check(all(used[k] == N_LAYERS * TRAIN_GLOBAL // TRAIN_MICRO for k in wanted[1:])
                  and used["flash_fwd"] > 0 and used["flash_plain"] == 0
                  and sum(used[k] for k in fa.KERNELS[1:] if k not in wanted) == 0,
                  f"{mode} step {len(losses)}: flash launches {used}")
            # bf16: every launch on the tensor-core route
            check(all(used[f"{k}_sm90"] == used[k] for k in fa.KERNELS),
                  f"{mode} step {len(losses)}: launches off the sm90 route: {used}")
            # K1 per LayerNorm, twice per layer under selective recompute; K2 once
            per_mb = TRAIN_GLOBAL // TRAIN_MICRO if fused_ln else 0
            check(used["fused_ln_fwd"] == per_mb * (4 * N_LAYERS + 1)
                  and used["fused_ln_bwd"] == per_mb * (2 * N_LAYERS + 1)
                  and used["fused_ln_fwd_plain"] == used["fused_ln_bwd_plain"] == 0,
                  f"{mode} step {len(losses)}: fused LayerNorm launches {used}")
            check(m["found_inf"] == 0.0, f"{mode}: non-finite step {m}")
            losses.append(m["loss"])
            for k in totals:
                totals[k] += used[k]
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{mode}: loss did not fall on the fixed batch: {losses}")
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        out[mode] = {"losses": losses, "step_ms": [x * 1e3 for x in step_s],
                     "median_step_ms": steady * 1e3,
                     "tokens_per_s": TRAIN_GLOBAL * TRAIN_SEQ / steady,
                     "peak_bytes": peak, "init_s": init_s, "launches": totals,
                     "per_step": {k: totals[k] // TRAIN_STEPS
                                  for k in wanted + ("fused_ln_fwd", "fused_ln_bwd")}}
        log(f"  train flash_bwd={mode} use_fused_ln={fused_ln}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, step "
            f"{steady * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
            f"{step_s[0] * 1e3:.1f}), {TRAIN_GLOBAL * TRAIN_SEQ / steady:.0f} tokens/s, peak "
            f"{peak / 2**30:.2f} GiB, launches {totals}")
        del engine
        torch.cuda.empty_cache()
    log("train_steps " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 11: the training step on the card against the CPU, float32
# ---------------------------------------------------------------------------


def phase_train_card_vs_cpu(torch, fa, fused_ln=False):
    """Per schedule (and with ``fused_ln``, through K1/K2 on the card and
    their plain versions on the CPU): the loss and every grad on the card against the CPU
    from the same seeded weights; then the optimizer step held two ways.
    From the same (CPU) grads, the params after one AdamW step must agree
    within 1e-5.  After each device's own train step (accumulation, clip,
    AdamW on the grads the step computed, caught on their way into the
    optimizer) every param must agree within its first-step sensitivity:
    Adam's first step moves a param by lr * g / (|g| + eps) for the
    clipped grad g, which changes by at most |dg| / (min |g| + eps) when
    g does, so the bound is lr * |dg| / (min(|g_card|, |g_cpu|) + eps),
    with float32 rounding room of 2**-16 of it plus 2**-20 * (|p| + lr).
    (Equal and opposite grads far below eps, the rounding noise of a grad
    that is zero in exact arithmetic such as the key bias's, meet the
    bound with equality.)  Where a grad is near
    eps a rounding-level difference in it moves its param by a sizeable
    part of the learning rate, which this bound allows and 1e-5 did not;
    where a grad is well above eps it is far tighter than 1e-5."""
    import numpy as np

    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.models.gpt.bridge import grads_to_jax, params_to_jax
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl
    from paddlefleetx_tpu_torch.optims.optimizer import apply_updates
    from paddlefleetx_tpu_torch.utils.config import get_config

    seq = 512
    batch = host_batch(np, 1, seq, seed=1)
    for mode in ("split", "fused"):
        cfg = get_config(str(REPO / CONFIG), [
            "Global.global_batch_size=1", "Global.local_batch_size=1",
            "Global.micro_batch_size=1", "Model.num_layers=2", "Model.dtype=float32",
            "Engine.mix_precision.enable=False", "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.0", "Model.attn_impl=flash",
            f"Model.flash_bwd={mode}", "Model.use_recompute=True",
            "Model.recompute_granularity=selective", f"Model.use_fused_ln={fused_ln}",
            'Optimizer.lr={"name": "Constant", "learning_rate": 1.0e-4}'])
        module = GPTModule(cfg)
        res, named = {}, {}
        for dev in ("cpu", "cuda"):
            engine = Engine(cfg, module, device=dev)
            before = {**fa.COUNTS, **fl.COUNTS}
            tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            loss = module.loss_fn(engine.model, tb, train=True)
            loss.backward()
            grads = grads_to_jax(engine.model)
            named[dev] = {n: p.grad.detach().cpu() for n, p in engine.params.items()}
            step_grads = {}
            update = engine.tx.update

            def caught(grads, state, params, update=update, step_grads=step_grads):
                step_grads.update({n: g.detach().cpu().double() for n, g in grads.items()})
                return update(grads, state, params)

            engine.tx = engine.tx._replace(update=caught)
            m = engine.train_step(batch)
            used = {k: v - before[k] for k, v in {**fa.COUNTS, **fl.COUNTS}.items()}
            # the optimizer alone: one step of a fresh engine from the CPU's grads
            fresh = Engine(cfg, module, device=dev)
            updates, _ = fresh.tx.update({n: g.to(dev) for n, g in named["cpu"].items()},
                                         fresh.opt_state, fresh.params)
            apply_updates(fresh.params, updates)
            res[dev] = (loss.item(), grads, params_to_jax(engine.model), m, used,
                        params_to_jax(fresh.model), step_grads,
                        {n: p.detach().cpu().double() for n, p in engine.params.items()})
            del engine, fresh
        cu, cp = res["cuda"], res["cpu"]
        key = "flash_bwd_fused" if mode == "fused" else "flash_bwd_dq"
        check(cu[4]["flash_fwd"] > 0 and cu[4][key] > 0 and cu[4]["flash_plain"] == 0
              and all(cu[4][f"{k}_sm90"] == 0 for k in fa.KERNELS),
              f"card run did not take the kernels: {cu[4]}")
        check(cp[4]["flash_plain"] > 0, "cpu run did not take the plain versions")
        ln = ("fused_ln_fwd", "fused_ln_bwd")
        if fused_ln:
            check(all(cu[4][k] > 0 and cu[4][k + "_plain"] == 0 and cp[4][k + "_plain"] > 0
                      and cp[4][k] == 0 for k in ln),
                  f"fused LayerNorm: card {cu[4]}, cpu {cp[4]}")
        else:
            check(all(cu[4][k] == 0 and cp[4][k + "_plain"] == 0 for k in ln),
                  f"fused LayerNorm ran with use_fused_ln off: {cu[4]}, {cp[4]}")
        loss_err = abs(cu[0] - cp[0]) / abs(cp[0])
        check(loss_err <= 1e-5, f"{mode} loss card vs cpu: {loss_err}")
        grad_err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                       for a, b in zip(leaves(cu[1]), leaves(cp[1])))
        check(grad_err <= 1e-3, f"{mode} grads card vs cpu: {grad_err} of the leaf max")
        opt_err = max(float(np.abs(a - b).max()) for a, b in zip(leaves(cu[5]), leaves(cp[5])))
        check(opt_err <= 1e-5, f"{mode} params after one optimizer step from the same grads, "
                               f"card vs cpu: {opt_err}")
        check(cu[3]["found_inf"] == cp[3]["found_inf"] == 0.0
              and abs(cu[3]["grad_norm"] - cp[3]["grad_norm"]) <= 1e-5 * cp[3]["grad_norm"],
              f"{mode} train step metrics card vs cpu: {cu[3]} vs {cp[3]}")
        step_err, ratio, where = first_step_sensitivity(cfg, cu, cp)
        check(ratio <= 1.0, f"{mode} params after each device's own train step: "
                            f"{ratio} of the first-step bound at {where}")
        log(f"  train card vs cpu f32, flash_bwd={mode}, use_fused_ln={fused_ln}: loss {cu[0]:.6f} vs {cp[0]:.6f} "
            f"(rel {loss_err:.2e}), grads {grad_err:.2e} of the leaf max, params after one "
            f"AdamW step from the same grads {opt_err:.2e}, after each device's own train "
            f"step {step_err:.2e} max, {ratio:.6f} of the first-step bound at most (at "
            f"{where}), grad_norm {cu[3]['grad_norm']:.6f} vs {cp[3]['grad_norm']:.6f}")


def first_step_sensitivity(cfg, cu, cp):
    """(max |dp|, max |dp| / bound, where) over every param after one train
    step from the same params on the card (``cu``) and the CPU (``cp``);
    the bound is the docstring's of :func:`phase_train_card_vs_cpu`."""
    import torch

    opt = cfg.Optimizer
    eps, lr = float(opt.get("epsilon", 1e-8)), float(cp[3]["lr"])
    clip = (opt.get("grad_clip") or {}).get("clip_norm")
    scaled = []
    for res in (cu, cp):
        g = res[6]
        norm = float(torch.sqrt(sum(x.square().sum() for x in g.values())))
        c = min(1.0, clip / max(norm, 1e-16)) if clip else 1.0
        scaled.append({n: x * c for n, x in g.items()})
    step_err, ratio, where = 0.0, 0.0, ""
    for n, p_cp in cp[7].items():
        g_cu, g_cp = scaled[0][n], scaled[1][n]
        dp = (cu[7][n] - p_cp).abs()
        lin = lr * (g_cu - g_cp).abs() / (torch.minimum(g_cu.abs(), g_cp.abs()) + eps)
        bound = lin * (1 + 2.0**-16) + 2.0**-20 * (torch.maximum(cu[7][n].abs(), p_cp.abs()) + lr)
        r = dp / bound
        i = int(r.argmax())
        step_err = max(step_err, float(dp.max()))
        if float(r.flatten()[i]) > ratio:
            ratio = float(r.flatten()[i])
            where = (f"{n}[{i}]: dp {float(dp.flatten()[i]):.3e}, grads "
                     f"{float(g_cu.flatten()[i]):.3e} / {float(g_cp.flatten()[i]):.3e}")
    return step_err, ratio, where


def leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    return [tree]


# ---------------------------------------------------------------------------
# phase 12: fused LayerNorm kernels against their plain versions
# ---------------------------------------------------------------------------


def ln_bound(name, kind, rows, n, residual):
    """Least time for the work: every input read once and every output
    written once (K1: x, the residual, scale, bias in; y, mean, rstd out;
    K2: x, the residual, g, scale, mean, rstd in; dx, dscale, dbias out;
    the band partials are scratch), against ~8 (K1) or ~12 (K2) float32
    operations per element on the CUDA cores."""
    elt = 4 if kind == "float32" else 2
    one = rows * n * elt
    vec, stats = n * 4, rows * 4
    if name == "fused_ln_fwd":
        nbytes = (3 if residual else 2) * one + 2 * vec + 2 * stats
        ops = 8 * rows * n
    else:
        nbytes = (4 if residual else 3) * one + 3 * vec + 2 * stats
        ops = 12 * rows * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ln_case(torch, F, fl, kind, rows, n, residual, iters=20, seed=0):
    """K1 and K2 on [rows, n] inputs against their plain versions (K2 on
    the plain forward's mean and rstd), with times and bounds.  Library:
    F.layer_norm with the affine in x's type (over x + res when there is a
    residual), forward for K1 and its autograd backward for K2."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.float32 if kind == "float32" else torch.bfloat16
    x = torch.randn(rows, n, generator=g, device="cuda").to(dt)
    res = torch.randn(rows, n, generator=g, device="cuda").to(dt) if residual else None
    scale = torch.randn(n, generator=g, device="cuda")
    bias = torch.randn(n, generator=g, device="cuda")
    gy = torch.randn(rows, n, generator=g, device="cuda").to(dt)
    y, mean, rstd = fl.launch_fwd(x, res, scale, bias, 1e-5)
    again = fl.launch_fwd(x, res, scale, bias, 1e-5)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(again, (y, mean, rstd))),
          f"fused LayerNorm {kind} {rows}x{n} res={residual}: a repeat K1 call differs")
    vpl = fl.register_vecs(dt, n, x.data_ptr(), None if res is None else res.data_ptr(),
                           scale.data_ptr(), bias.data_ptr(), y.data_ptr())
    ref_y, ref_mean, ref_rstd = fl.layer_norm_fwd_plain(x, res, scale, bias, 1e-5)
    dx, dscale, dbias = fl.launch_bwd(x, res, scale, ref_mean, ref_rstd, gy)
    again = fl.launch_bwd(x, res, scale, ref_mean, ref_rstd, gy)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(again, (dx, dscale, dbias))),
          f"fused LayerNorm {kind} {rows}x{n} res={residual}: a repeat K2 call differs")
    ref_dx, ref_ds, ref_db = fl.layer_norm_bwd_plain(x, res, scale, ref_mean, ref_rstd, gy)
    atol, rtol = LN_TOL[kind]
    errs = {}
    for what, got, ref in (("y", y, ref_y), ("dx", dx, ref_dx)):
        diff = (got.float() - ref.float()).abs()
        errs[what] = diff.max().item()
        excess = (diff - (atol + rtol * ref.float().abs())).max().item()
        check(bool(torch.isfinite(got).all()) and excess <= 0,
              f"fused LayerNorm {kind} {rows}x{n} res={residual}: {what} max |err| "
              f"{errs[what]} over the tolerance ({atol} + {rtol} |ref|)")
    stat_err = max((mean - ref_mean).abs().max().item(),
                   ((rstd - ref_rstd).abs() / ref_rstd).max().item())
    check(stat_err <= 1e-5, f"fused LayerNorm {kind} {rows}x{n}: mean/rstd err {stat_err}")
    for what, got, ref in (("dscale", dscale, ref_ds), ("dbias", dbias, ref_db)):
        errs[what] = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
        check(errs[what] <= LN_SUM_TOL, f"fused LayerNorm {kind} {rows}x{n}: {what} err "
                                        f"{errs[what]} of the largest > {LN_SUM_TOL}")
    ms = {"fused_ln_fwd": event_ms(torch, lambda: fl.launch_fwd(x, res, scale, bias, 1e-5),
                                   iters),
          "fused_ln_bwd": event_ms(torch, lambda: fl.launch_bwd(x, res, scale, ref_mean,
                                                                ref_rstd, gy), iters)}
    plain_ms = {"fused_ln_fwd": event_ms(torch, lambda: fl.layer_norm_fwd_plain(
                    x, res, scale, bias, 1e-5), iters),
                "fused_ln_bwd": event_ms(torch, lambda: fl.layer_norm_bwd_plain(
                    x, res, scale, ref_mean, ref_rstd, gy), iters)}
    w, b = scale.to(dt), bias.to(dt)
    lib_fwd = event_ms(torch, lambda: F.layer_norm(x if res is None else x + res, (n,), w, b,
                                                   1e-5), iters)
    xg, wg, bg = (t.detach().requires_grad_() for t in (x, w, b))
    lib_out = F.layer_norm(xg if res is None else xg + res, (n,), wg, bg, 1e-5)
    lib_err = (lib_out.detach().float() - ref_y.float()).abs().max().item()
    check(lib_err <= 0.1, f"F.layer_norm disagrees with the plain forward: {lib_err}")
    lib_bwd = flash_event_ms(torch, lambda: torch.autograd.grad(lib_out, (xg, wg, bg), gy,
                                                                retain_graph=True), iters)
    rows_out = {}
    for name in ("fused_ln_fwd", "fused_ln_bwd"):
        bound_ms, bound_by = ln_bound(name, kind, rows, n, residual)
        rows_out[name] = {
            "kind": kind, "rows": rows, "n": n, "residual": residual,
            "path": f"register (x{vpl})" if vpl else "strided",
            "max_abs_err": errs["y" if name == "fused_ln_fwd" else "dx"],
            "sum_err": max(errs["dscale"], errs["dbias"]) if name == "fused_ln_bwd" else None,
            "ms": ms[name], "plain_ms": plain_ms[name],
            "library_ms": lib_fwd if name == "fused_ln_fwd" else lib_bwd,
            "bound_ms": bound_ms, "bound_by": bound_by}
    return rows_out


def phase_layernorm(torch, F, fl):
    """The training path's shape first (its rows go to the kernels line),
    then the others."""
    cases = [("bfloat16", 8192, 1024, False), ("bfloat16", 8192, 1024, True),
             ("float32", 8192, 1024, False), ("float32", 8192, 1024, True),
             ("bfloat16", 8191, 1000, False), ("float32", 8191, 1000, True),
             ("bfloat16", 8191, 1001, True), ("float32", 8191, 1001, False)]
    main, table = None, []
    for kind, rows, n, residual in cases:
        out = ln_case(torch, F, fl, kind, rows, n, residual)
        check(out["fused_ln_fwd"]["path"].startswith("strided") == (n % 8 != 0),
              f"fused LayerNorm {kind} {rows}x{n}: path {out['fused_ln_fwd']['path']}")
        main = main or out
        for name, row in out.items():
            table.append(dict(row, name=name))
            log(f"  {name:12s} {kind:8s} {rows}x{n} res={residual!s:5s} {row['path']:12s}: err "
                f"{row['max_abs_err']:.2e} kernel {row['ms']:.4f} ms plain "
                f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']})")
    log("layernorm_cases " + json.dumps({"cases": table}))
    return main


# ---------------------------------------------------------------------------
# phase 13: the train CLI at full width, and its resume
# ---------------------------------------------------------------------------


def train_cli(env, data_dir, out_dir, extra=()):
    """One run of the train CLI; returns its metrics records.  Its output
    is drained by a thread and kept for the failure message."""
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.train", "-c", CONFIG]
    for o in (f"Global.global_batch_size={TRAIN_GLOBAL}",
              f"Global.local_batch_size={TRAIN_GLOBAL}", f"Global.micro_batch_size={TRAIN_MICRO}",
              "Model.attn_impl=flash", "Model.flash_bwd=fused", "Model.use_recompute=True",
              "Model.recompute_granularity=selective", "Model.use_fused_ln=True",
              'Optimizer.lr={"name": "Constant", "learning_rate": 1.0e-4}',
              f"Data.Train.dataset.input_dir={data_dir}", f"Data.Eval.dataset.input_dir={data_dir}",
              f"Engine.max_steps={CLI_STEPS}", "Engine.logging_freq=1",
              f"Engine.eval_freq={CLI_EVAL_FREQ}", f"Engine.eval_iters={CLI_EVAL_ITERS}",
              f"Engine.save_load.save_steps={CLI_SAVE}", f"Engine.save_load.output_dir={out_dir}",
              f"Engine.metrics_file={out_dir}/metrics.jsonl", *extra):
        cmd += ["-o", o]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    reader.join(timeout=30)
    out = "".join(lines)
    check(rc == 0, f"train CLI exit {rc}: {out[-4000:]}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return records, time.time() - t0, out


def cli_launches_ok(rec, evals_before):
    """Each step's window: K1 194, K2 98, K3 48 and K6 48 (24 layers, two
    micro-batches, selective recompute re-running each layer's two K1),
    plus the forwards of an eval that ran just before it (49 K1 and 24 K3
    per eval batch), every K3/K6 on the tensor-core route (bf16); no plain
    version."""
    k = rec["kernels"]
    want = {"fused_ln_fwd": 2 * (4 * N_LAYERS + 1) + evals_before * (2 * N_LAYERS + 1),
            "fused_ln_bwd": 2 * (2 * N_LAYERS + 1),
            "flash_fwd": 2 * N_LAYERS + evals_before * N_LAYERS,
            "flash_bwd_fused": 2 * N_LAYERS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_sm90": 2 * N_LAYERS + evals_before * N_LAYERS,
            "flash_bwd_dq_sm90": 0, "flash_bwd_dkv_sm90": 0,
            "flash_bwd_fused_sm90": 2 * N_LAYERS,
            "flash_plain": 0, "fused_ln_fwd_plain": 0, "fused_ln_bwd_plain": 0}
    return k == want, want


def phase_train_cli(env):
    import shutil
    import tempfile

    import numpy as np

    from paddlefleetx_tpu_torch.data.gpt_dataset import write_synthetic_corpus

    tmp = tempfile.mkdtemp(prefix="smoke_train_")
    try:
        data_dir, out_dir = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        t0 = time.time()
        write_synthetic_corpus(os.path.join(data_dir, "corpus"), vocab_size=50304,
                               num_docs=2000, mean_len=600, seed=0)
        log(f"  corpus written in {time.time() - t0:.1f}s")
        first, wall, out = train_cli(env, data_dir, out_dir)
        check([r["step"] for r in first] == list(range(1, CLI_STEPS + 1)),
              f"train CLI records: {[r.get('step') for r in first]}")
        for r in first:
            evals = CLI_EVAL_ITERS if r["step"] > 1 and (r["step"] - 1) % CLI_EVAL_FREQ == 0 else 0
            ok, want = cli_launches_ok(r, evals)
            check(ok, f"step {r['step']} launches {r['kernels']}, expected {want}")
            check(r["consumed_samples"] == TRAIN_GLOBAL * r["step"], f"record {r}")
            check(all(k in r for k in ("tokens_per_sec", "mfu", "mem")), f"record keys {r}")
        losses = [r["loss"] for r in first]
        check(all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3]),
              f"train CLI loss did not fall: {losses}")
        check("eval loss" in out, "no eval in the train CLI run")
        for step in (CLI_SAVE, CLI_STEPS):
            meta_path = os.path.join(out_dir, f"step_{step}", "meta.json")
            with open(meta_path) as f:
                meta = json.load(f)
            check(meta["step"] == step and meta["consumed_samples"] == TRAIN_GLOBAL * step,
                  f"{meta_path}: {meta}")
        steady = first[1:]
        tps = sorted(r["tokens_per_sec"] for r in steady)[len(steady) // 2]
        step_s = sorted(r["step_s"] for r in steady)[len(steady) // 2]
        mfu = sorted(r["mfu"] for r in steady)[len(steady) // 2]
        peak = max(r["mem"]["device_peak_bytes"] for r in first)
        launches = {k: sum(r["kernels"][k] for r in first)
                    for k in ("fused_ln_fwd", "fused_ln_bwd", "flash_fwd", "flash_bwd_fused",
                              "flash_fwd_sm90", "flash_bwd_fused_sm90")}
        log(f"  train CLI: {CLI_STEPS} steps in {wall:.1f}s wall (first step "
            f"{first[0]['compile_s']:.1f}s), loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"median step {step_s * 1e3:.1f} ms, {tps:.0f} tokens/s, mfu {mfu:.4f}, peak "
            f"{peak / 2**30:.2f} GiB, launches {launches}")
        # resume: the final step_12 out of the way, auto_resume picks step_9
        shutil.rmtree(os.path.join(out_dir, f"step_{CLI_STEPS}"))
        os.rename(os.path.join(out_dir, "metrics.jsonl"), os.path.join(tmp, "first.jsonl"))
        second, wall2, out2 = train_cli(env, data_dir, out_dir,
                                        ["Engine.save_load.auto_resume=True"])
        check(f"loaded checkpoint: {os.path.join(out_dir, f'step_{CLI_SAVE}')}" in out2,
              f"resume did not load step_{CLI_SAVE}: {out2[-3000:]}")
        check([r["step"] for r in second] == list(range(CLI_SAVE + 1, CLI_STEPS + 1)),
              f"resumed records: {[r.get('step') for r in second]}")
        diffs = []
        for a, b in zip(first[CLI_SAVE:], second):
            check(a["consumed_samples"] == b["consumed_samples"]
                  and a["tokens_digest"] == b["tokens_digest"],
                  f"step {b['step']}: resumed batch differs: {a} vs {b}")
            ok, want = cli_launches_ok(b, 0)
            check(ok, f"resumed step {b['step']} launches {b['kernels']}, expected {want}")
            diffs.append(abs(a["loss"] - b["loss"]) / abs(a["loss"]))
        check(max(diffs) <= RESUME_LOSS_TOL,
              f"resumed losses differ by {diffs} (relative) > {RESUME_LOSS_TOL}")
        log(f"  train CLI resume from step_{CLI_SAVE}: {len(second)} steps in {wall2:.1f}s "
            f"wall, same batches, losses within {max(diffs):.2e} relative "
            f"({[f'{d:.1e}' for d in diffs]})")
        log("train_cli " + json.dumps({
            "first": first, "resumed": second, "wall_s": wall, "resume_wall_s": wall2,
            "median_tokens_per_sec": tps, "median_step_s": step_s, "median_mfu": mfu,
            "peak_bytes": peak, "resume_loss_rel_diff": diffs}))
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 15: K7, K8 and K9 at the speculative verify chunk, t = draft_k + 1
# ---------------------------------------------------------------------------


def verify_shape(t):
    """Request D's verify chunk in phase 16's coalescing run halfway
    through: batch 8 in the 64-token bucket, the cache 64 + 32 + 16 slots
    (up to draft_k 16 of slack), the chunk at [80, 80 + t)."""
    return (8, 16, t, 64, 64 + MAX_NEW + 16, 64 + MAX_NEW // 2 + t, [64 - n for n in D_LENS])


def phase_verify(torch, F, da):
    """K7 / K8 at :func:`verify_shape` and K9 at phase 7's rows halfway
    (:func:`paged_main_positions`), at t = 5 (draft_k 4, served in phase
    16), 8, 16 and 17 (the first t past the split-K kernels), against
    their plain versions with CUDA-event times, SDPA's (bf16) and the
    bound; then the stale tail a rewind leaves: NaN past every query's
    causal bound (in the cache past pos + t; in each row's last block and
    its reserved slack blocks) leaves the output unchanged at t = 5."""
    rows = {}
    for name, kind in (("flash_decode", "bfloat16"), ("flash_decode_q8", "int8")):
        rows[name] = []
        for t in VERIFY_TS:
            rows[name].append(kernel_case(torch, F, da, kind, *verify_shape(t), iters=50))
            log_case(rows[name][-1])
    for name, kind in (("paged_decode", "bfloat16"), ("paged_decode_q8", "int8")):
        rows[name] = []
        for t in VERIFY_TS:
            rows[name].append(paged_case(torch, F, da, kind, t, paged_main_positions(), iters=50))
            log_paged(f"{name} verify", rows[name][-1])
    # the int8 kernels' yardstick: the bf16 kernel at the same shape
    for q8, bf16 in (("flash_decode_q8", "flash_decode"), ("paged_decode_q8", "paged_decode")):
        for row, ref in zip(rows[q8], rows[bf16]):
            row["bf16_ms"] = ref["ms"]
    t = SPEC_K + 1
    decode_poison(torch, da, shapes=(verify_shape(t),))
    paged_poison(torch, da, positions=paged_main_positions(), ts=(t,),
                 kinds=("bfloat16", "int8"), slack=SPEC_K)
    log("verify_cases " + json.dumps(rows))
    return rows


# ---------------------------------------------------------------------------
# phase 16: speculative serving at full width
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0**-126))) - 7)


def greedy_deficits(torch, G, model, cfg, prompt, answer, kv_dtype):
    """Teacher-force ``prompt + answer`` through the cached forward on the
    card (one prefill, a cache of ``kv_dtype``): for each answer token,
    how far its logit sits under the largest, in bf16 ulps of the largest.
    0 where the token is the argmax."""
    ids = torch.tensor([prompt + answer], device="cuda")
    with torch.inference_mode():
        cache = G.init_cache(cfg, 1, ids.shape[1], torch.device("cuda"),
                             kv_dtype=kv_dtype or "bf16")
        lg = G.forward_cached(model, ids, cache, 0)[0].float()
    lg = lg[len(prompt) - 1: len(prompt) - 1 + len(answer)]
    top = lg.max(dim=-1).values
    chosen = lg.gather(-1, torch.tensor(answer, device="cuda")[:, None])[:, 0]
    return [(a - c) / bf16_ulp(a) for a, c in zip(top.tolist(), chosen.tolist())]


def phase_spec_check(torch, plain, spec):
    """Speculative answers against the plain ones, on the card in bf16: a
    verify chunk's GEMMs and attention run at t = k + 1 where the plain
    step runs at t = 1, so the logits differ by rounding, and where a
    row's top two logits sit within a few bf16 ulps the argmax can flip.
    Each row is identical up to its first difference; every answer token,
    plain or speculative, must be the argmax of the model under teacher
    forcing of its own prefix up to SPEC_ULPS ulps (a wrong accept shows
    as a token far below the argmax).  ``plain`` / ``spec``: {(scheduler,
    kv): {request: [answers]}}, requests as in phases 4 and 7."""
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG))
    module = GPTModule(cfg)
    model = module.init_model(cfg.Global.seed, "cuda")
    bc = prompts(2, [30, 40])
    prompts_of = {"A": prompts(1, [20]), "D": prompts(3, D_LENS), "B": bc[:1], "C": bc[1:],
                  "P7": prompts(7, D_LENS)}
    report = {}
    for run, answers in plain.items():
        same = diverged = 0
        worst = 0.0
        firsts = []
        for req, rows in answers.items():
            for i, (a, b) in enumerate(zip(rows, spec[run][req])):
                prompt = prompts_of[req][i]
                for ans in (a, b):
                    d = greedy_deficits(torch, G, model, module.config, prompt, ans, run[1])
                    worst = max([worst] + d)
                if a == b:
                    same += 1
                    continue
                diverged += 1
                j = next((x for x in range(min(len(a), len(b))) if a[x] != b[x]),
                         min(len(a), len(b)))
                firsts.append([req, i, j])
        check(worst <= SPEC_ULPS,
              f"{run}: an answer token sits {worst:.1f} bf16 ulps under the argmax of its "
              f"prefix (> {SPEC_ULPS}): a wrong token, not a rounding tie")
        report[f"{run[0]}_{run[1] or 'bf16'}"] = {
            "rows": same + diverged, "identical": same, "first_differences": firsts,
            "worst_deficit_ulps": worst}
        log(f"  {run[0]} kv={run[1] or 'bf16'}: {same} of {same + diverged} rows identical "
            f"to the plain answers; first differences (request, row, token) {firsts}; every "
            f"token within {worst:.1f} bf16 ulps of its prefix's argmax (gate {SPEC_ULPS})")
    del model
    return report


# ---------------------------------------------------------------------------
# phase 17: K9 at chunk width
# ---------------------------------------------------------------------------


def phase_chunk_kernel(torch, F, da):
    """K9 at :data:`CHUNK_CASES` through the wrapper the engine calls,
    against its plain version with CUDA-event times, SDPA's over the
    gathered keys (bf16) and the bound; a launch wider than
    SPLIT_MAX_ROWS counts in ``*_chunk``; NaN in the null block, a spare
    block and past the last query's bound leaves the output unchanged, and
    a repeat call gives the same bits."""
    rows = {}
    for name, kind in (("paged_decode", "bfloat16"), ("paged_decode_q8", "int8")):
        rows[name] = []
        for t, pos in CHUNK_CASES:
            before = dict(da.COUNTS)
            row = paged_case(torch, F, da, kind, t, [pos], iters=50)
            launched = da.COUNTS[name] - before[name]
            chunked = da.COUNTS[f"{name}_chunk"] - before[f"{name}_chunk"]
            check(launched > 0 and chunked == launched * (t > da.SPLIT_MAX_ROWS),
                  f"{name} t={t}: {chunked} of {launched} launches counted as chunks")
            row["pos"] = pos
            rows[name].append(row)
            log_paged(f"{name} chunk at slot {pos}", row)
            paged_poison(torch, da, positions=[pos], ts=(t,), kinds=(kind,))
    for row, ref in zip(rows["paged_decode_q8"], rows["paged_decode"]):
        row["bf16_ms"] = ref["ms"]
    log("chunk_cases " + json.dumps(rows))
    return rows


# ---------------------------------------------------------------------------
# phase 18: chunked prefill and prefix reuse served at full width
# ---------------------------------------------------------------------------


def prefix_prompts():
    """Phase 18-19's prompts: the families' requests in PFX_FAMILIES order
    (each a PFX_LEN-token family prefix and its own suffix) and the
    LONG_PROMPT-token prompt."""
    pa, pb = prompts(17, [PFX_LEN, PFX_LEN])
    sfx = prompts(18, PFX_SUFFIXES)
    seq = [(pa if f == "A" else pb) + s for f, s in zip(PFX_FAMILIES, sfx)]
    return seq, prompts(19, [LONG_PROMPT])[0]


def serve_prefix(kv_dtype, env):
    """Phase 18: the families one request at a time, the long prompt sent
    while the seventh request decodes.  Returns (the traffic's kernel
    counts, the run's numbers, answers and prompts)."""
    port = free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), "--scheduler", "continuous", "--cb-batch", "8",
           "--prefill-chunk", str(PFX_CHUNK), "--prefix-cache-blocks", str(PFX_BLOCKS),
           "--prefix-spill-bytes", str(PFX_SPILL),
           "-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}"]
    if kv_dtype:
        cmd += ["--kv-dtype", kv_dtype]
    seq, long_ = prefix_prompts()
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out_lines = []
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()

    def ask(p, out, i):
        try:
            out[i] = http(port, "/generate", {"prompt_ids": p, "max_tokens": MAX_NEW})
        except Exception as e:  # noqa: BLE001 — reported below
            out[i] = e

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
        serving0 = health["serving"]
        results = {}
        t1 = time.time()
        for i in range(6):
            ask(seq[i], results, i)
        # the long prompt arrives once the seventh request decodes
        steps_at = http(port, "/healthz", timeout=30)["serving"]["steps"]
        th = threading.Thread(target=ask, args=(seq[6], results, 6))
        th.start()
        while http(port, "/healthz", timeout=30)["serving"]["steps"] < steps_at + 2:
            check(time.time() - t1 < 300, "the seventh request never stepped")
            time.sleep(0.005)
        window0 = http(port, "/healthz", timeout=30)["serving"]
        ask(long_, results, "long")
        th.join(timeout=600)
        window1 = http(port, "/healthz", timeout=30)["serving"]
        ask(seq[7], results, 7)
        wall = time.time() - t1
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
    names = list(range(len(seq))) + ["long"]
    for i in names:
        check(isinstance(results.get(i), dict), f"request {i}: {results.get(i)}")
        check_rows([results[i]["completion_ids"]], f"request {i}")
    kernels, serving = health["kernels"], health["serving"]

    def delta(a, b, *path):
        for k in path:
            a, b = a[k], b[k]
        return b - a

    hits = delta(serving0, serving, "prefix", "hits")
    spills = delta(serving0, serving, "spill", "spills")
    readmits = delta(serving0, serving, "spill", "readmits")
    chunks = delta(serving0, serving, "prefill_chunks")
    steps = delta(serving0, serving, "steps")
    computed = delta(serving0, serving, "prefill_tokens")
    sent = sum(len(p) for p in seq) + len(long_)
    check(hits > 0 and spills >= 1 and readmits >= 1 and chunks > 0,
          f"no reuse: hits {hits} spills {spills} readmits {readmits} chunks {chunks}: {serving}")
    check(computed < sent, f"{computed} prompt tokens computed of {sent} sent: no reuse")
    long_chunks = -(-LONG_PROMPT // PFX_CHUNK)
    beside = delta(window0, window1, "interleaved_chunks")
    check(beside >= long_chunks - 1 and delta(window0, window1, "steps") >= long_chunks,
          f"the long prompt's chunks did not run beside decode steps: {beside} of "
          f"{long_chunks - 1} interleaved, window {window0} -> {window1}")
    key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
    check(kernels["paged_plain"] == 0 and kernels["plain"] == 0,
          f"plain version ran on the card: {kernels}")
    check(kernels["flash_decode"] == 0 and kernels["flash_decode_q8"] == 0,
          f"a monolithic prefill ran beside --prefill-chunk: {kernels}")
    check(kernels[f"{key}_chunk"] == N_LAYERS * chunks and kernels[key] == N_LAYERS * (steps + chunks),
          f"{key}: {kernels[key]} launches ({kernels[f'{key}_chunk']} chunk) for {steps} steps "
          f"and {chunks} chunks")
    check(kernels[f"{key}_sm90"] == kernels[key] - kernels[f"{key}_chunk"],
          f"{key}: a t = 1 launch off the sm90 route or a chunk on it: {kernels}")
    info = {"boot_s": boot_s, "traffic_s": wall, "hits": hits,
            "hit_tokens": delta(serving0, serving, "prefix", "hit_tokens"),
            "misses": delta(serving0, serving, "prefix", "misses"),
            "evictions": delta(serving0, serving, "prefix", "evictions"), "spills": spills,
            "readmits": readmits, "spill_discards": delta(serving0, serving, "spill", "discards"),
            "prefill_chunks": chunks, "prefill_tokens": computed, "prompt_tokens": sent,
            "steps": steps, "long_interleaved_chunks": beside,
            "prefix_cached_blocks": serving["prefix_cached_blocks"],
            "prefix_spill_bytes": serving["prefix_spill_bytes"],
            "answers": [results[i]["completion_ids"] for i in names],
            "prompts": seq + [long_]}
    log(f"  prefix kv={kv_dtype or 'bf16'}: boot {boot_s:.1f}s, {len(names)} requests in "
        f"{wall:.2f}s; {hits} hits ({info['hit_tokens']} tokens), {spills} spills, {readmits} "
        f"readmits, {chunks} chunks, {computed} of {sent} prompt tokens computed, {steps} "
        f"steps, the long prompt's chunks beside decode {beside}; kernels {kernels}")
    return kernels, info


def phase_prefix_check(torch, runs):
    """Every answered token of phase 18's runs within SPEC_ULPS bf16 ulps
    of its prefix's argmax under teacher forcing with the plain model
    (the contiguous cached forward on the card, a cache of the run's KV
    dtype): the chunk path rounds differently from the monolithic one."""
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG))
    module = GPTModule(cfg)
    model = module.init_model(cfg.Global.seed, "cuda")
    for kv, info in runs.items():
        worst = 0.0
        for prompt, answer in zip(info["prompts"], info["answers"]):
            worst = max([worst] + greedy_deficits(torch, G, model, module.config, prompt,
                                                  answer, kv))
        check(worst <= SPEC_ULPS, f"prefix kv={kv or 'bf16'}: an answer token sits {worst:.1f} "
                                  f"bf16 ulps under the argmax of its prefix (> {SPEC_ULPS})")
        info["worst_deficit_ulps"] = worst
        log(f"  prefix kv={kv or 'bf16'}: every token within {worst:.2f} bf16 ulps of its "
            f"prefix's argmax (gate {SPEC_ULPS})")
    del model


# ---------------------------------------------------------------------------
# phase 19: the prefix and chunk paths, card against CPU, float32
# ---------------------------------------------------------------------------


def prefix_engine_run(torch, da, server, flags, family, long_):
    """Families A, A, B, A one at a time (each prompt's prefill driven to
    its end first, for its first-step logits), then the long prompt
    admitted while the last decodes: with ``flags`` its chunks run one a
    step, each beside the decoding row's next token."""
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine

    eng = PagedDecodeEngine(server, max_batch=4, block=KV_BLOCK, **flags)
    before = dict(da.COUNTS)
    firsts, answers = [], []
    for i, p in enumerate(family):
        slot = eng.admit(p, MAX_NEW)
        with torch.inference_mode():
            while not eng.slots[slot].prefill_done:
                eng._tick_prefill(slot)
        firsts.append(eng._logits[slot].float().cpu())
        if i == len(family) - 1:
            eng.step()
            eng.step()
            lslot = eng.admit(long_, MAX_NEW)
            long_row = eng.slots[lslot]
            while not long_row.prefill_done:
                pos, at = int(eng.positions[slot]), long_row.prefill_pos
                decoding = bool(eng.active[slot])
                eng.step()
                check(long_row.prefill_pos - at == min(PFX_CHUNK, LONG_PROMPT - at)
                      and int(eng.positions[slot]) == pos + decoding,
                      f"step did not run one chunk beside one decode token: prefill "
                      f"{at} -> {long_row.prefill_pos}, row {pos} -> {eng.positions[slot]}")
        while eng.active.any():
            eng.step()
        answers.append(list(eng.slots[slot].tokens))
        eng.release(slot)
    answers.append(list(eng.slots[lslot].tokens))
    eng.release(lslot)
    used = {k: da.COUNTS[k] - before[k] for k in da.COUNTS}
    acct = {"prefix": dict(eng.cache.prefix.stats), "spill": dict(eng.cache.spill.stats),
            "prefill_tokens": eng.stats["prefill_tokens"],
            "prefill_chunks": eng.stats["prefill_chunks"]}
    return firsts, answers, acct, used


def phase_prefix_card_vs_monolithic(torch, kv_dtype, f32_run=None):
    """The chunk and prefix paths in float32 at full width, cut to
    PFX_F32_LAYERS layers, on the card.  Float32 pools: against the card's
    own monolithic uncached run (tokens identical, first-step logits within
    1e-3).  int8 pools (an int8 arena's monolithic prefill attends over the
    prompt's unquantized K/V, the chunk path over the quantized blocks:
    another result): the reuse accounting of ``f32_run``, every chunk on
    the q8 kernel's CUDA-core route; their logits' distance from the
    float32 pools' is recorded, not gated."""
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.ops import decode_attention as da
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG), [
        "Model.dtype=float32", f"Model.num_layers={PFX_F32_LAYERS}",
        "Generation.decode_strategy=greedy_search", f"Generation.max_dec_len={MAX_NEW}"])
    module = GPTModule(cfg)
    check(module.config.hidden_size == 1024 and module.config.num_attention_heads == 16,
          "phase 19 cut a width")
    seq, long_ = prefix_prompts()
    family = [seq[0], seq[1], seq[3], seq[6]]  # A, A (hit), B (A spills), A (readmit)
    flags = {"prefill_chunk": PFX_CHUNK, "prefix_cache_blocks": PFX_BLOCKS,
             "prefix_spill_bytes": PFX_SPILL, "kv_dtype": kv_dtype}
    runs = {}
    plain = () if kv_dtype else (("cuda_plain", {}),)
    server = GenerationServer(cfg, module, module.init_model(cfg.Global.seed, "cuda"),
                              torch.device("cuda"))
    for name, fl in (("cuda", flags),) + plain:
        t0 = time.time()
        runs[name] = prefix_engine_run(torch, da, server, fl, family, long_)
        log(f"  prefix f32 kv={kv_dtype or 'f32'} {name}: {time.time() - t0:.1f}s, "
            f"{runs[name][2]}")
    del server
    key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
    used = runs["cuda"][3]
    check(used[f"{key}_chunk"] > 0 and used["paged_plain"] == 0 and used[f"{key}_sm90"] == 0,
          f"card run did not take the CUDA-core chunk launches of {key}: {used}")
    acct = runs["cuda"][2]
    check(acct["prefix"]["hits"] >= 2 and acct["spill"]["spills"] >= 1
          and acct["spill"]["readmits"] >= 1, f"no hit, spill or readmit: {acct}")
    out = {"accounting": acct, "tokens": [len(r) for r in runs["cuda"][1]]}
    if plain:
        check(runs["cuda"][1] == runs["cuda_plain"][1],
              f"chunk/prefix tokens {runs['cuda'][1]} vs monolithic {runs['cuda_plain'][1]}")
        errs = [(a - b).abs().max().item() for a, b in zip(runs["cuda"][0], runs["cuda_plain"][0])]
        check(max(errs) <= 1e-3, f"first-step logits vs monolithic {errs} (> 1e-3)")
        out.update({"errs_monolithic": errs, "firsts": runs["cuda"][0]})
        log(f"  prefix f32 kv=f32: tokens identical chunk+prefix / monolithic "
            f"({out['tokens']}); first-step logits max |err| {max(errs):.3e}; {acct}")
    else:
        check(f32_run is not None and acct == f32_run["accounting"],
              f"int8 pools' reuse accounting {acct} vs float32 pools' "
              f"{f32_run and f32_run['accounting']}")
        out["errs_vs_f32_pools"] = [(a - b).abs().max().item()
                                    for a, b in zip(runs["cuda"][0], f32_run["firsts"])]
        log(f"  prefix f32 kv=int8: reuse accounting identical to float32 pools'; first-step "
            f"logits max |err| from theirs {max(out['errs_vs_f32_pools']):.3e} (not gated)")
    return out


# ---------------------------------------------------------------------------
# phase 20: multi-tenant serving with a priority preemption at full width
# ---------------------------------------------------------------------------


def post_stream(port, body, headers, timeout=600):
    """POST /generate?stream=1; returns the server-sent events as (event,
    data) pairs (the body is close-delimited)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate?stream=1", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.headers["Content-Type"] == "text/event-stream", f"stream headers {r.headers}")
        text = r.read().decode()
    frames = []
    for block in text.strip().split("\n\n"):
        fields = dict(line.split(": ", 1) for line in block.splitlines())
        frames.append((fields["event"], json.loads(fields["data"])))
    return frames


def stream_answer(frames, what):
    """The answer a one-prompt stream carries: its token frames joined,
    each index where the last ended (across a preemption too), and the
    summary's token count equal to it."""
    toks = []
    for event, data in frames[:-1]:
        check(event == "token" and data["row"] == 0 and data["index"] == len(toks),
              f"{what}: frame {event} {data} after {len(toks)} tokens")
        toks.extend(data["tokens"])
    check(frames[-1][0] == "summary" and frames[-1][1]["usage"]["tokens"] == len(toks),
          f"{what}: last frame {frames[-1]} for {len(toks)} streamed tokens")
    return toks


def metric_rows(port):
    from paddlefleetx_tpu_torch.utils.telemetry import parse_exposition

    req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics")
    with urllib.request.urlopen(req, timeout=30) as r:
        text = r.read().decode()
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in parse_exposition(text)}


def serve_tenants(kv_dtype, env):
    """Phase 20: brz fills the batch, a gold arrival of higher priority
    preempts one brz row, the row resumes as a prefix hit.  Returns (the
    traffic's kernel counts, the run's numbers, answers and prompts)."""
    import tempfile

    port = free_port()
    tdir = tempfile.mkdtemp(prefix="smoke_tenants_")
    tenants = os.path.join(tdir, "tenants.json")
    with open(tenants, "w") as f:
        json.dump(TENANTS, f)
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), "--scheduler", "continuous", "--cb-batch", str(TEN_ROWS),
           "--prefix-cache-blocks", str(TEN_PREFIX_BLOCKS), "--tenants", tenants,
           "--preempt-min-tokens", str(TEN_MIN_TOKENS),
           "-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}"]
    if kv_dtype:
        cmd += ["--kv-dtype", kv_dtype]
    brz = prompts(23, TEN_BRZ_LENS)
    gold = prompts(24, [TEN_GOLD_LEN])[0]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out_lines = []
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    results = {}

    def ask(key, p, n, headers, stream):
        try:
            body = {"prompt_ids": p, "max_tokens": n, "deadline_s": 300}
            if stream:
                results[key] = stream_answer(post_stream(port, body, headers), f"request {key}")
            else:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json", **headers})
                with urllib.request.urlopen(req, timeout=600) as r:
                    results[key] = json.load(r)["completion_ids"]
        except Exception as e:  # noqa: BLE001 — reported below
            results[key] = e

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
        serving0 = health["serving"]
        t1 = time.time()
        threads = []

        def start(*a):
            threads.append(threading.Thread(target=ask, args=a))
            threads[-1].start()

        # brz request 0 (streamed) first, so it takes slot 0; the rest fill
        # the batch
        start("brz0", brz[0], TEN_BRZ_NEW, {"X-Tenant": "brz"}, True)
        while http(port, "/healthz", timeout=30)["serving"]["active_rows"] < 1:
            check(time.time() - t1 < 120, "brz request 0 never admitted")
            time.sleep(0.005)
        for i in range(1, TEN_ROWS):
            start(f"brz{i}", brz[i], TEN_BRZ_NEW, {"X-Tenant": "brz"}, False)
        while True:
            h = http(port, "/healthz", timeout=30)["serving"]
            if h["active_rows"] == TEN_ROWS:
                break
            check(time.time() - t1 < 120, f"the batch never filled: {h}")
            time.sleep(0.005)
        full_at = h["steps"]
        while http(port, "/healthz", timeout=30)["serving"]["steps"] < full_at + TEN_MIN_TOKENS + 2:
            check(time.time() - t1 < 300, "the full batch never stepped")
            time.sleep(0.005)
        start("gold", gold, MAX_NEW, {"X-Tenant": "gold",
                                      "X-Priority": str(TEN_GOLD_PRIORITY)}, True)
        for th in threads:
            th.join(timeout=600)
        wall = time.time() - t1
        health = http(port, "/healthz", timeout=30)
        rows = metric_rows(port)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        check(rc == 0, f"server drain exit {rc}: {''.join(out_lines)[-3000:]}")
        check("drained cleanly" in "".join(out_lines), "no clean-drain line")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        import shutil

        shutil.rmtree(tdir, ignore_errors=True)
    names = [f"brz{i}" for i in range(TEN_ROWS)] + ["gold"]
    for key in names:
        ans = results.get(key)
        check(isinstance(ans, list) and 0 < len(ans) <= (MAX_NEW if key == "gold" else TEN_BRZ_NEW)
              and all(isinstance(x, int) and 0 <= x < 50304 for x in ans),
              f"request {key}: {str(ans)[:300]}")
    kernels, serving, queue, tenants_h = (health["kernels"], health["serving"], health["queue"],
                                          health["tenants"])
    pre = rows.get(("pfx_tenant_preemptions_total", (("tenant", "brz"),)), 0)
    check(queue["preemptions"] >= 1, f"no preemption: {queue}")
    check(queue["preemptions"] == tenants_h["brz"]["preemptions"] == pre
          and not tenants_h.get("gold", {}).get("preemptions"),
          f"preemptions: /healthz {queue['preemptions']} / {tenants_h}, /metrics {pre}")
    check(rows[("pfx_tenant_admitted_total", (("tenant", "gold"),))] == 1
          and rows[("pfx_tenant_admitted_total", (("tenant", "brz"),))]
          == TEN_ROWS + queue["preemptions"],
          f"admissions: {tenants_h}")
    check(rows[("pfx_queue_completed_total", ())] == queue["completed"] == TEN_ROWS + 1,
          f"completed: {queue}")
    hits = serving["prefix"]["hits"] - serving0["prefix"]["hits"]
    check(hits >= queue["preemptions"], f"a resume was not a prefix hit: {serving['prefix']}")
    key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
    steps = serving["steps"] - serving0["steps"]
    chunks = serving["prefill_chunks"] - serving0["prefill_chunks"]
    check(kernels["paged_plain"] == 0 and kernels["plain"] == 0,
          f"plain version ran on the card: {kernels}")
    check(kernels[key] == N_LAYERS * (steps + chunks),
          f"{key}: {kernels[key]} launches for {steps} steps and {chunks} chunks")
    # a resume's suffix chunk takes the sm90 route at t <= 16, the CUDA-core
    # one above; every decode step the sm90 route
    check(kernels[f"{key}_sm90"] + kernels[f"{key}_chunk"] == kernels[key]
          and kernels[f"{key}_sm90"] >= N_LAYERS * steps,
          f"{key}: routes {kernels}")
    info = {"boot_s": boot_s, "traffic_s": wall, "preemptions": queue["preemptions"],
            "prefix_hits": hits, "steps": steps, "resume_chunks": chunks,
            "tenants": tenants_h, "ttft_p50_s": health["ttft_p50_s"],
            "ttft_p99_s": health["ttft_p99_s"],
            "gold_ttft_count": rows.get(("pfx_tenant_ttft_seconds_count",
                                         (("tenant", "gold"),))),
            "answers": [results[k] for k in names], "prompts": brz + [gold]}
    log(f"  tenants kv={kv_dtype or 'bf16'}: boot {boot_s:.1f}s, {len(names)} requests in "
        f"{wall:.2f}s; {queue['preemptions']} preemption(s), {hits} prefix hit(s), {chunks} "
        f"resume chunk(s), {steps} steps; tenants {tenants_h}; kernels {kernels}")
    return kernels, info


def phase_storm_f32(torch):
    """PFX_FAULT=preempt_storm on the card in float32, PFX_F32_LAYERS
    layers at full width, the prefix cache on: four rows, one forced
    preemption at iteration STORM_ITER; every answer (the victim's too)
    equals the undisturbed run's, and the victim's stream offsets stay
    contiguous across the resume."""
    from paddlefleetx_tpu_torch.core.continuous_batching import (
        ContinuousScheduler,
        PagedDecodeEngine,
    )
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.ops import decode_attention as da
    from paddlefleetx_tpu_torch.utils import resilience
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG), [
        "Model.dtype=float32", f"Model.num_layers={PFX_F32_LAYERS}",
        "Generation.decode_strategy=greedy_search", f"Generation.max_dec_len={MAX_NEW}"])
    module = GPTModule(cfg)
    server = GenerationServer(cfg, module, module.init_model(cfg.Global.seed, "cuda"),
                              torch.device("cuda"))
    ps = prompts(25, [40, 150, 70, 130])
    runs = {}
    for storm in (False, True):
        eng = PagedDecodeEngine(server, max_batch=4, block=KV_BLOCK, prefix_cache_blocks=64)
        sched = ContinuousScheduler(eng, max_depth=8, preempt_min_tokens=4)
        victims = []
        inner = sched._preempt_slot
        sched._preempt_slot = lambda slot: (victims.append(slot), inner(slot))[1]
        streams = {i: [] for i in range(len(ps))}
        resilience.reset_fault_state()
        if storm:
            os.environ["PFX_FAULT"] = f"preempt_storm:{STORM_ITER}"
        before = dict(da.COUNTS)
        try:
            futs = [sched.submit([p], STORM_NEW, deadline_s=600,
                                 stream=(lambda i: lambda r, s, t: streams[i].append((s, t)))(i))
                    for i, p in enumerate(ps)]
            for _ in range(1000):
                if all(f.done() for f in futs):
                    break
                sched._iterate()
        finally:
            os.environ.pop("PFX_FAULT", None)
            resilience.reset_fault_state()
        answers = [f.result(timeout=1)[0] for f in futs]
        for i, pushes in streams.items():
            acc = []
            for start, toks in pushes:
                check(start == len(acc), f"storm={storm} row {i}: stream hole at {start}")
                acc.extend(toks)
            check(acc == answers[i], f"storm={storm} row {i}: stream {acc} vs {answers[i]}")
        runs[storm] = {"answers": answers, "victims": victims,
                       "preemptions": int(sched.stats["preemptions"]),
                       "prefix_hits": eng.cache.prefix.stats["hits"],
                       "launches": {k: da.COUNTS[k] - before[k] for k in da.COUNTS
                                    if da.COUNTS[k] != before[k]}}
    calm, storm = runs[False], runs[True]
    check(storm["preemptions"] == 1 and calm["preemptions"] == 0,
          f"preemptions {calm['preemptions']} / {storm['preemptions']}")
    check(storm["prefix_hits"] > calm["prefix_hits"], f"the resume was no prefix hit: {runs}")
    check(storm["answers"] == calm["answers"],
          f"preempt_storm tokens {storm['answers']} vs undisturbed {calm['answers']}")
    used = storm["launches"]
    check(used.get("paged_decode", 0) > 0 and not used.get("paged_plain")
          and not used.get("plain"), f"storm run launches {used}")
    log(f"  preempt_storm f32: victim slot {storm['victims']}, tokens identical to the "
        f"undisturbed run ({[len(a) for a in storm['answers']]}); launches {used}")
    del server
    return {k: {kk: vv for kk, vv in v.items() if kk != "answers"} for k, v in
            (("undisturbed", calm), ("storm", storm))}


def phase_tenant_check(torch, runs):
    """Every answer of phase 20's runs, the resumed row's included, within
    SPEC_ULPS bf16 ulps of its prefix's argmax under teacher forcing."""
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG))
    module = GPTModule(cfg)
    model = module.init_model(cfg.Global.seed, "cuda")
    for kv, info in runs.items():
        worst = 0.0
        for prompt, answer in zip(info["prompts"], info["answers"]):
            worst = max([worst] + greedy_deficits(torch, G, model, module.config, prompt,
                                                  answer, kv))
        check(worst <= SPEC_ULPS, f"tenants kv={kv or 'bf16'}: an answer token sits "
                                  f"{worst:.1f} bf16 ulps under its prefix's argmax")
        info["worst_deficit_ulps"] = worst
        log(f"  tenants kv={kv or 'bf16'}: every token within {worst:.2f} bf16 ulps of its "
            f"prefix's argmax (gate {SPEC_ULPS})")
    del model


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
    from paddlefleetx_tpu_torch.ops import flash_attention as fa
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    log(f"card: {card}")
    begin("1-2", "toolchain and build")
    phase_toolchain(torch, _build)
    begin("3", "kernels against their plain version")
    main_rows = phase_kernels(torch, F, da)
    begin("4", "serve GPT-345M at full width")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    counts_bf16, ans_bf16, bc, info_bf16 = serve_once("", env)
    counts_q8, ans_q8, _, info_q8 = serve_once("int8", env)
    begin("5", "card against cpu, float32, full width")
    phase_card_vs_cpu(torch, bc)
    begin("6", "paged kernel against its plain version")
    paged_rows = phase_paged(torch, F, da)
    begin("7", "continuous serving of GPT-345M at full width")
    cb_bf16, wall_bf16 = serve_continuous("", env)
    cb_q8, wall_q8 = serve_continuous("int8", env)
    log("continuous_wall " + json.dumps({"bf16": wall_bf16, "int8": wall_q8}))
    begin("8", "paged engine, card against cpu, float32, full width")
    phase_paged_card_vs_cpu(torch, bc, "")
    phase_paged_card_vs_cpu(torch, bc, "int8")
    begin("9", "flash attention kernels against their plain versions")
    flash_rows = phase_flash(torch, F, fa)
    begin("10", "GPT-345M pretraining steps at full width")
    train = phase_train(torch, fa, fl)
    begin("11", "training step, card against cpu, float32")
    phase_train_card_vs_cpu(torch, fa)
    begin("12", "fused LayerNorm kernels against their plain versions")
    ln_rows = phase_layernorm(torch, F, fl)
    begin("13", "the train CLI, GPT-345M at full width, and its resume")
    cli = phase_train_cli(env)
    begin("14", "training step, card against cpu, float32, use_fused_ln")
    phase_train_card_vs_cpu(torch, fa, fused_ln=True)
    begin("15", f"K7, K8 and K9 at the verify chunk, t = {VERIFY_TS}")
    verify_rows = phase_verify(torch, F, da)
    begin("16", f"speculative serving of GPT-345M at full width, --draft-k {SPEC_K}")
    plain_runs = {("coalesce", ""): (counts_bf16, ans_bf16, info_bf16),
                  ("coalesce", "int8"): (counts_q8, ans_q8, info_q8),
                  ("continuous", ""): (cb_bf16, wall_bf16["answers"], wall_bf16),
                  ("continuous", "int8"): (cb_q8, wall_q8["answers"], wall_q8)}
    spec_runs = {}
    for kv in ("", "int8"):
        counts, answers, _, info = serve_once(kv, env, draft_k=SPEC_K)
        spec_runs[("coalesce", kv)] = (counts, answers, info)
    for kv in ("", "int8"):
        counts, info = serve_continuous(kv, env, draft_k=SPEC_K)
        spec_runs[("continuous", kv)] = (counts, info["answers"], info)
    spec_report = phase_spec_check(torch, {r: v[1] for r, v in plain_runs.items()},
                                   {r: v[1] for r, v in spec_runs.items()})
    for run in plain_runs:
        p_info, s_info = plain_runs[run][2], spec_runs[run][2]
        spec_report[f"{run[0]}_{run[1] or 'bf16'}"].update({
            "tokens_per_s": s_info["tokens_per_s"], "plain_tokens_per_s": p_info["tokens_per_s"],
            "accept_rate": s_info["accept_rate"], "spec_proposed": s_info["spec_proposed"],
            "spec_accepted": s_info["spec_accepted"]})
        log(f"  {run[0]} kv={run[1] or 'bf16'}: {s_info['tokens_per_s']:.1f} tokens/s with "
            f"--draft-k {SPEC_K} (accept rate {s_info['accept_rate']}), "
            f"{p_info['tokens_per_s']:.1f} without")
    log("spec_serving " + json.dumps(spec_report))
    begin("17", f"K9 at chunk width, t and slot {CHUNK_CASES}")
    chunk_rows = phase_chunk_kernel(torch, F, da)
    begin("18", f"chunked prefill and prefix reuse served at full width, --prefill-chunk "
          f"{PFX_CHUNK} --prefix-cache-blocks {PFX_BLOCKS} --prefix-spill-bytes {PFX_SPILL}")
    pfx_runs = {kv: serve_prefix(kv, env) for kv in ("", "int8")}
    phase_prefix_check(torch, {kv: run[1] for kv, run in pfx_runs.items()})
    log("prefix_serving " + json.dumps({kv or "bf16": {k: v for k, v in run[1].items()
                                                       if k not in ("answers", "prompts")}
                                        for kv, run in pfx_runs.items()}))
    begin("19", f"chunk and prefix paths against the monolithic run, float32, "
          f"{PFX_F32_LAYERS} layers at full width")
    pfx_f32 = {"f32": phase_prefix_card_vs_monolithic(torch, "")}
    pfx_f32["int8"] = phase_prefix_card_vs_monolithic(torch, "int8", pfx_f32["f32"])
    pfx_f32["f32"].pop("firsts")
    log("prefix_card_vs_monolithic " + json.dumps(pfx_f32))
    begin("20", f"multi-tenant serving at full width: brz fills {TEN_ROWS} rows, a gold "
          f"arrival at priority {TEN_GOLD_PRIORITY} preempts one; preempt_storm in float32")
    ten_runs = {kv: serve_tenants(kv, env) for kv in ("", "int8")}
    phase_tenant_check(torch, {kv: run[1] for kv, run in ten_runs.items()})
    log("tenant_serving " + json.dumps({kv or "bf16": {k: v for k, v in run[1].items()
                                                       if k not in ("answers", "prompts")}
                                        for kv, run in ten_runs.items()}))
    storm = phase_storm_f32(torch)
    log("preempt_storm_f32 " + json.dumps(storm))
    begin(None)
    launches = {"flash_decode": counts_bf16["flash_decode"],
                "flash_decode_q8": counts_q8["flash_decode_q8"],
                "paged_decode": cb_bf16["paged_decode"],
                "paged_decode_q8": cb_q8["paged_decode_q8"],
                # phase 16's multi-query launches (the verify chunks)
                "verify": {"flash_decode": spec_runs[("coalesce", "")][0]["flash_decode_multi"],
                           "flash_decode_q8":
                               spec_runs[("coalesce", "int8")][0]["flash_decode_q8_multi"],
                           "paged_decode": spec_runs[("continuous", "")][0]["paged_decode_multi"],
                           "paged_decode_q8":
                               spec_runs[("continuous", "int8")][0]["paged_decode_q8_multi"]},
                "flash_fwd": train["split"]["launches"]["flash_fwd"],
                "flash_bwd_dq": train["split"]["launches"]["flash_bwd_dq"],
                "flash_bwd_dkv": train["split"]["launches"]["flash_bwd_dkv"],
                "flash_bwd_fused": train["fused"]["launches"]["flash_bwd_fused"],
                "fused_ln_fwd": cli["fused_ln_fwd"], "fused_ln_bwd": cli["fused_ln_bwd"]}
    kernels = []
    for name, row in {**main_rows, **paged_rows, **flash_rows, **ln_rows}.items():
        if name.startswith("fused_ln"):
            shape = {"rows": row["rows"], "n": row["n"], "dtype": row["kind"],
                     "residual": row["residual"]}
        elif name.startswith("flash_") and "s" in row:
            shape = {"b": row["b"], "n": row["n"], "s": row["s"], "d": row["d"],
                     "dtype": row["kind"]}
        elif name.startswith("paged"):
            shape = {"b": row["b"], "n": 16, "t": row["t"], "d": 64, "bs": row["bs"],
                     "positions": row["positions"], "dtype": row["kind"]}
        else:
            shape = {"b": row["b"], "n": row["n"], "t": row["t"], "d": row["d"],
                     "L": row["L"], "limit": row["limit"], "dtype": row["kind"]}
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape,
        }
        if name in ("flash_decode", "flash_decode_q8"):
            # the same entry's prefill regime, request D's shape
            pre = row["prefill"]
            counts = counts_bf16 if name == "flash_decode" else counts_q8
            entry["kernel_route"] = row["route"]
            entry["prefill"] = {
                "launches": counts[f"{name}_sm90_prefill"], "max_abs_err": pre["max_abs_err"],
                "ms": pre["ms"], "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
                "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
                "shape": {"b": pre["b"], "n": pre["n"], "t": pre["t"], "d": pre["d"],
                          "L": pre["L"], "limit": pre["limit"], "dtype": pre["kind"]}}
            if name == "flash_decode_q8":
                entry["bf16_k7_ms"] = row["bf16_k7_ms"]
                entry["prefill"]["bf16_k7_ms"] = pre["bf16_k7_ms"]
                # the CUDA-core route (f32 q, other head dims): not on the bf16
                # model's path, so its launches there are 0
                cc = row["cuda_core"]
                entry["cuda_core"] = {
                    "source": "paddlefleetx_tpu_torch/csrc/decode_attention.cu",
                    "launches": counts_q8["flash_decode_q8"] - counts_q8["flash_decode_q8_sm90"],
                    "max_abs_err": cc["max_abs_err"], "ms": cc["ms"], "plain_ms": cc["plain_ms"],
                    "bound_ms": cc["bound_ms"], "bound_by": cc["bound_by"], "library_ms": None,
                    "shape": {"b": cc["b"], "n": cc["n"], "t": cc["t"], "d": cc["d"],
                              "L": cc["L"], "limit": cc["limit"], "dtype": "int8",
                              "q": cc["q"]}}
        if name in ("paged_decode", "paged_decode_q8"):
            # launch_ms: the bare launch (ms: through the engine's wrapper);
            # the CUDA-core route (f32 q, other shapes): not on the bf16
            # model's path, so its launches there are 0
            counts = cb_bf16 if name == "paged_decode" else cb_q8
            cc = row["cuda_core"]
            entry["kernel_route"] = row["route"]
            entry["launch_ms"] = row["launch_ms"]
            entry["split_ms"] = row["split_ms"]
            entry["cuda_core"] = {
                "source": "paddlefleetx_tpu_torch/csrc/paged_attention.cu",
                "launches": counts[name] - counts[f"{name}_sm90"],
                "max_abs_err": cc["max_abs_err"], "ms": cc["launch_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": shape}
        if name in verify_rows:
            # the speculative verify chunk: launches in phase 16 (all t = 5),
            # the kernel held and timed in phase 15 at t = 5, 8, 16, 17
            entry["verify"] = {"launches": launches["verify"][name], "rows": [
                {k: r[k] for k in ("t", "route", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms") + (("bf16_ms",) if "bf16_ms" in r
                                                                 else ())}
                for r in verify_rows[name]]}
        if name in chunk_rows:
            # a chunked prefill's chunk or a prefix hit's suffix: launches in
            # phase 18 (t = PFX_CHUNK), the kernel held and timed in phase 17
            # at t = 256 over a 512-token cached prefix (and the other cases)
            head = next(r for r in chunk_rows[name] if (r["t"], r["pos"]) == (256, 512))
            counts = pfx_runs["int8" if name == "paged_decode_q8" else ""][0]
            entry["chunk"] = {
                "launches": counts[f"{name}_chunk"], "route": head["route"],
                "source": "paddlefleetx_tpu_torch/csrc/paged_attention.cu",
                **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "shape": {"b": 1, "n": 16, "t": 256, "d": 64, "bs": KV_BLOCK, "positions": [512],
                          "dtype": head["kind"]},
                "rows": [{k: r[k] for k in ("t", "pos", "route", "max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")
                          + (("bf16_ms",) if "bf16_ms" in r else ())}
                         for r in chunk_rows[name]]}
        if name in ("flash_decode", "paged_decode", "paged_decode_q8"):
            # phase 20: launches in the multi-tenant run (bf16 KV for K7's
            # monolithic prefills; K9 by pool dtype), a preempted row's
            # resume chunk in "chunk" (t > 16) or in "sm90" (t <= 16)
            counts = ten_runs["int8" if name == "paged_decode_q8" else ""][0]
            entry["tenancy"] = {k: counts[k] for k in counts
                                if (k == name or k.startswith(f"{name}_"))
                                and ("_q8" in k) == ("_q8" in name)}
            entry["tenancy"]["preemptions"] = ten_runs[
                "int8" if name == "paged_decode_q8" else ""][1]["preemptions"]
        if name == "fused_ln_fwd":
            entry["kernel_route"] = row["path"]
        kernels.append(entry)
    log("phase_seconds " + json.dumps(PHASE_S))
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
