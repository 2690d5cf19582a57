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
     sums vary from run to run); the resumed run's final ``step_12`` is
     kept for phase 21, the rest deleted;
  14. phase 11 once more with use_fused_ln (K1/K2 on the card against
     their plain versions on the CPU);
  15. K7, K8 and K9 at the speculative verify chunk, t = draft_k + 1 = 5
     (and 8, 16, 17: the last t of the split-K kernels and the first past
     them, K7/K8's tensor-core prefill, K9's tensor-core chunk kernel): K7/K8 at
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
     slot 0 and at slot 512 (over a 512-token cached prefix), t = 128, 64,
     17 and 16 at slot 512, against the plain version (bf16 2e-2, int8
     1e-4), with CUDA-event times of the kernel, the CUDA-core kernel on
     the same inputs, the plain version and SDPA over the gathered keys
     with the causal-offset mask (bf16), and the bound; t > 16 takes the
     sm90 route's tensor-core chunk kernel (csrc/paged_attention_sm90.cu),
     timed at 128, 256, 512 and 1024 keys a split, and counts in
     ``*_chunk`` and ``*_sm90_chunk``; NaN in the null block, a spare
     block and past the last query's bound leaves the output bitwise
     unchanged, and a repeat call gives the same bits;
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
     every K9 launch on the sm90 route, each chunk launch (t = 256) on its
     tensor-core chunk kernel (``*_sm90_chunk``) and none on the CUDA-core
     one, no contiguous prefill and no plain call; every answered token
     within ``SPEC_ULPS`` bf16 ulps of its prefix's argmax under teacher
     forcing; the walls and time to first token are printed;
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
     chunk, all on the sm90 route (the resume's chunk on its chunk kernel),
     with no plain call; streamed frames carry contiguous indices
     across the preemption; every answer token within ``SPEC_ULPS`` bf16
     ulps of its prefix's argmax.  Then ``PFX_FAULT=preempt_storm`` in
     float32 on the card (``PFX_F32_LAYERS`` layers, the prefix cache on):
     the forced preemption's resume gives the undisturbed run's tokens;
  21. a trained and a converted model served with text at full width, with
     a GPT BPE tokenizer built here (the 256 byte symbols, ``TEXT_MERGES``
     merges of a short BPE pass over a seeded text, ``<|endoftext|>`` at
     50256; its C++ merge engine built with g++): (a) phase 13's
     ``step_12`` through ``-o Engine.save_load.ckpt_dir -o
     Generation.tokenizer_dir``, greedy, on both schedulers, text prompts:
     coalescing answers equal ``generate`` run here on the loaded params at
     the same batch shape (8 and 1), continuous answers (streamed, sent
     while others decode) within ``SPEC_ULPS`` bf16 ulps of their prefix's
     argmax; ``decode(encode(prompt)) == prompt``; every SSE frame's
     ``text`` its tokens decoded, joining to the completion; every K7 and
     K9 launch on the sm90 route, no plain call; (b) the same checkpoint
     with ``decode_strategy=beam_search``, ``TEXT_BEAMS`` beams, one request
     of the 8 prompts (32 rows): 24 K7 launches a forward, all sm90, the
     tokens those of ``generate`` here; every step's kept beams and
     finished-pool intake those the plain forward (``attn_impl=xla``, no
     cache) would choose from the same prefixes up to ``SPEC_ULPS`` bf16
     ulps; K7 on step ``BEAM_CAPTURE_STEP``'s captured inputs (the cache
     reordered by parent beam), every layer, against its plain version;
     each beam's length-normalised float32 score (a plain forward on the
     card) no lower than greedy's answer's by more than
     ``BEAM_SCORE_SLACK``; then float32 beam search at ``PFX_F32_LAYERS``
     layers, card against CPU: identical tokens; (c) an HF GPT-2-medium
     directory written from a seed (``model.safetensors`` with the hub's
     bare keys and mask buffers, ``config.json``), converted by
     ``tools/convert_hf_gpt2.py --pad-vocab-to 50304`` and served greedy
     and with beam search: tokens equal ``generate`` here, the beams'
     choices the plain forward's up to ``SPEC_ULPS`` ulps step by step,
     some answers off greedy's, first-step logits card against CPU at
     float32 within 1e-3;
  22. K1-K6 in float16 (the tensor-core route of K3-K6, K1/K2's register
     path) against their plain versions at phase 10's shapes (b*h = 8 x 16,
     s = 1024, d = 64) and 8192 x 1024 LayerNorm rows, bf16's gates with
     float16's ulp (``ROW_SCALE``, ``DIFFER_SCALE``), CUDA-event times beside the bf16
     kernel's, the library's (SDPA and its backward, F.layer_norm in
     float16) and the bound;
  23. the train CLI at 345M in float16 (``F16_CLI``: Model.dtype and
     mix_precision.dtype float16, scale 2**15 growing every 4 finite steps,
     use_fused_ln, the fused backward, ``loader.num_workers=2``,
     ``async_save``) on phase 13's corpus for 12 steps: finite, falling
     losses, the records' loss_scale the scaler's rule on their found_inf,
     every K1/K2/K3/K6 launch as phase 13 counts them and on the sm90
     route, no plain call, each step's tokens_digest phase 13's (the
     worker loader serves the inline loader's batches), the async
     checkpoints' meta with the loss scale, and a resume from step_9 that
     restores it (the resumed run's step_12 is kept for phase 27); then a
     bare float16 step at scale 2**31 with the split
     backward (K4 and K5 in float16): skipped, the scale halved, the params
     bitwise unchanged; and a float16 step at ``F16_CPU_LAYERS`` layers of
     the full width, ``F16_CPU_SEQ`` tokens, card against CPU, loss within
     ``F16_CPU_TOL``;
  24. the memory levers at 345M, ``LEVER_STEPS`` steps each beside the
     default: main_grad=False (bf16 grads), bf16 first moments,
     multi_precision=False (bf16 params and moments), chunked
     cross-entropy (its first loss within ``CHUNKED_CE_TOL`` of the plain
     CE's); peak device memory printed;
  25. ``python -m paddlefleetx_tpu_torch.tools.eval`` with GPTEvalModule
     over phase 13's ``step_12`` and the Eval split of its corpus: the loss
     equals Engine.evaluate here on the same params, ppl and acc printed,
     K3 24 and K1 49 launches a batch on the card's routes, no plain call;
  26. K7, K8 and K9 under float16 q against their plain versions at the
     bf16 rows' shapes (request D's decode step, its prefill and the verify
     chunk at t = 5 and 17 for K7 over float16 caches and K8 over int8
     caches; phase 7's decode step, its verify chunk and a 256-token chunk
     over a 512-token prefix for K9 over float16 and int8 pools), every
     launch on the sm90 route, with CUDA-event times beside the bf16
     kernel's of the same run, SDPA's in float16 (int8: none) and the
     bound; NaN past the limit, in the null block and past each row's
     bound leaves every output bitwise unchanged, a repeat call gives the
     same bits;
  27. phase 23's float16 step_12 served at full width with phase 21's
     tokenizer: the coalescing serve CLI on float16 caches with
     ``--draft-k 4`` (K7: prefill and verify), the continuous serve CLI on
     int8 pools with ``--prefill-chunk``, the prefix cache and its spill
     tier over phase 18's families (K9's split-K and chunk kernels; hits,
     spills, readmits), ``generate`` with an int8 cache (K8) and a
     PagedDecodeEngine on float16 pools with chunked prefill and the prefix
     cache (K9) in-process, and beam search in-process (K7 over the
     reordered float16 cache, replayed step by step under the plain
     forward); every launch on the float16 sm90 routes (``*_f16``), 0
     CUDA-core, 0 plain; every answered token within ``F16_ULPS`` float16
     ulps of its prefix's argmax under the plain forward (``attn_impl=xla``,
     float16; the int8 runs under the cached forward with an int8 cache).
  28. the serving step's dispatch path, in process at full width: phase
     7's traffic through the continuous scheduler over bf16 and int8 pools
     in three modes (CUDA graphs with dispatch-ahead, graphs alone, eager
     and synchronous: ``graphs=False, dispatch_ahead=False``), the table
     widths warmed (and captured) before the traffic; every decode step
     after warmup a graph replay, K9's replayed launches counted (24 a
     step, all sm90, 0 plain); each answer token within ``SPEC_ULPS`` bf16
     ulps of its prefix's argmax; the same three modes in float32 at
     ``PFX_F32_LAYERS`` layers give identical tokens; per mode the median
     step wall (the scheduler's iteration period), the device span of a
     step (CUDA events around its launches or its replay), the host gap
     per gap step, the graphs captured and their seconds, and the device
     memory the warmup keeps reserved (the graph pool: graphs minus eager).
  29. serving observability on the card, GPT-345M at full width, bf16: one
     continuous serve CLI with ``PFX_TRACE_SAMPLE=1``, ``--slo-ttft-p99``,
     a ``PFX_ADMIN_TOKEN`` and ``PFX_FLIGHT_DIR`` in a temporary
     directory serves phase 7's traffic; ``/debug/state`` answers 401
     without the token; ``/debug/state`` (rows, goodput, a decision log),
     a served request's ``/debug/trace?id=`` (its prefill, every decode
     step, the respond stamp) and ``/debug/traces`` (valid nesting per
     lane) read with it; ``/metrics``: the time buckets close within 1% of
     ``pfx_sched_wall_seconds_total`` and the token ledger closes exactly
     with 0 in flight, K9 launched, 0 plain; a 2-second ``/admin/profile``
     under traffic carries device events (its top device ops logged,
     naming K9's kernel or the graph launch); ``/admin/drain`` answers,
     the server exits 0 and its flight dump on disk holds the drain.  In
     process, phase 28's bf16 traffic with graphs and dispatch-ahead at
     ``PFX_TRACE_SAMPLE`` 1 and 0: both median step walls and K9's
     launches logged, and the traced run's decision log replays to the
     scheduler's counters.
  30. disaggregated prefill/decode and the router, GPT-345M at full width.
     In process at ``PFX_F32_LAYERS`` layers: ``FLEET_ENGINE_ROWS`` of phase
     7's prompts exported on one PagedDecodeEngine, packed and unpacked
     through the PFXH1 codec and adopted by a second, whose blocks (and
     int8 scales) must then hold the payload's bytes exactly, float32 and
     bf16 models (bf16 blocks as ``<V2`` words), native and int8 pools; at
     float32 the adopted rows decode the tokens of that engine's own
     ``admit``.  Served, bf16, warmed at the traffic's bucket: a ``--role
     prefill`` replica (``--cb-batch 1``), a ``--role decode`` replica
     (continuous, step graphs, dispatch-ahead), a monolithic continuous
     replica, and an int8 prefill / decode pair, all booted together, with
     the port's ``tools.router`` in front of each pair (``--handoff
     proxy`` and ``direct`` over the bf16 pair, ``direct`` over the int8
     one).  Phase 7's eight prompts through each router at once: every
     answer token within ``SPEC_ULPS`` bf16 ulps of its prefix's argmax
     (int8 under an int8 cache), the count identical to the monolithic
     replica's printed; exports and adoptions one a request; the router's
     ``pfx_router_handoff_bytes_total`` equal to the decode replica's
     proxy bytes under proxy and flat under direct (the replicas count the
     direct bytes); K7 on the prefill replicas (all sm90, no K9), K9 on the
     decode replicas (all sm90, no K7), 0 plain anywhere; SIGTERM drains
     every process with exit 0.  Printed: bytes a request, the routers'
     ``pfx_router_handoff_seconds`` median (interpolated in its buckets),
     the requests' walls and each boot's seconds.
  31. the elastic control plane at full width: the port's ``tools.router
     --supervise`` over a bf16 continuous serve template (``--min-replicas
     1 --max-replicas 2``, every spawn with ``--compile-cache-dir`` = the
     kernel directory phases 1-2 built, so no replica starts ``nvcc``) and
     ``PFX_ADMIN_TOKEN`` set.  ``ELASTIC_FLOOD`` requests of
     ``ELASTIC_NEW`` tokens at once push the average depth past
     ``--scale-high-depth``: the controller spawns ``m1``; the same flood
     again with both serving (tokens/s of each round printed, with
     ``nvidia-smi --query-compute-apps`` while both are up).  A supervised
     prefill / decode pool router boots beside them (``--prefill-cmd`` /
     ``--decode-cmd``, one replica each, ``--handoff direct``).  ``m0`` is
     SIGKILLed under a flood: every response a 200 or 503, none hangs, the
     supervisor restarts it (a new pid) and the router readmits it.  Idle,
     the controller scales down through the token-gated remote drain and
     ``m1`` exits 0.  The decision log (``/debug/controller``) replays to
     the ``pfx_controller_*`` counters.  The router is SIGKILLed and
     restarted on its ports and flight directory: ``/replicas`` keeps its
     pids, ``pfx_router_recoveries_total`` is 1 and no restart is spent.
     Phase 7's eight prompts go through the pools disaggregated.  Every
     replica shows K7 on its sm90 prefill route (monolith and prefill
     replicas) and K9 on sm90 (monolith and decode replicas, none on
     ``p0``), 0 plain; sampled answers sit within ``SPEC_ULPS`` bf16 ulps
     of their prefix's argmax; SIGTERM drains both routers with exit 0 and
     no replica process outlives the phase.  Printed: each spawn's boot
     seconds, the restart's and the re-adoption's.

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
import urllib.error
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = "configs/gpt/pretrain_gpt_345M_single.yaml"
SOURCES = {
    "flash_decode": "paddlefleetx_tpu_torch/csrc/decode_attention_sm90.cu",
    "flash_decode_q8": "paddlefleetx_tpu_torch/csrc/decode_attention_sm90.cu",
    "paged_decode": "paddlefleetx_tpu_torch/csrc/paged_attention_sm90.cu",
    "paged_decode_q8": "paddlefleetx_tpu_torch/csrc/paged_attention_sm90.cu",
    "paged_decode_sm90_chunk": "paddlefleetx_tpu_torch/csrc/paged_attention_sm90.cu",
    "paged_decode_q8_sm90_chunk": "paddlefleetx_tpu_torch/csrc/paged_attention_sm90.cu",
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
    "paged_decode_sm90_chunk": "paddlefleetx_tpu/ops/decode_attention.py:524",
    "paged_decode_q8_sm90_chunk": "paddlefleetx_tpu/ops/decode_attention.py:524",
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
SDPA_TOL = {"float32": 1e-2, "bfloat16": 5e-2, "float16": 1e-2}
# float16 K1-K6 take bfloat16's rules with float16's ulp (2**-10 of a value
# against bf16's 2**-7): the row limits 8x tighter; the share of elements
# that differ 16x wider (a float32 sum of another order straddles one of the
# type's rounding boundaries 8x as often when they lie 8x as close, and p
# and ds, rounded to the type before their products, flip 8x as often too:
# K4 read 13x bf16's share at phase 10's shape)
ROW_SCALE = {"bfloat16": 1.0, "float16": 2.0**-3}
DIFFER_SCALE = {"bfloat16": 1.0, "float16": 16.0}
# phase 10: micro-batch 8 of the global 16 at seq 1024; 16 heads of 64
TRAIN_MICRO, TRAIN_GLOBAL, TRAIN_SEQ, TRAIN_STEPS = 8, 16, 1024, 10
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12, "int8": 1979e12}
# K7-K9 against their plain versions.  float16 (phase 26): bf16's limit
# scaled by the ratio of the two types' ulps (2**-10 against 2**-7), one
# rounding of p before P.V placed differently by the kernel and the plain
# version; int8 caches under float16 q keep int8's (float32 math both sides)
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2 / 8, "int8": 1e-4}
QDT = {"float32": "float32", "bfloat16": "bfloat16", "float16": "float16", "int8": "bfloat16"}
MAX_NEW = 32
# request D: eight prompts in the 64-token bucket, mixed left pads
D_LENS = [12, 20, 28, 36, 44, 52, 60, 64]
# phase 6: paged rows (block 16) at these positions, one per row
KV_BLOCK = 16
PAGED_POS = [5, 17, 80, 200, 511, 700, 1000, 1023]
# phase 6: keys a split of the sm90 paged kernel, timed against each other
PAGED_SPLIT_KEYS = (128, 256, 512)
# phases 15-16: speculative decoding, draft_k 4 served (t = 5), the kernels
# also held at t = 8, 16 and 17 (K7/K8's prefill kernel, K9's chunk kernel)
SPEC_K = 4
VERIFY_TS = (SPEC_K + 1, 8, 16, 17)
# an answer token's logit under its prefix's argmax, in bf16 ulps of the
# argmax: ties and near-ties flip with rounding (PERF.md), a wrong token
# sits far below
SPEC_ULPS = 4.0
# phase 17: K9 at chunk width, one row: (t, slot of its first query), and
# the keys a split of the chunk kernel, timed against each other
CHUNK_CASES = ((256, 0), (256, 512), (128, 512), (64, 512), (17, 512), (16, 512))
CHUNK_SPLIT_KEYS = (128, 256, 512, 1024)
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
# phase 21: a tokenizer of the 256 byte symbols and TEXT_MERGES learned
# merges; TEXT_PROMPTS text prompts; beam search with TEXT_BEAMS beams (the
# server's GenerationConfig default; and
# TEXT_F32_NEW new tokens in the float32 card-against-CPU run); a beam's
# float32 score under greedy's by more than BEAM_SCORE_SLACK nats a token
# fails; the HF GPT-2-medium shape the converter reads
TEXT_MERGES, TEXT_PROMPTS, TEXT_BEAMS, TEXT_F32_NEW = 200, 8, 4, 16
BEAM_SCORE_SLACK = 0.0
# phase 21: the beam step whose K7 inputs (every layer, the cache as
# reordered by parent beam) are held against the plain version
BEAM_CAPTURE_STEP = 8
HF_GPT2_MEDIUM = {"n_embd": 1024, "n_layer": 24, "n_head": 16, "n_positions": 1024,
                  "vocab_size": 50257}
# phases 4, 7 and 16: the traffic runs this many times a server, the first
# round checked, every round timed (tokens/s: the rounds' median; one round
# keeps the script inside its time limit with phase 28)
TIMED_ROUNDS = 1
N_LAYERS = 24
# phase 12: K1/K2 against their plain versions.  float32: summation order
# only; bfloat16 outputs within one bf16 ulp (2**-7 of the value) of the
# plain version's; dscale/dbias (float32 sums over the rows) 1e-4 of the
# largest.  (abs, rel) for y and dx.
LN_TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-5, 2.0**-7), "float16": (1e-5, 2.0**-10)}
LN_SUM_TOL = 1e-4
# phase 13: the train CLI, a checkpoint at step CLI_SAVE (and the final
# one) that the resume starts from (the step count stays: the data order
# depends on it)
CLI_STEPS, CLI_EVAL_FREQ, CLI_EVAL_ITERS, CLI_SAVE = 12, 6, 2, 9
# losses of steps 10-12, resumed run against the first, relative: K6 adds
# dq with reductions in L2, so the card's sums differ from run to run.  15-20x
# the largest differences read (4.6e-6 and 6.7e-6, PERF.md)
RESUME_LOSS_TOL = 1e-4


# phase 28: the three dispatch modes (name, CUDA graphs, dispatch-ahead) and
# the prompt buckets warmed (and captured) before the traffic: their rows'
# table widths cover phase 7's
GRAPH_MODES = (("graphs_ahead", True, True), ("graphs", True, False),
               ("eager_sync", False, False))
GRAPH_WARM = (16, 64)
# phase 29: the profile window (seconds), the SLO objective (generous: the
# phase checks the slo block, not a breach) and the admin token
OBS_PROFILE_S = 2.0
OBS_SLO_TTFT_S = 5.0
OBS_TOKEN = "phase29-admin-token"
# phase 30: the rows of the in-process export/adopt round per pool dtype
FLEET_ENGINE_ROWS = 4
# phase 31: the flood that scales the supervised fleet up (requests sent at
# once, new tokens each), the admin token the control plane shares, and
# how many answers of a round are held to the argmax rule
ELASTIC_FLOOD = 32
ELASTIC_NEW = 64
ELASTIC_TOKEN = "phase31-fleet-token"
ELASTIC_CHECKED = 8


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
    """q in ``q_kind`` (by default the caches' type; bf16 over int8 caches)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qdt = getattr(torch, QDT[q_kind or kind])
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
    elt = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}[kind]
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
          and da.COUNTS[f"{key}_f16"] - before[f"{key}_f16"] == int(q.dtype == torch.float16)
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


def decode_poison(torch, da, shapes=None, kinds=(("bfloat16", None, "K7"), ("int8", None, "K8"))):
    """K7 and K8 on the sm90 route: NaN in every cache slot at or past
    ``limit`` (int8: in every scale there, the slots at the int8 extremes)
    leaves the output unchanged, at t = 1 (split-K, several splits) and at
    t = 64 (the tensor-core prefills, whose copies end at ``limit``), or at
    ``shapes``; and a repeat call gives the same bits.  ``kinds``: (cache
    kind, q kind or None, label)."""
    shapes = shapes or ((2, 16, 1, 64, 1024, 700, [0, 37]), main_prefill_shape())
    for kind, q_kind, name in kinds:
        for b, n, t, d, L, limit, vf in shapes:
            q, k, v, vft, ks, vs = make_inputs(torch, da, kind, b, n, t, d, L, limit, vf, 3,
                                               q_kind)
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


def check_rows(rows, what, max_new=MAX_NEW):
    check(isinstance(rows, list) and rows, f"{what}: no completions")
    for row in rows:
        check(isinstance(row, list) and 0 < len(row) <= max_new
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


def paged_inputs(torch, da, kind, b, n, t, d, bs, positions, seed, slack=0, q_kind=None):
    """Pools [nb, n, bs, d] holding each row's blocks at shuffled pool
    ids, tables [b, M] null-padded past each row's last needed block, or
    past ``slack`` slots more (a speculative row's reservation; M a power
    of two, as the engine's width bucket), q [b, t, n, d] in ``q_kind``
    (by default the pools' type; bf16 over int8 pools)."""
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
    qdt = getattr(torch, QDT[q_kind or kind])
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
    elt = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}[kind]
    q_elt = 4 if kind == "float32" else 2
    keys = sum(p + t for p in positions)
    nbytes = b * n * t * d * (q_elt + 4) + 2 * n * keys * d * elt + 4 * b * (M + 1)
    if kind == "int8":
        nbytes += 2 * n * keys * 4
    pairs = sum(p + r + 1 for p in positions for r in range(t))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * d * n * pairs / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def f16_ulp(x):
    """One float16 ulp at |x| (11 significant bits; subnormals' below 2**-14)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0**-14))) - 10)


def wrapper_tol(out_kind, ref):
    """The wrapper's output (the kernel's float32 cast to q's type) against
    the plain output given the same cast: the output type's kernel limit;
    float16 adds one ulp of the largest value, where the two float32
    values straddle one of its rounding boundaries (8x as dense as bf16's,
    whose 2e-2 already covers it)."""
    if out_kind != "float16":
        return TOL[out_kind]
    return TOL["float16"] + f16_ulp(ref.abs().max().item())


def paged_case(torch, F, da, kind, t, positions, seed=0, iters=20, q_kind=None, sweep=True):
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
    (CHUNK_SPLIT_KEYS for the chunk kernel, t > 16: ``split_ms``), unless
    ``sweep`` is False.  q in ``q_kind`` (by default as
    :func:`paged_inputs`)."""
    b, n, d, bs = len(positions), 16, 64, KV_BLOCK
    q, k, v, tables, pos, ks, vs = paged_inputs(torch, da, kind, b, n, t, d, bs,
                                                positions, seed, q_kind=q_kind)
    q_t = q.transpose(1, 2).contiguous()
    scale = 1.0 / d**0.5
    route = da.paged_kernel_route(q.dtype, d, t, bs)
    key = "paged_decode_q8" if kind == "int8" else "paged_decode"

    def launch(route=route, split_keys=None):
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
          and da.COUNTS[f"{key}_f16"] - before[f"{key}_f16"] == 2 * (q.dtype == torch.float16)
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
    out_kind = str(q.dtype).split(".")[1]
    wrapper_err = (got.float() - ref.transpose(1, 2).to(q.dtype).float()).abs().max().item()
    w_tol = wrapper_tol(out_kind, ref)
    check(wrapper_err <= w_tol, f"paged {kind} t={t} wrapper vs plain: max |err| "
                                f"{wrapper_err} > {w_tol}")
    ms = event_ms(torch, kernel, iters)
    launch_ms = event_ms(torch, launch, iters)
    plain_ms = event_ms(torch, plain, max(3, iters // 4))
    cuda_core = split_ms = None
    if route == "sm90" and sweep:
        cc = launch("cuda_core")
        torch.cuda.synchronize()
        cc_err = (cc - ref).abs().max().item()
        check(cc_err <= TOL[kind], f"paged {kind} t={t} CUDA-core kernel vs plain: {cc_err}")
        cuda_core = {"max_abs_err": cc_err,
                     "launch_ms": event_ms(torch, lambda: launch("cuda_core"), iters)}
        split_ms = {}
        for sk in CHUNK_SPLIT_KEYS if t > da.SPLIT_MAX_ROWS else PAGED_SPLIT_KEYS:
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
    return {"kind": kind, "q": out_kind, "b": b, "t": t, "bs": bs, "positions": positions,
            "route": route, "max_abs_err": err, "tol": TOL[kind], "wrapper_err": wrapper_err,
            "wrapper_tol": w_tol, "ms": ms, "launch_ms": launch_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "cuda_core": cuda_core, "split_ms": split_ms}


def paged_poison(torch, da, positions=PAGED_POS, ts=(1, 4),
                 kinds=("float32", "bfloat16", "int8"), slack=0, q_kind=None):
    """NaN in every pool block no row can see (the null block that pads
    the tables included, a row's reserved ``slack`` blocks past its bound,
    and one spare block past the rows' own) and in the slots of each row's
    last block past its bound, positions + t - 1 (int8 pools: NaN scales
    there, the payload at the int8 extremes): the wrapper must give the
    same finite result, on either route (f32: the CUDA-core kernel; bf16,
    int8: sm90, split-K or the chunk kernel), at each of ``ts``; the f32
    result agrees with the plain version on the clean pools; a repeat call
    of the sm90 kernel (rows over several splits) gives the same bits."""
    b, n, d, bs = len(positions), 16, 64, KV_BLOCK
    for kind in kinds:
        for t in ts:
            q, k, v, tables, pos, ks, vs = paged_inputs(torch, da, kind, b, n, t, d, bs,
                                                        positions, 5, slack, q_kind)
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
            check(route == ("cuda_core" if kind == "float32" else "sm90"),
                  f"{kind} t={t}: {route}")
            check(torch.equal(again, clean), f"paged {kind} t={t} ({route}): a repeat call "
                                             "differs")
            check(bool(torch.isfinite(got).all()) and torch.equal(got, clean),
                  f"paged {kind} t={t} ({route}): a NaN past a row's bound changed the output")
            if ref is not None:
                err = (got - ref).abs().max().item()
                check(err <= TOL["float32"], f"paged NaN poison vs plain on clean pools: {err}")
            log(f"  paged {kind:8s} q {str(q.dtype)[6:]} t={t} {route:9s}: NaN in {len(unseen)} "
                f"unseen pool blocks and in {b} last blocks past the bound leaves the output "
                f"unchanged; a repeat call is bitwise equal")


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
    log(f"  {what} {row['kind']:8s} q {row['q']:8s} {row['route']:9s} t={row['t']}: err "
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
        f"engine steps ({serving['graph_replays'] - serving0['graph_replays']} CUDA graph "
        f"replays of {serving['graphs']} graphs, dispatch-ahead {serving['dispatch_ahead']}), "
        f"{serving['mid_decode_admits']} mid-decode admissions, kernels {kernels}")
    info.update({"boot_s": boot_s, "latency_s": lat, "steps": steps,
                 "mid_decode_admits": serving["mid_decode_admits"], "answers": answers})
    return kernels, info


# ---------------------------------------------------------------------------
# phase 28: the continuous engine's dispatch path, three modes in process
# ---------------------------------------------------------------------------


def graph_traffic(sched, ps):
    """Phase 7's arrivals in process: the first request steps twice before
    the rest arrive 30 ms apart.  Returns (the answers, the wall)."""
    eng = sched.engine
    t0 = time.time()
    steps_at = eng.stats["steps"]
    futs = [sched.submit([ps[0]], MAX_NEW, deadline_s=600)]
    while eng.stats["steps"] < steps_at + 2:
        check(time.time() - t0 < 120, "the first request never stepped")
        time.sleep(0.001)
    for p in ps[1:]:
        futs.append(sched.submit([p], MAX_NEW, deadline_s=600))
        time.sleep(0.03)
    answers = [f.result(timeout=600)[0] for f in futs]
    return answers, time.time() - t0


def graph_mode_run(torch, da, server, kv_dtype, mode, graphs, ahead, ps, layers,
                   inspect=None):
    """One engine and scheduler in ``mode``: warm up, serve ``ps`` once,
    drain; returns the run's numbers, answers and K9 launches.
    ``inspect(sched)`` (optional) runs after the drain."""
    import gc
    import statistics

    from paddlefleetx_tpu_torch.core.continuous_batching import (
        ContinuousScheduler,
        PagedDecodeEngine,
    )

    gc.collect()
    eng = PagedDecodeEngine(server, max_batch=8, block=KV_BLOCK, kv_dtype=kv_dtype,
                            graphs=graphs)
    sched = ContinuousScheduler(eng, max_depth=16, name=f"phase28-{mode}",
                                dispatch_ahead=ahead, quantum=1)
    # the device memory the warmup keeps reserved: the graphs' private pool
    # (the arena and the buffers exist before it; what the warmup frees
    # goes back with empty_cache)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved()
    t0 = time.time()
    eng.warmup(GRAPH_WARM)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    torch.cuda.empty_cache()
    mem = torch.cuda.memory_reserved() - mem0
    g0 = dict(eng.graphs.stats) if graphs else {"graphs": 0, "graph_replays": 0,
                                                "graph_capture_s": 0.0}
    # the iteration period (between the scheduler's step calls) and the
    # device span of each step (events around its launches or its replay)
    stamps, spans = [], []
    inner_step = eng.step

    def timed_step():
        stamps.append(time.perf_counter())
        return inner_step()

    def spanned(fn):
        def run(*a):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(*a)
            e1.record()
            spans.append((e0, e1))
        return run

    eng.step = timed_step
    if graphs:
        eng.graphs.run = spanned(eng.graphs.run)
    else:
        eng._run_step = spanned(eng._run_step)
    steps0, gap_s0, gaps0 = eng.stats["steps"], eng.stats["host_gap_s"], eng.stats["gap_steps"]
    before = dict(da.COUNTS)
    sched.start()
    answers, wall = graph_traffic(sched, ps)
    check(sched.shutdown(timeout=120), f"phase 28 {mode}: the scheduler did not drain")
    torch.cuda.synchronize()
    used = {k: da.COUNTS[k] - before[k] for k in da.COUNTS}
    steps = eng.stats["steps"] - steps0
    gap_steps = eng.stats["gap_steps"] - gaps0
    g1 = eng.graphs.stats if graphs else g0
    key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
    what = f"phase 28 {mode} kv={kv_dtype or 'native'} {layers} layers"
    check(used["paged_plain"] == 0 and used["plain"] == 0, f"{what}: plain version ran {used}")
    check(used[key] == layers * steps > 0,
          f"{what}: {used[key]} K9 launches for {steps} steps of {layers} layers")
    if server.module.config.dtype == "bfloat16":
        check(used[f"{key}_sm90"] == used[key], f"{what}: K9 launches off the sm90 route {used}")
    replays = g1["graph_replays"] - g0["graph_replays"]
    if graphs:
        check(replays == steps and g1["graphs"] == g0["graphs"],
              f"{what}: {replays} replays and {g1['graphs'] - g0['graphs']} captures for "
              f"{steps} steps after warmup (each step must be a replay)")
    for a in answers:
        check_rows([a], what)
    if inspect is not None:
        inspect(sched)
    dev_ms = [e0.elapsed_time(e1) for e0, e1 in spans]
    period = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    info = {
        "mode": mode, "kv": kv_dtype or "native", "layers": layers, "steps": steps,
        "step_wall_ms": statistics.median(period), "device_ms": statistics.median(dev_ms),
        "host_gap_ms": (eng.stats["host_gap_s"] - gap_s0) * 1e3 / max(gap_steps, 1),
        "gap_steps": gap_steps, "traffic_s": wall, "warmup_s": warm_s,
        "graphs": g1["graphs"], "capture_s": g1["graph_capture_s"], "replays": replays,
        "warmup_mem_mib": mem / 2**20, "k9_launches": used[key],
        "k9_sm90": used[f"{key}_sm90"],
    }
    log(f"  {what}: {steps} steps, step wall {info['step_wall_ms']:.3f} ms (median), device "
        f"{info['device_ms']:.3f} ms, host gap {info['host_gap_ms']:.3f} ms over {gap_steps} "
        f"gap steps; {info['graphs']} graphs captured in {info['capture_s']:.2f} s, {replays} "
        f"replays; {info['warmup_mem_mib']:.1f} MiB kept by the warmup; K9 {used[key]} "
        "launches")
    del sched, eng
    return info, answers


def phase_graphs(torch, da, card):
    """Phase 28 (see the module docstring): bf16 and int8 pools at 24
    layers, then float32 at PFX_F32_LAYERS layers."""
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.utils.config import get_config

    ps = prompts(7, D_LENS)
    report = {"card": card, "runs": []}
    for dtype, layers in (("bfloat16", N_LAYERS), ("float32", PFX_F32_LAYERS)):
        cfg = get_config(str(REPO / CONFIG), [
            "Generation.decode_strategy=greedy_search", f"Generation.max_dec_len={MAX_NEW}",
            f"Model.dtype={dtype}", f"Model.num_layers={layers}"])
        module = GPTModule(cfg)
        model = module.init_model(cfg.Global.seed, "cuda")
        server = GenerationServer(cfg, module, model, torch.device("cuda"))
        for kv in ("", "int8"):
            runs = {}
            for mode, graphs, ahead in GRAPH_MODES:
                info, answers = graph_mode_run(torch, da, server, kv, mode, graphs, ahead, ps,
                                               layers)
                runs[mode] = answers
                report["runs"].append(info)
            eager_mem = report["runs"][-1]["warmup_mem_mib"]
            for info in report["runs"][-3:-1]:
                info["graph_pool_mib"] = info["warmup_mem_mib"] - eager_mem
            if dtype == "float32":
                check(runs["graphs_ahead"] == runs["graphs"] == runs["eager_sync"],
                      f"phase 28 float32 kv={kv or 'native'}: tokens differ across modes")
                log(f"  float32 kv={kv or 'native'}: tokens identical across the three modes")
                continue
            worst = 0.0
            same = 0
            for mode, answers in runs.items():
                same += answers == runs["eager_sync"]
                for prompt, ans in zip(ps, answers):
                    worst = max([worst] + greedy_deficits(torch, G, model, module.config,
                                                          prompt, ans, kv))
            check(worst <= SPEC_ULPS,
                  f"phase 28 kv={kv or 'bf16'}: a token sits {worst:.1f} bf16 ulps under its "
                  f"prefix's argmax (> {SPEC_ULPS})")
            report[f"bf16_{kv or 'native'}"] = {"modes_identical_to_eager": same,
                                                "worst_deficit_ulps": worst}
            log(f"  bf16 kv={kv or 'native'}: {same} of 3 modes identical to eager_sync; every "
                f"token within {worst:.1f} bf16 ulps of its prefix's argmax")
        del server, model
    return report


# ---------------------------------------------------------------------------
# phase 29: serving observability on the card
# ---------------------------------------------------------------------------


def admin_http(port, path, body=None, token=OBS_TOKEN, timeout=600):
    """(status, parsed JSON) of an /admin or /debug call; an HTTP error
    status comes back as its code, never raised."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"Authorization": f"Bearer {token}"} if token else {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def check_nesting(doc, what):
    """A Chrome trace's spans nest per (pid, tid) lane: any two are
    disjoint or one holds the other (Perfetto's loading rule)."""
    lanes = {}
    for ev in doc["traceEvents"]:
        check(ev.get("ph") in ("X", "M"), f"{what}: unknown event {ev}")
        if ev["ph"] == "X":
            check(ev["dur"] >= 0 and ev["ts"] >= 0 and ev["name"], f"{what}: bad span {ev}")
            lanes.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for lane, evs in lanes.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for ev in evs:
            start, end = ev["ts"], ev["ts"] + ev["dur"]
            while stack and start >= stack[-1] - 1.0:
                stack.pop()
            check(not stack or end <= stack[-1] + 1.0,
                  f"{what}: {ev['name']} overlaps its enclosing span in lane {lane}")
            stack.append(end)
    return len(lanes)


def metric_values(port):
    """/metrics parsed with the port's own parser: {(name, labels): v}."""
    from paddlefleetx_tpu_torch.utils.telemetry import parse_exposition

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in parse_exposition(text)}


def ledger_closure(vals, what):
    """The goodput ledgers from /metrics: the six time buckets against the
    wall (within 1%), the token dispositions against admitted (exactly,
    with 0 in flight).  Returns (buckets, wall, tokens)."""
    buckets = {dict(lab)["bucket"]: v for (n, lab), v in vals.items()
               if n == "pfx_sched_time_seconds_total"}
    wall = vals[("pfx_sched_wall_seconds_total", ())]
    check(set(buckets) == {"device_decode", "device_prefill", "host_sched", "readback",
                           "stream_flush", "idle"}, f"{what}: buckets {sorted(buckets)}")
    check(wall > 0 and abs(sum(buckets.values()) - wall) <= 0.01 * wall,
          f"{what}: time buckets {sum(buckets.values()):.6f} s against the wall {wall:.6f} s")
    toks = {dict(lab)["disposition"]: v for (n, lab), v in vals.items()
            if n == "pfx_token_ledger_total"}
    inflight = vals[("pfx_token_ledger_in_flight", ())]
    out = sum(toks[d] for d in ("delivered", "evicted_lost", "preempt_refunded",
                                "shed_after_admit"))
    check(inflight == 0 and toks["admitted"] == out > 0,
          f"{what}: token ledger {toks}, in flight {inflight}")
    return buckets, wall, toks


def phase_observability(torch, da, env, card):
    """Phase 29 (see the module docstring).  Returns the phase's report."""
    import tempfile

    report = {"card": card}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase29-", dir=str(REPO / "build"))
    port = free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), "--scheduler", "continuous", "--cb-batch", "8",
           "-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}",
           "--slo-ttft-p99", str(OBS_SLO_TTFT_S), "--slo-windows", "60,600"]
    senv = dict(env, PFX_TRACE_SAMPLE="1", PFX_ADMIN_TOKEN=OBS_TOKEN, PFX_FLIGHT_DIR=tmp)
    out_path = Path(tmp) / "serve.log"
    t0 = time.time()
    with open(out_path, "w") as fh:
        proc = subprocess.Popen(cmd, cwd=REPO, env=senv, stdout=fh, stderr=subprocess.STDOUT)
    ps = prompts(7, D_LENS)

    def output():
        return out_path.read_text()[-3000:]

    def traffic(poll=True):
        """Phase 7's arrivals: the first request steps twice (``poll``:
        watched on /healthz) before the rest arrive 30 ms apart.  Returns
        the answers' bodies."""
        results = {}

        def post(i):
            try:
                results[i] = http(port, "/generate", {"prompt_ids": ps[i], "max_tokens": MAX_NEW})
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = e

        steps_at = http(port, "/healthz", timeout=30)["serving"]["steps"]
        t1 = time.time()
        threads = [threading.Thread(target=post, args=(0,))]
        threads[0].start()
        while poll and http(port, "/healthz", timeout=30)["serving"]["steps"] < steps_at + 2:
            check(time.time() - t1 < 120, "phase 29: the first request never stepped")
            time.sleep(0.01)
        for i in range(1, len(ps)):
            threads.append(threading.Thread(target=post, args=(i,)))
            threads[-1].start()
            time.sleep(0.03)
        for th in threads:
            th.join(timeout=600)
        for i in range(len(ps)):
            check(isinstance(results.get(i), dict), f"phase 29 request {i}: {results.get(i)}")
            check_rows([results[i]["completion_ids"]], f"phase 29 request {i}")
        return [results[i] for i in range(len(ps))]

    try:
        health = None
        while health is None:
            check(proc.poll() is None, f"phase 29 server exited {proc.returncode}: {output()}")
            check(time.time() - t0 < 420, "phase 29 server did not come up in 420 s")
            try:
                health = http(port, "/healthz", timeout=5)
            except OSError:
                time.sleep(1)
        report["boot_s"] = time.time() - t0
        check(health["identity"]["device"].startswith("cuda"), f"phase 29 device {health}")
        check("slo" in health and health["slo"]["enabled"], f"phase 29: no slo block {health}")
        code, body = admin_http(port, "/debug/state", token=None)
        check(code == 401, f"phase 29: /debug/state without the token answered {code} {body}")
        t1 = time.time()
        bodies = traffic()
        report["traffic_s"] = time.time() - t1
        # a served request's timeline
        tid = bodies[-1].get("trace_id")
        check(tid, f"phase 29: a 200 without a trace_id at PFX_TRACE_SAMPLE=1: {bodies[-1]}")
        code, tl = admin_http(port, f"/debug/trace?id={tid}")
        check(code == 200, f"phase 29: /debug/trace answered {code} {tl}")
        names = [e["name"] for e in tl["events"]]
        chunks = [e for e in tl["events"] if e["name"] == "decode_chunk"]
        check(tl["done"] and "admission" in names and "queue_wait" in names
              and ("prefill" in names or "prefill_chunk" in names) and names.count("respond") == 1
              and sum(c["args"]["committed"] for c in chunks)
              >= len(bodies[-1]["completion_ids"]), f"phase 29: timeline {names}")
        code, doc = admin_http(port, "/debug/traces")
        check(code == 200, f"phase 29: /debug/traces answered {code}")
        lanes = check_nesting(doc, "phase 29 /debug/traces")
        check(lanes >= len(ps), f"phase 29: {lanes} lanes for {len(ps)} requests")
        code, dbg = admin_http(port, "/debug/state")
        check(code == 200 and dbg["scheduler"] == "continuous" and dbg["decisions"]
              and dbg["goodput"]["tokens_in_flight"] == 0 and not dbg["overlap"]["inflight"],
              f"phase 29: /debug/state {code} {str(dbg)[:2000]}")
        vals = metric_values(port)
        buckets, wall, toks = ledger_closure(vals, "phase 29")
        health = http(port, "/healthz", timeout=30)
        kernels = health["kernels"]
        check(kernels["paged_decode"] > 0 and kernels["paged_decode_sm90"] == kernels["paged_decode"]
              and kernels["paged_plain"] == 0 and kernels["plain"] == 0,
              f"phase 29: K9 launches {kernels}")
        report.update({
            "time_buckets_s": buckets, "wall_s": wall, "tokens": toks,
            "decisions": len(dbg["decisions"]), "trace_events": len(tl["events"]),
            "k9_launches": kernels["paged_decode"], "k9_plain": kernels["paged_plain"],
            "slo": health["slo"]["burn"]})
        log(f"  phase 29: boot {report['boot_s']:.1f}s; trace {tid}: {len(tl['events'])} events "
            f"({len(chunks)} decode steps); /debug/traces {lanes} lanes nest; time buckets "
            f"{json.dumps({k: round(v, 4) for k, v in buckets.items()})} close against the wall "
            f"{wall:.4f} s; tokens {json.dumps(toks)}; K9 {kernels['paged_decode']} launches, "
            f"0 plain; slo burn {health['slo']['burn']}")
        # a profile under traffic: rounds of phase 7's traffic until it ends,
        # without the /healthz polls (the profiler's stop pays for every
        # thread the server ran during the window, one a request)
        prof = {}

        def profile():
            prof["code"], prof["body"] = admin_http(
                port, "/admin/profile", {"seconds": OBS_PROFILE_S, "top": 40})

        pth = threading.Thread(target=profile)
        t1 = time.time()
        pth.start()
        rounds = 0
        while pth.is_alive():
            traffic(poll=False)
            rounds += 1
        pth.join()
        report["profile_wall_s"] = time.time() - t1
        code, summ = prof["code"], prof["body"]
        check(code == 200 and summ["source"] == "cuda" and summ["device_us"] > 0
              and summ["top_ops"], f"phase 29: /admin/profile {code} {str(summ)[:2000]}")
        tops = summ["top_ops"]
        k9 = [r for r in tops if "paged" in r["op"].lower() or "graph" in r["op"].lower()]
        check(k9, f"phase 29: no K9 kernel or graph launch among the top device ops "
                  f"{[r['op'] for r in tops]}")
        report["profile"] = {k: summ[k] for k in ("seconds", "stop_s", "fold_s", "device_us",
                                                  "host_us", "op_count")}
        report["profile"]["top_ops"] = [
            {k: r[k] for k in ("op", "occurrences", "self_us", "self_frac")} for r in tops]
        report["profile"]["traffic_rounds"] = rounds
        log(f"  phase 29 profile: {summ['seconds']} s ({summ['stop_s']} s in the profiler's stop, "
            f"{summ['fold_s']} s folding), device {summ['device_us']:.0f} us, host "
            f"{summ['host_us']:.0f} us, {summ['op_count']} device ops, {rounds} traffic rounds; "
            "top device ops:")
        for r in tops[:12] + [r for r in k9 if r not in tops[:12]]:
            log(f"    {r['self_us']:12.1f} us {100 * r['self_frac']:5.1f}% x{r['occurrences']:<6}"
                f" {r['op'][:110]}")
        t1 = time.time()
        code, body = admin_http(port, "/admin/drain", {})
        check(code == 200 and body["state"] == "draining", f"phase 29: /admin/drain {code} {body}")
        rc = proc.wait(timeout=120)
        check(rc == 0, f"phase 29: drain exit {rc}: {output()}")
        check("drained cleanly" in output(), "phase 29: no clean-drain line")
        dump = Path(tmp) / "flight_recorder.jsonl"
        check(dump.is_file(), f"phase 29: no flight dump in {tmp}")
        events = [json.loads(line) for line in dump.read_text().splitlines()]
        kinds = [e.get("event") for e in events]
        check("drain_start" in kinds and "drain_done" in kinds and "span" in kinds,
              f"phase 29: the flight dump holds {kinds[-20:]}")
        report["flight_events"] = len(events)
        report["drain_s"] = time.time() - t1
        log(f"  phase 29: /admin/drain exit 0; flight dump {len(events)} lines "
            f"(drain_start, drain_done, {kinds.count('span')} request spans)")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    # in process: phase 28's bf16 traffic, graphs and dispatch-ahead, with
    # tracing on and off
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.utils import tracing
    from paddlefleetx_tpu_torch.utils.config import get_config

    t1 = time.time()
    cfg = get_config(str(REPO / CONFIG), [
        "Generation.decode_strategy=greedy_search", f"Generation.max_dec_len={MAX_NEW}"])
    module = GPTModule(cfg)
    server = GenerationServer(cfg, module, module.init_model(cfg.Global.seed, "cuda"),
                              torch.device("cuda"))
    report["in_process"] = {}

    def replayed(sched):
        rep = tracing.replay_decision_log(sched.decision_log)
        check(rep["prefill_admits"] == sched.stats["prefill_admits"] > 0
              and rep["iterations"] == len(sched.decision_log)
              and rep["tok_delivered"] == sched.token_ledger()["delivered"],
              f"phase 29: the decision log replays to {rep}, the scheduler counts "
              f"{dict(sched.stats)}")
        buckets = sched.time_ledger()
        check(abs(sum(buckets["buckets"].values()) - buckets["wall_s"])
              <= 0.01 * buckets["wall_s"], f"phase 29: in-process time ledger {buckets}")

    for sample in (1.0, 0.0):
        tracing._buffer = tracing.TraceBuffer(sample=sample)
        info, _ = graph_mode_run(torch, da, server, "", f"trace_{sample:g}", True, True, ps,
                                 N_LAYERS, inspect=replayed if sample else None)
        report["in_process"][f"sample_{sample:g}"] = {
            k: info[k] for k in ("steps", "step_wall_ms", "device_ms", "k9_launches", "replays")}
    tracing._buffer = None
    report["in_process_s"] = time.time() - t1
    on, off = report["in_process"]["sample_1"], report["in_process"]["sample_0"]
    log(f"  phase 29 in process: step wall {on['step_wall_ms']:.3f} ms traced, "
        f"{off['step_wall_ms']:.3f} ms untraced (median); K9 {on['k9_launches']} / "
        f"{off['k9_launches']} launches; seconds: boot {report['boot_s']:.1f}, traffic "
        f"{report['traffic_s']:.1f}, profile {report['profile_wall_s']:.1f}, drain "
        f"{report['drain_s']:.1f}, in process {report['in_process_s']:.1f}")
    del server
    return report


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
    dt = getattr(torch, kind)
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
            ok = (errs[2] <= BF16_ROW_TOL[name] * ROW_SCALE[kind]
                  and errs[3] <= BF16_DIFFER_TOL[name] * DIFFER_SCALE[kind])
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
    dt = getattr(torch, kind)
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


def keep_dir(prefix):
    """A temporary directory that outlives its phase (a later phase removes
    it), removed at exit if the run stops before that."""
    import atexit
    import shutil
    import tempfile

    path = tempfile.mkdtemp(prefix=prefix)
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


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
        # the resumed run's final checkpoint is what phases 21 and 25 read;
        # the corpus and the inline loader's token digests are phase 23's
        keep = keep_dir("smoke_ckpt_")
        final = shutil.move(os.path.join(out_dir, f"step_{CLI_STEPS}"), keep)
        corpus = shutil.move(data_dir, keep)
        return launches, final, {"data_dir": corpus,
                                 "digests": [r["tokens_digest"] for r in first]}
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


def greedy_deficits(torch, G, model, cfg, prompt, answer, kv_dtype, ulp=None):
    """Teacher-force ``prompt + answer`` through the cached forward on the
    card (one prefill, a cache of ``kv_dtype``): for each answer token,
    how far its logit sits under the largest, in ``ulp``s (bf16's by
    default) of the largest.  0 where the token is the argmax."""
    ulp = ulp or bf16_ulp
    ids = torch.tensor([prompt + answer], device="cuda")
    with torch.inference_mode():
        cache = G.init_cache(cfg, 1, ids.shape[1], torch.device("cuda"),
                             kv_dtype=kv_dtype or "bf16")
        lg = G.forward_cached(model, ids, cache, 0)[0].float()
    lg = lg[len(prompt) - 1: len(prompt) - 1 + len(answer)]
    top = lg.max(dim=-1).values
    chosen = lg.gather(-1, torch.tensor(answer, device="cuda")[:, None])[:, 0]
    return [(a - c) / ulp(a) for a, c in zip(top.tolist(), chosen.tolist())]


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
    against its plain version with CUDA-event times, the CUDA-core
    kernel's, SDPA's over the gathered keys (bf16) and the bound; a launch
    wider than SPLIT_MAX_ROWS takes the sm90 route's chunk kernel and
    counts in ``*_chunk`` and ``*_sm90_chunk`` (the CUDA-core launches
    made to time it are taken out); NaN in the null block, a spare block
    and past the last query's bound leaves the output unchanged, and a
    repeat call gives the same bits."""
    rows = {}
    for name, kind in (("paged_decode", "bfloat16"), ("paged_decode_q8", "int8")):
        rows[name] = []
        for t, pos in CHUNK_CASES:
            before = dict(da.COUNTS)
            row = paged_case(torch, F, da, kind, t, [pos], iters=50)
            launched = da.COUNTS[f"{name}_sm90"] - before[f"{name}_sm90"]
            chunked = da.COUNTS[f"{name}_sm90_chunk"] - before[f"{name}_sm90_chunk"]
            check(row["route"] == "sm90" and launched > 0
                  and chunked == launched * (t > da.SPLIT_MAX_ROWS),
                  f"{name} t={t}: {chunked} of {launched} sm90 launches on the chunk kernel")
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
    check(kernels[f"{key}_sm90"] == kernels[key]
          and kernels[f"{key}_sm90_chunk"] == kernels[f"{key}_chunk"],
          f"{key}: a launch off the sm90 route, or a chunk off its chunk kernel: {kernels}")
    info = {"boot_s": boot_s, "traffic_s": wall, "hits": hits,
            "hit_tokens": delta(serving0, serving, "prefix", "hit_tokens"),
            "misses": delta(serving0, serving, "prefix", "misses"),
            "evictions": delta(serving0, serving, "prefix", "evictions"), "spills": spills,
            "readmits": readmits, "spill_discards": delta(serving0, serving, "spill", "discards"),
            "prefill_chunks": chunks, "prefill_tokens": computed, "prompt_tokens": sent,
            "steps": steps, "long_interleaved_chunks": beside,
            "ttft_p50_s": health.get("ttft_p50_s"), "ttft_p99_s": health.get("ttft_p99_s"),
            "prefix_cached_blocks": serving["prefix_cached_blocks"],
            "prefix_spill_bytes": serving["prefix_spill_bytes"],
            "answers": [results[i]["completion_ids"] for i in names],
            "prompts": seq + [long_]}
    log(f"  prefix kv={kv_dtype or 'bf16'}: boot {boot_s:.1f}s, {len(names)} requests in "
        f"{wall:.2f}s (TTFT p50 {info['ttft_p50_s']} s, p99 {info['ttft_p99_s']} s); {hits} "
        f"hits ({info['hit_tokens']} tokens), {spills} spills, {readmits} readmits, {chunks} "
        f"chunks, {computed} of {sent} prompt tokens computed, {steps} steps, the long "
        f"prompt's chunks beside decode {beside}; kernels {kernels}")
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
    # every launch on the sm90 route: a resume's suffix chunk (t > 16) on its
    # chunk kernel, every decode step on its split-K kernel
    check(kernels[f"{key}_sm90"] == kernels[key]
          and kernels[f"{key}_sm90_chunk"] == kernels[f"{key}_chunk"]
          and kernels[key] - kernels[f"{key}_chunk"] >= N_LAYERS * steps,
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
# phase 21: a trained and a converted GPT-345M served with text
# ---------------------------------------------------------------------------


def smoke_text(seed, n_words):
    """Seeded words of a small syllable set, with numbers and punctuation:
    the BPE pass's training text and the phase's prompts."""
    import random

    rnd = random.Random(seed)
    syl = ["th", "e", "an", "in", "er", "on", "re", "at", "st", "ou", "ing", "ch", "s", "a",
           "l", "o", "d"]
    words = []
    for _ in range(n_words):
        r = rnd.random()
        if r < 0.1:
            words.append(str(rnd.randint(0, 999)))
        elif r < 0.15:
            words.append(rnd.choice([",", ".", "'s", "!"]))
        else:
            words.append("".join(rnd.choice(syl) for _ in range(rnd.randint(1, 3))))
    return " ".join(words)


def write_tokenizer(path):
    """vocab.json + merges.txt: the 256 byte symbols (id = byte), the
    TEXT_MERGES merges of a short BPE pass over a seeded text, and
    <|endoftext|> at 50256, the config's eos_token_id."""
    from collections import Counter

    from paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer import (
        bytes_to_unicode,
        pre_tokenize,
    )

    b2u = bytes_to_unicode()
    words = Counter(tuple(b2u[b] for b in w.encode()) for w in pre_tokenize(smoke_text(0, 4000)))
    merges = []
    for _ in range(TEXT_MERGES):
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    symbols = [b2u[b] for b in range(256)] + [a + b for a, b in merges]
    vocab = {s: i for i, s in enumerate(dict.fromkeys(symbols))}
    vocab["<|endoftext|>"] = 50256
    os.makedirs(path)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return path


def write_hf_gpt2_medium(path, seed):
    """A GPT-2-medium directory as the hub lays it out: config.json and
    model.safetensors with bare keys (``h.0.attn.c_attn.weight``) and the
    ``attn.bias`` mask buffers; normal(0.02) weights, LayerNorm scales
    1 + normal(0.02), biases normal(0.01), all from ``seed``."""
    import numpy as np

    from paddlefleetx_tpu_torch.tools.convert_hf_gpt2 import write_safetensors

    cfg = dict(HF_GPT2_MEDIUM, activation_function="gelu_new", layer_norm_epsilon=1e-5,
               n_inner=None, model_type="gpt2")
    rng = np.random.default_rng(seed)
    h, P = cfg["n_embd"], cfg["n_positions"]

    def t(*shape, std=0.02, mean=0.0):
        return (mean + std * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)

    sd = {"wte.weight": t(cfg["vocab_size"], h), "wpe.weight": t(P, h, std=0.01),
          "ln_f.weight": t(h, mean=1.0), "ln_f.bias": t(h, std=0.01)}
    mask = np.tril(np.ones((P, P), np.float32)).reshape(1, 1, P, P)
    for i in range(cfg["n_layer"]):
        p = f"h.{i}."
        sd.update({p + "ln_1.weight": t(h, mean=1.0), p + "ln_1.bias": t(h, std=0.01),
                   p + "attn.bias": mask,
                   p + "attn.c_attn.weight": t(h, 3 * h), p + "attn.c_attn.bias": t(3 * h, std=0.01),
                   p + "attn.c_proj.weight": t(h, h), p + "attn.c_proj.bias": t(h, std=0.01),
                   p + "ln_2.weight": t(h, mean=1.0), p + "ln_2.bias": t(h, std=0.01),
                   p + "mlp.c_fc.weight": t(h, 4 * h), p + "mlp.c_fc.bias": t(4 * h, std=0.01),
                   p + "mlp.c_proj.weight": t(4 * h, h), p + "mlp.c_proj.bias": t(h, std=0.01)})
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    return path


def start_serve(env, tag, args, warmup=False):
    """``tools.serve`` on the card, without warmup unless ``warmup`` (then
    ``args`` name the buckets), its output drained by a thread; returns
    the server's handle."""
    port = free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", CONFIG,
           "--port", str(port), *([] if warmup else ["--no-warmup"]), *args]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    return {"tag": tag, "proc": proc, "port": port, "lines": lines, "reader": reader,
            "t0": time.time()}


def wait_serve(srv, limit=420):
    """Poll /healthz until the server answers; its kernel counts start at 0."""
    while True:
        check(srv["proc"].poll() is None, f"{srv['tag']} server exited "
              f"{srv['proc'].returncode}: {''.join(srv['lines'])[-3000:]}")
        check(time.time() - srv["t0"] < limit, f"{srv['tag']} server not up in {limit} s")
        try:
            health = http(srv["port"], "/healthz", timeout=5)
            break
        except OSError:
            time.sleep(0.5)
    check(health["identity"]["device"].startswith("cuda"), f"{srv['tag']}: {health['identity']}")
    check(all(v == 0 for v in health["kernels"].values()),
          f"{srv['tag']}: kernel counts not 0 before traffic: {health['kernels']}")
    srv["boot_s"] = time.time() - srv["t0"]
    return health


def stop_serve(srv):
    """SIGTERM: the server drains and exits 0."""
    srv["proc"].send_signal(signal.SIGTERM)
    rc = srv["proc"].wait(timeout=120)
    srv["reader"].join(timeout=10)
    out = "".join(srv["lines"])
    check(rc == 0 and "drained cleanly" in out, f"{srv['tag']} drain exit {rc}: {out[-3000:]}")


def kill_serve(srv):
    if srv["proc"].poll() is None:
        srv["proc"].kill()
        srv["proc"].wait(timeout=30)


def load_served_model(torch, ckpt, overrides=(), device="cuda"):
    """The model the serve CLI builds from ``ckpt``: the config's, with the
    checkpoint's params cast to its dtype, on ``device``."""
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.models.gpt.model import GPTModel
    from paddlefleetx_tpu_torch.utils.checkpoint import load_params_into, restore_params
    from paddlefleetx_tpu_torch.utils.config import get_config

    cfg = get_config(str(REPO / CONFIG), list(overrides))
    module = GPTModule(cfg)
    model = load_params_into(GPTModel(module.config), restore_params(ckpt), ckpt)
    return model.to(device), module.config


def in_process_greedy(torch, G, model, batch):
    """``generate`` at the server's batch shape (rows padded to a power of
    two with the last prompt, the 64-token bucket), cut as the server cuts."""
    target = 1
    while target < len(batch):
        target *= 2
    ids, lens = G.pad_prompts(list(batch) + [batch[-1]] * (target - len(batch)), 0, 64,
                              torch.device("cuda"))
    gen = G.GenerationConfig(max_dec_len=MAX_NEW, decode_strategy="greedy_search",
                             eos_token_id=50256, pad_token_id=0)
    out = G.generate(model, ids, gen, prompt_lens=lens).cpu().tolist()[:len(batch)]
    return [r[:r.index(50256)] if 50256 in r else r for r in out]


def norm_score(torch, pm, model, cfg, prompt, cont, alpha=1.0):
    """A continuation's length-normalised log-probability under ``model``'s
    plain forward (the beam's own scoring: an answer the server cut at EOS
    is scored with its EOS)."""
    if len(cont) < MAX_NEW:
        cont = cont + [50256]
    ids = torch.tensor([prompt + cont], device="cuda")
    with torch.no_grad():
        lp = torch.log_softmax(pm.forward(model, ids, cfg)[0].float(), dim=-1)
    rows = lp[len(prompt) - 1:len(prompt) - 1 + len(cont)]
    total = rows.gather(-1, torch.tensor(cont, device="cuda")[:, None]).sum().item()
    return total / len(cont) ** alpha


def beam_traced(torch, G, model, ids, gen, device="cuda"):
    """``generate`` with ``gen``'s beam search over ``ids`` left-padded in
    the 64-token bucket, as the server runs it, recording each step's three
    top-k calls (the 2K candidates over [b, K * vocab], the finished pool,
    the K kept) and every layer's K7 inputs at step ``BEAM_CAPTURE_STEP``
    (t = 1 over b * K rows, the cache reordered by parent beam).  Returns
    (answers cut at EOS, the top-k records, the K7 inputs)."""
    pids, plens = G.pad_prompts(ids, 0, 64, torch.device(device))
    at = pids.shape[1] + BEAM_CAPTURE_STEP
    topk, attn = G.top_k_lower_index, G.decode_attention
    rec, k7 = [], []

    def spy_topk(x, k):
        out = topk(x, k)
        rec.append(out)
        return out

    def spy_attn(q, k_cache, v_cache, pos, **kw):
        if pos == at:
            k7.append((q.clone(), k_cache.clone(), v_cache.clone(), pos,
                       kw["kv_valid_from"].clone()))
        return attn(q, k_cache, v_cache, pos, **kw)

    G.top_k_lower_index, G.decode_attention = spy_topk, spy_attn
    try:
        out = G.generate(model, pids, gen, prompt_lens=plens).cpu().tolist()
    finally:
        G.top_k_lower_index, G.decode_attention = topk, attn
    eos = gen.eos_token_id
    return [r[:r.index(eos)] if eos in r else r for r in out], rec, k7


def beam_deficits(torch, G, pm, model, cfg, ids, gen, rec, device="cuda", ulp=None):
    """The greedy runs' deficit rule, a beam step at a time: replay the
    recorded search with its own prefix scores and choices, each alive
    beam's next log-probs from ``model``'s plain forward under ``cfg``
    (prompt + prefix, no cache).  A kept continuation that the plain
    forward ranks under the Kth best non-EOS candidate, or a top-2K
    candidate (the finished pool's intake) under the 2Kth best, sits that
    far under it, in ``ulp``s (bf16's by default) of the prompt's largest
    logit; 0 where the plain forward makes the same choices.  Returns (the worst deficit, the
    (step, prompt) pairs with one, the rows whose parent beam is another
    row at step ``BEAM_CAPTURE_STEP``)."""
    import torch.nn.functional as F

    ulp = ulp or bf16_ulp
    b, K, V, DEC = len(ids), gen.num_beams, cfg.vocab_size, gen.max_dec_len
    check(gen.num_beam_groups == 1 and len(rec) == 3 * DEC,
          f"beam replay: {len(rec)} top-k calls for {DEC} steps of one group")
    dev = torch.device(device)
    seqs = torch.zeros((b, K, 0), dtype=torch.int64, device=dev)
    scores = torch.where(torch.arange(K, device=dev) == 0, 0.0, -1e9)[None].repeat(b, 1)
    rows = torch.arange(b * K, device=dev)
    worst, near, moved = 0.0, 0, 0
    for i in range(DEC):
        (_, top_i), _, (a_s, a_i) = rec[3 * i:3 * i + 3]
        seq = [ids[p] + seqs[p, k].tolist() for p in range(b) for k in range(K)]
        width = max(map(len, seq))
        x = torch.tensor([r + [0] * (width - len(r)) for r in seq], device=dev)
        last = torch.tensor([len(r) - 1 for r in seq], device=dev)
        with torch.no_grad():
            lg = pm.forward(model, x, cfg)[rows, last].float()
        logp = F.log_softmax(lg, dim=-1)
        logp = G.apply_min_length(logp, i, gen.min_dec_len, gen.eos_token_id)
        logp = G.apply_forced_token(logp, i, 0, gen.forced_bos_token_id)
        logp = G.apply_forced_token(logp, i, DEC - 1, gen.forced_eos_token_id)
        cand = (scores[:, :, None] + logp.view(b, K, V)).reshape(b, K * V)
        alive = cand.view(b, K, V).clone()
        alive[:, :, gen.eos_token_id] = float("-inf")
        kept = top_i.gather(1, a_i)
        gap = torch.maximum(
            (torch.topk(cand, 2 * K).values[:, -1:] - cand.gather(1, top_i)).max(1).values,
            (torch.topk(alive.view(b, K * V), K).values[:, -1:] - cand.gather(1, kept))
            .max(1).values).clamp(min=0)
        top = lg.view(b, K * V).max(1).values
        for g, t in zip(gap.tolist(), top.tolist()):
            worst = max(worst, g / ulp(t))
            near += g > 0
        parent, tok = kept // V, kept % V
        if i == BEAM_CAPTURE_STEP:
            moved = int((parent != torch.arange(K, device=dev)).sum())
        seqs = torch.cat([seqs.gather(1, parent[:, :, None].expand(-1, -1, i)), tok[:, :, None]],
                         dim=2)
        scores = a_s
    return worst, near, moved


def beam_kernel_case(torch, F, da, k7):
    """K7 on one beam step's captured inputs (b * K rows, t = 1, the cache
    reordered by parent beam), every layer, against its plain version at
    the tolerance of the model's type; timed, with its bound and SDPA, on
    the last layer's."""
    errs = []
    for q, k, v, pos, vf in k7:
        q_t = q.transpose(1, 2).contiguous()
        b, n, t, d = q_t.shape
        limit, scale = pos + t, 1.0 / d**0.5
        check(da.kernel_route(q_t.dtype, d) == "sm90", f"beam K7 inputs off the sm90 route: {q_t.dtype}")
        got = da.flash_decode(q_t, k, v, limit, vf, scale)
        ref = da.decode_attention_plain(q_t, k, v, limit, vf, da.decode_block(k.shape[2]), scale,
                                        None, None)
        check(bool(torch.isfinite(got).all()), "beam K7 output not finite")
        errs.append((got.float() - ref.float()).abs().max().item())
    err = max(errs)
    kind = str(q_t.dtype).split(".")[1]
    check(len(errs) == N_LAYERS and err <= TOL[kind],
          f"beam K7 {kind} vs plain over {len(errs)} layers: max |err| {err} > {TOL[kind]}")
    ms = event_ms(torch, lambda: da.flash_decode(q_t, k, v, limit, vf, scale), 20)
    plain_ms = event_ms(torch, lambda: da.decode_attention_plain(
        q_t, k, v, limit, vf, da.decode_block(k.shape[2]), scale, None, None), 5)
    mask = torch.arange(limit, device="cuda")[None, None, None, :] >= vf[:, None, None, None]
    kk, vv = k[:, :, :limit], v[:, :, :limit]
    library_ms = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q_t, kk, vv, attn_mask=mask), 20)
    bound_ms, bound_by = bound(kind, b, n, t, d, limit, vf.tolist())
    return {"kind": kind, "b": b, "n": n, "t": t, "d": d, "L": k.shape[2], "limit": limit,
            "layers": len(errs),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_text(torch, env, ckpt):
    """Phase 21: (a) phase 13's checkpoint served with text on both
    schedulers, (b) with beam search, (c) a converted HF GPT-2-medium."""
    import dataclasses
    import shutil
    import tempfile

    import torch.nn.functional as F

    from paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.models.gpt import model as pm
    from paddlefleetx_tpu_torch.ops import decode_attention as da
    from paddlefleetx_tpu_torch.utils.checkpoint import restore_params

    tmp = tempfile.mkdtemp(prefix="smoke_text_")
    servers = []
    report = {}
    try:
        t0 = time.time()
        tok_dir = write_tokenizer(os.path.join(tmp, "tok"))
        tok = GPTTokenizer.from_pretrained(tok_dir)
        texts = [smoke_text(100 + i, 6 + 3 * i) for i in range(TEXT_PROMPTS)]
        ids = [tok.encode(t) for t in texts]
        check(all(tok.decode(i) == t for i, t in zip(ids, texts)), "decode(encode(text)) != text")
        check(all(0 < len(i) <= 64 for i in ids), f"prompt lengths {[len(i) for i in ids]}")
        hf_dir = write_hf_gpt2_medium(os.path.join(tmp, "hf"), seed=21)
        log(f"  tokenizer ({len(tok.bpe_ranks)} merges, prompts of {[len(i) for i in ids]} "
            f"tokens) and the HF directory written in {time.time() - t0:.1f}s")
        conv_dir = os.path.join(tmp, "conv")
        conv = subprocess.Popen(
            [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.convert_hf_gpt2", "--model",
             hf_dir, "-o", conv_dir, "--pad-vocab-to", "50304"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        base = ["-o", f"Engine.save_load.ckpt_dir={ckpt}", "-o", f"Generation.tokenizer_dir={tok_dir}",
                "-o", f"Generation.max_dec_len={MAX_NEW}"]
        greedy = ["-o", "Generation.decode_strategy=greedy_search"]
        coal = start_serve(env, "text coalesce", base + greedy)
        cont = start_serve(env, "text continuous", base + greedy + ["--scheduler", "continuous"])
        beam = start_serve(env, "text beam", base + ["-o", "Generation.decode_strategy=beam_search"])
        servers += [coal, cont, beam]
        model, mcfg = load_served_model(torch, ckpt)
        conv_out, _ = conv.communicate(timeout=600)
        check(conv.returncode == 0, f"convert_hf_gpt2 exit {conv.returncode}: {conv_out[-3000:]}")
        conv_args = ["-o", f"Engine.save_load.ckpt_dir={conv_dir}",
                     "-o", f"Generation.max_dec_len={MAX_NEW}"]
        conv_srv = start_serve(env, "converted", conv_args + greedy)
        conv_beam = start_serve(env, "converted beam",
                                conv_args + ["-o", "Generation.decode_strategy=beam_search"])
        servers += [conv_srv, conv_beam]

        # (a) coalescing: text in, text out, tokens equal in-process generate
        wait_serve(coal)
        batch = http(coal["port"], "/generate", {"prompts": texts, "max_tokens": MAX_NEW})
        singles = [http(coal["port"], "/generate", {"prompt": t, "max_tokens": MAX_NEW})
                   for t in texts[:2]]
        frames = post_stream(coal["port"], {"prompt": texts[2], "max_tokens": MAX_NEW}, {})
        k_coal = http(coal["port"], "/healthz")["kernels"]
        want8 = in_process_greedy(torch, G, model, ids)
        want1 = [in_process_greedy(torch, G, model, [i])[0] for i in ids[:3]]
        check(batch["completions"] == [tok.decode(r) for r in want8],
              "coalescing: served text differs from in-process generate at batch 8")
        check([s["completion"] for s in singles] == [tok.decode(r) for r in want1[:2]],
              "coalescing: served text differs from in-process generate at batch 1")
        toks = stream_answer(frames, "coalescing stream")
        check(toks == want1[2] and all(d["text"] == tok.decode(d["tokens"])
                                       for e, d in frames if e == "token")
              and "".join(d["text"] for e, d in frames if e == "token") == tok.decode(want1[2]),
              f"coalescing stream: {frames[:3]}")
        check(k_coal["plain"] == 0 and k_coal["flash_decode"] > 0
              and k_coal["flash_decode_sm90"] == k_coal["flash_decode"],
              f"coalescing: K7 off the sm90 route or plain: {k_coal}")

        # (a) continuous: streamed text requests arriving while others
        # decode; every token within SPEC_ULPS bf16 ulps of its prefix's argmax
        wait_serve(cont)
        streams = {}

        def post_cont(i):
            streams[i] = post_stream(cont["port"], {"prompt": texts[i], "max_tokens": MAX_NEW}, {})

        threads = [threading.Thread(target=post_cont, args=(i,)) for i in range(len(texts))]
        for th in threads:
            th.start()
            time.sleep(0.05)
        for th in threads:
            th.join(timeout=600)
        check(len(streams) == len(texts), f"continuous: {len(streams)} answers")
        answers = []
        for i in range(len(texts)):
            toks = stream_answer(streams[i], f"continuous stream {i}")
            frames = [d for e, d in streams[i] if e == "token"]
            check(all(d["text"] == tok.decode(d["tokens"]) for d in frames)
                  and "".join(d["text"] for d in frames) == tok.decode(toks),
                  f"continuous stream {i}: text fields {frames[:3]}")
            answers.append(toks)
        again = http(cont["port"], "/generate", {"prompt": texts[0], "max_tokens": MAX_NEW})
        check(again["completion"] == tok.decode(answers[0]),
              f"continuous: {again['completion']!r} vs the stream's {tok.decode(answers[0])!r}")
        k_cont = http(cont["port"], "/healthz")["kernels"]
        worst = max([0.0] + [d for i in range(len(texts)) if answers[i]
                             for d in greedy_deficits(torch, G, model, mcfg, ids[i], answers[i], "")])
        check(worst <= SPEC_ULPS, f"continuous: a token sits {worst:.1f} bf16 ulps under its "
                                  f"prefix's argmax (gate {SPEC_ULPS})")
        check(k_cont["plain"] == 0 and k_cont["paged_plain"] == 0 and k_cont["paged_decode"] > 0
              and k_cont["paged_decode_sm90"] == k_cont["paged_decode"]
              and k_cont["flash_decode_sm90"] == k_cont["flash_decode"] > 0,
              f"continuous: K7/K9 off the sm90 route or plain: {k_cont}")
        report["a"] = {"coalesce_kernels": k_coal, "continuous_kernels": k_cont,
                       "continuous_worst_deficit_ulps": worst,
                       "boot_s": [round(coal["boot_s"], 1), round(cont["boot_s"], 1)]}
        log(f"  (a) text served: coalescing answers equal in-process generate (batch 8 and 1), "
            f"continuous within {worst:.2f} bf16 ulps; streams join to their completions; "
            f"K7 coalescing {k_coal['flash_decode']}, continuous K9 {k_cont['paged_decode']} + "
            f"K7 prefills {k_cont['flash_decode']}, all sm90, 0 plain")
        stop_serve(coal)
        stop_serve(cont)

        # (b) beam search over the 8 prompts, b * num_beams = 32 rows: every K7
        # launch on the sm90 route, 24 a forward; every step's choices those
        # of the plain forward up to SPEC_ULPS bf16 ulps; K7 on one step's
        # reordered cache against its plain version; each beam re-scored by
        # a float32 plain forward no lower than greedy's answer
        wait_serve(beam)
        served = http(beam["port"], "/generate", {"prompts_ids": ids, "max_tokens": MAX_NEW})
        k_beam = http(beam["port"], "/healthz")["kernels"]
        want = N_LAYERS * MAX_NEW  # the prefill and MAX_NEW - 1 steps, a launch a layer
        check(k_beam["flash_decode"] == k_beam["flash_decode_sm90"] == want
              and k_beam["flash_decode_sm90_prefill"] == N_LAYERS and k_beam["plain"] == 0,
              f"beam: K7 launches {k_beam}, expected {want}, all sm90")
        stop_serve(beam)
        beams = served["completions_ids"]
        gen_b = G.GenerationConfig(max_dec_len=MAX_NEW, decode_strategy="beam_search",
                                   num_beams=TEXT_BEAMS, eos_token_id=50256, pad_token_id=0)
        inproc, rec, k7 = beam_traced(torch, G, model, ids, gen_b)
        check(beams == inproc, "beam: served tokens differ from in-process beam search at batch 8")
        held = beam_kernel_case(torch, F, da, k7)
        del k7
        c16 = dataclasses.replace(mcfg, attn_impl="xla")
        replay = dict(zip(("worst_ulps", "near_ties", "reordered_rows"),
                          beam_deficits(torch, G, pm, model, c16, ids, gen_b, rec)))
        del rec
        check(replay["worst_ulps"] <= SPEC_ULPS,
              f"beam: a kept continuation sits {replay['worst_ulps']:.1f} bf16 ulps under the "
              f"plain forward's choice (gate {SPEC_ULPS}): {replay}")
        greedy8 = want8
        # the same margins under the served bf16 model's own plain forward
        margins_bf16 = [norm_score(torch, pm, model, c16, ids[i], beams[i])
                        - norm_score(torch, pm, model, c16, ids[i], greedy8[i])
                        for i in range(len(ids))]
        del model
        m32, c32 = load_served_model(torch, ckpt, ["Model.dtype=float32", "Model.attn_impl=xla"])
        margins = [norm_score(torch, pm, m32, c32, ids[i], beams[i])
                   - norm_score(torch, pm, m32, c32, ids[i], greedy8[i]) for i in range(len(ids))]
        del m32
        check(min(margins) >= -BEAM_SCORE_SLACK,
              f"beam: a beam's float32 score is under greedy's by {-min(margins):.3e} nats a "
              f"token (slack {BEAM_SCORE_SLACK}): margins {margins}")
        same = sum(b == g for b, g in zip(beams, greedy8))
        # float32 beam at PFX_F32_LAYERS layers: the card (K7's CUDA-core
        # route) against the CPU (plain)
        from paddlefleetx_tpu_torch.core.module import GPTModule
        from paddlefleetx_tpu_torch.utils.config import get_config

        cfg4 = get_config(str(REPO / CONFIG), ["Model.dtype=float32",
                                               f"Model.num_layers={PFX_F32_LAYERS}"])
        mod4 = GPTModule(cfg4)
        gen4 = G.GenerationConfig(max_dec_len=TEXT_F32_NEW, decode_strategy="beam_search",
                                  num_beams=TEXT_BEAMS, eos_token_id=50256, pad_token_id=0)
        f32_beams = {}
        for dev in ("cuda", "cpu"):
            m4 = mod4.init_model(cfg4.Global.seed, dev)
            ids4, lens4 = G.pad_prompts(ids, 0, 64, torch.device(dev))
            f32_beams[dev] = G.generate(m4, ids4, gen4, prompt_lens=lens4).cpu()
            del m4
        check(torch.equal(f32_beams["cuda"], f32_beams["cpu"]),
              "float32 beam search: card and CPU tokens differ")
        report["b"] = {"kernels": k_beam, "rows": len(ids) * TEXT_BEAMS, "steps": MAX_NEW - 1,
                       "margins": margins, "margins_bf16": margins_bf16,
                       "identical_to_greedy": same, "replay": replay, "held": held,
                       "boot_s": round(beam["boot_s"], 1)}
        log(f"  (b) beam search, {TEXT_BEAMS} beams x {len(ids)} prompts: served tokens equal "
            f"in-process beam search, K7 {k_beam['flash_decode']} launches ({N_LAYERS} x {MAX_NEW}) "
            f"all sm90, 0 plain; every step's choices the plain forward's within "
            f"{replay['worst_ulps']:.2f} bf16 ulps ({replay['near_ties']} near ties); K7 on step "
            f"{BEAM_CAPTURE_STEP}'s cache ({replay['reordered_rows']} rows moved) vs plain over "
            f"{held['layers']} layers max |err| {held['max_abs_err']:.3e}, {held['ms']:.4f} ms; "
            f"float32 re-scored margin over greedy min {min(margins):.4e} "
            f"max {max(margins):.4e} nats/token ({same} of {len(ids)} equal to greedy); "
            f"float32 beam at {PFX_F32_LAYERS} layers card == CPU")

        # (c) the converted HF GPT-2-medium: first-step logits card against
        # CPU at float32, served greedy tokens against in-process generate
        wait_serve(conv_srv)
        cids = prompts(21, [30, 40])
        c_batch = http(conv_srv["port"], "/generate", {"prompts_ids": cids, "max_tokens": MAX_NEW})
        c_one = http(conv_srv["port"], "/generate", {"prompt_ids": cids[0], "max_tokens": MAX_NEW})
        k_conv = http(conv_srv["port"], "/healthz")["kernels"]
        stop_serve(conv_srv)
        # and its beam search over the text prompts, where beams part from
        # greedy: served tokens those of beam search here, every step's
        # choices the plain forward's up to SPEC_ULPS bf16 ulps
        wait_serve(conv_beam)
        c_beams = http(conv_beam["port"], "/generate",
                       {"prompts_ids": ids, "max_tokens": MAX_NEW})["completions_ids"]
        k_cbeam = http(conv_beam["port"], "/healthz")["kernels"]
        stop_serve(conv_beam)
        cmodel, ccfg = load_served_model(torch, conv_dir)
        check(c_batch["completions_ids"] == in_process_greedy(torch, G, cmodel, cids)
              and c_one["completion_ids"] == in_process_greedy(torch, G, cmodel, cids[:1])[0],
              "converted: served tokens differ from in-process generate")
        check(k_conv["plain"] == 0 and k_conv["flash_decode_sm90"] == k_conv["flash_decode"] > 0,
              f"converted: K7 off the sm90 route or plain: {k_conv}")
        check(k_cbeam["flash_decode"] == k_cbeam["flash_decode_sm90"] == want
              and k_cbeam["plain"] == 0, f"converted beam: K7 launches {k_cbeam}, expected {want}")
        c_in, c_rec, _ = beam_traced(torch, G, cmodel, ids, gen_b)
        check(c_beams == c_in, "converted beam: served tokens differ from in-process beam search")
        cx = dataclasses.replace(ccfg, attn_impl="xla")
        c_replay = dict(zip(("worst_ulps", "near_ties", "reordered_rows"),
                            beam_deficits(torch, G, pm, cmodel, cx, ids, gen_b, c_rec)))
        del c_rec
        check(c_replay["worst_ulps"] <= SPEC_ULPS,
              f"converted beam: a kept continuation sits {c_replay['worst_ulps']:.1f} bf16 ulps "
              f"under the plain forward's choice (gate {SPEC_ULPS}): {c_replay}")
        c_greedy = in_process_greedy(torch, G, cmodel, ids)
        c_differ = sum(b != g for b, g in zip(c_beams, c_greedy))
        c_margins = [norm_score(torch, pm, cmodel, cx, ids[i], c_beams[i])
                     - norm_score(torch, pm, cmodel, cx, ids[i], c_greedy[i])
                     for i in range(len(ids))]
        del cmodel
        check(c_differ > 0, "converted beam: every beam equals greedy's answer, so no "
                            "served choice off the greedy path was replayed")
        params = restore_params(conv_dir)
        check(tuple(params["embeddings.word"].shape) == (50304, HF_GPT2_MEDIUM["n_embd"])
              and not params["embeddings.word"][50257:].any(), "converted: vocab padding")
        firsts = {}
        cpids, cplens = G.pad_prompts(cids, 0, 64)
        for dev in ("cuda", "cpu"):
            m, c = load_served_model(torch, conv_dir, ["Model.dtype=float32"], dev)
            with torch.inference_mode():
                cache = G.init_cache(c, 2, 64 + 1, torch.device(dev))
                pad_len, pos_ids = G._left_pad_prefill(64, cplens.to(dev))
                lg = G.forward_cached(m, cpids.to(dev), cache, 0, position_ids=pos_ids,
                                      kv_valid_from=pad_len)
            firsts[dev] = lg[:, -1].float().cpu()
            del m
        err = (firsts["cuda"] - firsts["cpu"]).abs().max().item()
        check(err <= 1e-3, f"converted: first-step logits card vs cpu max |err| {err} > 1e-3")
        report["c"] = {"kernels": k_conv, "first_step_err": err,
                       "boot_s": [round(conv_srv["boot_s"], 1), round(conv_beam["boot_s"], 1)],
                       "beam": {"kernels": k_cbeam, "replay": c_replay,
                                "differ_from_greedy": c_differ, "margins_bf16": c_margins}}
        log(f"  (c) converted GPT-2-medium (vocab 50257 padded to 50304): served tokens equal "
            f"in-process generate, K7 {k_conv['flash_decode']} launches all sm90, first-step "
            f"logits card vs cpu at float32 max |err| {err:.3e}; beam search: served equals "
            f"in-process, {c_differ} of {len(ids)} answers differ from greedy, every step's "
            f"choices the plain forward's within {c_replay['worst_ulps']:.2f} bf16 ulps "
            f"({c_replay['near_ties']} near ties), bf16 margin over greedy min "
            f"{min(c_margins):.4e} max {max(c_margins):.4e}, K7 {k_cbeam['flash_decode']} all sm90")
        log("text_serving " + json.dumps(report))
        return report
    finally:
        for srv in servers:
            kill_serve(srv)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phases 22-25: the rest of GPT training (float16 and its loss scaling,
# the memory levers, chunked CE, the worker loader, async saves, eval)
# ---------------------------------------------------------------------------


def phase_f16_kernels(torch, F, fa, fl, flash_rows, ln_rows):
    """K1-K6 in float16 against their plain versions at phase 10's shapes
    (b*h = 8 x 16, s = 1024, d = 64) and 8192 x 1024 LayerNorm rows, with
    and without a residual; the bf16 kernel's time at the same shape
    beside each float16 time."""
    rows, split = flash_case(torch, F, fa, "float16", TRAIN_MICRO, 16, TRAIN_SEQ, 64, pair=True)
    ln = ln_case(torch, F, fl, "float16", 8192, 1024, False)
    ln_res = ln_case(torch, F, fl, "float16", 8192, 1024, True)
    out = {}
    for name, row in {**rows, **ln}.items():
        check(row.get("route", "sm90") == "sm90", f"{name} float16 route {row.get('route')}")
        bf16 = (flash_rows if name.startswith("flash") else ln_rows)[name]
        out[f"{name}_f16"] = dict(row, bf16_ms=bf16["ms"])
        log(f"  {name:16s} float16 s/rows {row.get('s', row.get('rows'))}: err "
            f"{row['max_abs_err']:.2e} (row {row.get('row_err', 0.0):.2e}, differ "
            f"{row.get('differ', 0.0):.2e}) kernel {row['ms']:.4f} ms (bf16 {bf16['ms']:.4f}) "
            f"plain {row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
    for name, row in ln_res.items():
        log(f"  {name:16s} float16 8192x1024 res=True: err {row['max_abs_err']:.2e} kernel "
            f"{row['ms']:.4f} ms library {row['library_ms']:.4f}")
    log(f"  K4 + K5 float16: {split['ms']:.4f} ms, SDPA backward {split['library_ms']:.4f} ms")
    log("f16_kernels " + json.dumps({"rows": out, "split_pair": split,
                                      "ln_residual": ln_res}))
    return out


# phase 23: the float16 train CLI (scale 2**15 growing every 4 finite steps)
F16_CLI = ("Model.dtype=float16", "Engine.mix_precision.dtype=float16",
           'Engine.mix_precision.scale_loss={"init": 32768.0, "incr_every_n_steps": 4}',
           "Data.Train.loader.num_workers=2", "Engine.save_load.async_save=True")
F16_INIT, F16_INCR = 32768.0, 4
# phase 23: float16 card against the CPU at F16_CPU_LAYERS layers of the full
# width and F16_CPU_SEQ tokens (float16 products are slow on the H100
# host's CPU: 4 layers took 58 s, 2 layers 19-39 s; phases 29 and 30 are
# paid for by cutting the depth); the losses agree within F16_CPU_TOL,
# relative
F16_CPU_TOL, F16_CPU_SEQ, F16_CPU_LAYERS = 1e-3, 32, 1


def scale_trajectory(records):
    """The loss scale each step should end with, from the records' own
    found_inf (the engine's rule: grow x2 after F16_INCR finite steps in a
    row, halve on an overflow, never below 1)."""
    scale, good, out = F16_INIT, 0, []
    for r in records:
        if r["found_inf"]:
            scale, good = max(scale / 2, 1.0), 0
        else:
            good += 1
            if good >= F16_INCR:
                scale, good = scale * 2, 0
        out.append(scale)
    return out


def phase_f16_train(torch, fa, fl, env, cli_data):
    """The float16 train CLI at 345M with the worker loader and async
    saves against phase 13's inline-loader run, its resume from the async
    checkpoint, a bare overflowing step, and the step card against CPU."""
    import shutil
    import tempfile

    import numpy as np

    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.utils.config import get_config

    tmp = tempfile.mkdtemp(prefix="smoke_f16_")
    try:
        out_dir = os.path.join(tmp, "out")
        first, wall, out = train_cli(env, cli_data["data_dir"], out_dir, F16_CLI)
        check([r["step"] for r in first] == list(range(1, CLI_STEPS + 1)),
              f"float16 CLI records: {[r.get('step') for r in first]}")
        want_scale = scale_trajectory(first)
        for r, digest, scale in zip(first, cli_data["digests"], want_scale):
            evals = CLI_EVAL_ITERS if r["step"] > 1 and (r["step"] - 1) % CLI_EVAL_FREQ == 0 else 0
            ok, want = cli_launches_ok(r, evals)
            check(ok, f"float16 step {r['step']} launches {r['kernels']}, expected {want}")
            check(r["tokens_digest"] == digest, f"float16 step {r['step']}: the worker "
                  f"loader's batch differs from phase 13's inline loader's")
            check(r["loss_scale"] == scale, f"float16 step {r['step']}: loss_scale "
                  f"{r['loss_scale']}, the rule gives {scale}")
        losses = [r["loss"] for r in first]
        check(all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3]),
              f"float16 CLI loss did not fall: {losses}")
        check(sum(r["found_inf"] for r in first) <= 2, f"float16 CLI overflows: {first}")
        for step in (CLI_SAVE, CLI_STEPS):
            with open(os.path.join(out_dir, f"step_{step}", "meta.json")) as f:
                meta = json.load(f)
            check(meta["loss_scale"] == first[step - 1]["loss_scale"]
                  and meta["consumed_samples"] == TRAIN_GLOBAL * step,
                  f"async checkpoint step_{step}: {meta}")
        check("saved checkpoint (async)" in out, "no async save in the float16 CLI run")
        launches = {k: sum(r["kernels"][k] for r in first)
                    for k in ("fused_ln_fwd", "fused_ln_bwd", "flash_fwd", "flash_bwd_fused")}
        log(f"  float16 train CLI: {CLI_STEPS} steps in {wall:.1f}s wall, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, loss_scale {[r['loss_scale'] for r in first]}, "
            f"found_inf {[r['found_inf'] for r in first]}, median step "
            f"{sorted(r['step_s'] for r in first[1:])[(len(first) - 1) // 2] * 1e3:.1f} ms, "
            f"peak {max(r['mem']['device_peak_bytes'] for r in first) / 2**30:.2f} GiB, "
            f"batches equal phase 13's, launches {launches}")
        shutil.rmtree(os.path.join(out_dir, f"step_{CLI_STEPS}"))
        os.rename(os.path.join(out_dir, "metrics.jsonl"), os.path.join(tmp, "first.jsonl"))
        second, wall2, out2 = train_cli(env, cli_data["data_dir"], out_dir,
                                        (*F16_CLI, "Engine.save_load.auto_resume=True"))
        check(f"loaded checkpoint: {os.path.join(out_dir, f'step_{CLI_SAVE}')}" in out2,
              f"float16 resume did not load step_{CLI_SAVE}: {out2[-3000:]}")
        diffs = []
        for a, b in zip(first[CLI_SAVE:], second):
            check(a["tokens_digest"] == b["tokens_digest"] and a["loss_scale"] == b["loss_scale"],
                  f"float16 resumed step {b['step']}: {a} vs {b}")
            diffs.append(abs(a["loss"] - b["loss"]) / abs(a["loss"]))
        check(len(second) == CLI_STEPS - CLI_SAVE and max(diffs) <= RESUME_LOSS_TOL,
              f"float16 resumed losses differ by {diffs} > {RESUME_LOSS_TOL}")
        log(f"  float16 resume from the async step_{CLI_SAVE}: loss_scale restored "
            f"({second[0]['loss_scale']}), same batches, losses within {max(diffs):.2e}")

        # a bare step at scale 2**31 overflows: skipped, scale halved, params bitwise
        # unchanged; the split schedule, so K4 and K5 run in float16 too
        batch = host_batch(np, TRAIN_GLOBAL, TRAIN_SEQ, seed=3)
        cfg = train_config(get_config, ["Model.dtype=float16", "Engine.mix_precision.dtype=float16",
                                        "Engine.mix_precision.scale_loss=2147483648.0",
                                        "Model.flash_bwd=split", "Model.use_fused_ln=True"])
        engine = Engine(cfg, GPTModule(cfg))
        before = {n: p.detach().clone() for n, p in engine.params.items()}
        fa.reset_counts()
        fl.reset_counts()
        m = engine.train_step(batch)
        bare = {**fa.COUNTS, **fl.COUNTS}
        same = all(torch.equal(p, before[n]) for n, p in engine.params.items())
        check(m["found_inf"] == 1.0 and m["loss_scale"] == 2.0**30 and same
              and engine.opt_state[1]["count"] == 0,
              f"float16 step at scale 2**31: {m}, params unchanged {same}")
        per_step = 2 * N_LAYERS
        check(bare["flash_fwd"] == bare["flash_bwd_dq"] == bare["flash_bwd_dkv"] == per_step
              and bare["flash_bwd_fused"] == 0
              and all(bare[f"{k}_sm90"] == bare[k] for k in fa.KERNELS)
              and bare["fused_ln_fwd"] == 2 * (4 * N_LAYERS + 1)
              and bare["fused_ln_bwd"] == 2 * (2 * N_LAYERS + 1)
              and bare["flash_plain"] == bare["fused_ln_fwd_plain"] == 0,
              f"float16 split step launches {bare}")
        del engine, before
        torch.cuda.empty_cache()
        log(f"  float16 step at scale 2**31: found_inf 1, loss_scale {m['loss_scale']:.0f}, params "
            f"bitwise unchanged; launches {bare}")

        # the float16 step, card against CPU: F16_CPU_LAYERS of the full width
        cfg4 = get_config(str(REPO / CONFIG), [
            "Global.global_batch_size=1", "Global.local_batch_size=1",
            "Global.micro_batch_size=1", f"Model.num_layers={F16_CPU_LAYERS}",
            "Model.dtype=float16",
            "Engine.mix_precision.dtype=float16", "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.0", "Model.attn_impl=flash",
            "Model.flash_bwd=fused", "Model.use_fused_ln=True",
            'Optimizer.lr={"name": "Constant", "learning_rate": 1.0e-4}'])
        batch4 = host_batch(np, 1, F16_CPU_SEQ, seed=4)
        t0 = time.time()
        res = {dev: Engine(cfg4, GPTModule(cfg4), device=dev).train_step(batch4)
               for dev in ("cpu", "cuda")}
        cpu_s = time.time() - t0
        err = abs(res["cuda"]["loss"] - res["cpu"]["loss"]) / abs(res["cpu"]["loss"])
        check(err <= F16_CPU_TOL and res["cuda"]["found_inf"] == res["cpu"]["found_inf"] == 0.0
              and res["cuda"]["loss_scale"] == res["cpu"]["loss_scale"],
              f"float16 step card vs cpu: {res} ({err} relative)")
        log(f"  float16 step card vs cpu, {F16_CPU_LAYERS} layers, seq {F16_CPU_SEQ} "
            f"({cpu_s:.1f}s): loss "
            f"{res['cuda']['loss']:.6f} vs "
            f"{res['cpu']['loss']:.6f} (rel {err:.2e}), grad_norm {res['cuda']['grad_norm']:.4f} "
            f"vs {res['cpu']['grad_norm']:.4f}")
        # the resumed run's final float16 checkpoint is what phase 27 serves
        ckpt = shutil.move(os.path.join(out_dir, f"step_{CLI_STEPS}"), keep_dir("smoke_f16_ckpt_"))
        report = {"first": first, "resumed": second, "wall_s": wall, "resume_wall_s": wall2,
                  "resume_loss_rel_diff": diffs, "bare_split_launches": bare,
                  "card_vs_cpu_rel": err, "launches": launches, "ckpt": ckpt}
        log("f16_train " + json.dumps(report))
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 24: the memory levers, each a few steps at 345M beside the default
LEVERS = {"default": (), "main_grad_off": ("Engine.mix_precision.main_grad=False",),
          "bf16_moments": ("Optimizer.moment_dtype=bfloat16",),
          "multi_precision_off": ("Optimizer.multi_precision=False",),
          "chunked_ce": ("Model.use_chunked_ce=True",)}
LEVER_STEPS = 2
CHUNKED_CE_TOL = 1e-3


def phase_levers(torch, fa, fl):
    import numpy as np

    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.utils.config import get_config

    batch = host_batch(np, TRAIN_GLOBAL, TRAIN_SEQ, seed=5)
    out = {}
    for name, extra in LEVERS.items():
        cfg = train_config(get_config, ["Model.flash_bwd=fused", "Model.use_fused_ln=True",
                                        *extra])
        engine = Engine(cfg, GPTModule(cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        fl.reset_counts()
        losses, step_s = [], []
        for _ in range(LEVER_STEPS):
            t0 = time.perf_counter()
            m = engine.train_step(batch)
            step_s.append(time.perf_counter() - t0)
            check(m["found_inf"] == 0.0 and np.isfinite(m["loss"]), f"{name}: {m}")
            losses.append(m["loss"])
        used = {**fa.COUNTS, **fl.COUNTS}
        check(used["flash_plain"] == used["fused_ln_fwd_plain"] == 0
              and used["flash_bwd_fused_sm90"] == LEVER_STEPS * 2 * N_LAYERS,
              f"{name}: launches {used}")
        params = {str(p.dtype) for p in engine.params.values()}
        mu = {str(t.dtype) for t in engine.opt_state[1]["mu"].values()}
        grads = ({str(p.dtype) for p in engine._grad_model.parameters()}
                 if engine._grad_model is not None else set())
        want = {"main_grad_off": grads == {"torch.bfloat16"},
                "bf16_moments": mu == {"torch.bfloat16"} and params == {"torch.float32"},
                "multi_precision_off": params == mu == {"torch.bfloat16"}}.get(name, True)
        check(want, f"{name}: params {params}, mu {mu}, grad copies {grads}")
        out[name] = {"losses": losses, "peak_bytes": torch.cuda.max_memory_allocated(),
                     "step_ms": [x * 1e3 for x in step_s], "params": sorted(params),
                     "mu": sorted(mu)}
        del engine
        torch.cuda.empty_cache()
    base = out["default"]
    err = abs(out["chunked_ce"]["losses"][0] - base["losses"][0]) / base["losses"][0]
    check(err <= CHUNKED_CE_TOL, f"chunked CE first-step loss {out['chunked_ce']['losses'][0]} vs "
                                 f"plain CE {base['losses'][0]} ({err} relative)")
    check(out["multi_precision_off"]["peak_bytes"] < base["peak_bytes"],
          f"multi_precision=False did not lower the peak: {out}")
    for name, row in out.items():
        log(f"  {name:20s}: peak {row['peak_bytes'] / 2**30:.2f} GiB (default "
            f"{base['peak_bytes'] / 2**30:.2f}), losses {[round(x, 4) for x in row['losses']]}, "
            f"steps {[round(x, 1) for x in row['step_ms']]} ms, params {row['params']}, "
            f"mu {row['mu']}")
    log(f"  chunked CE first-step loss {out['chunked_ce']['losses'][0]:.6f} vs plain CE "
        f"{base['losses'][0]:.6f} (rel {err:.2e})")
    log("memory_levers " + json.dumps(dict(out, chunked_ce_rel=err)))
    return out


# phase 25: the eval CLI over phase 13's step_12
EVAL_ITERS = 2


def eval_overrides(ckpt, data_dir):
    return [f"Global.global_batch_size={TRAIN_GLOBAL}", f"Global.local_batch_size={TRAIN_GLOBAL}",
            f"Global.micro_batch_size={TRAIN_MICRO}", "Model.module=GPTEvalModule",
            "Model.attn_impl=flash", "Model.use_fused_ln=True",
            f"Engine.save_load.ckpt_dir={ckpt}", f"Data.Eval.dataset.input_dir={data_dir}",
            f"Engine.eval_iters={EVAL_ITERS}"]


def phase_eval(torch, fa, fl, ckpt, cli_data):
    """tools/eval.py on the card over phase 13's final checkpoint and the
    Eval split of its corpus, against Engine.evaluate run here on the same
    params: the same loss, ppl = exp(loss) (every token counts), K3 24 and
    K1 49 launches a batch, all on the card's routes, no plain call."""
    import shutil

    import numpy as np

    from paddlefleetx_tpu_torch.core.engine import Engine
    from paddlefleetx_tpu_torch.core.module import build_module
    from paddlefleetx_tpu_torch.data.builders import build_dataloader
    from paddlefleetx_tpu_torch.utils.config import get_config

    try:
        overrides = eval_overrides(ckpt, cli_data["data_dir"])
        cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.eval", "-c", CONFIG]
        for o in overrides:
            cmd += ["-o", o]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                              capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        check(proc.returncode == 0, f"eval CLI exit {proc.returncode}: "
                                    f"{(proc.stdout + proc.stderr)[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        cfg = get_config(str(REPO / CONFIG), overrides)
        engine = Engine(cfg, build_module(cfg))
        engine.load(ckpt)
        fa.reset_counts()
        fl.reset_counts()
        loss = engine.evaluate(build_dataloader(cfg, "Eval"), iters=EVAL_ITERS)
        used = {**fa.COUNTS, **fl.COUNTS}
        metric = engine.last_metric.accumulate()
        check(abs(res["eval_loss"] - loss) <= 1e-6 * abs(loss),
              f"eval CLI loss {res['eval_loss']} vs in-process evaluate {loss}")
        check(abs(res["metric"]["ppl"] - metric["ppl"]) <= 1e-5 * metric["ppl"]
              and abs(metric["ppl"] - float(np.exp(loss))) <= 1e-4 * metric["ppl"]
              and 0.0 <= res["metric"]["acc"] <= 1.0, f"eval metric {res} vs {metric}")
        want = dict.fromkeys(used, 0)
        want.update(flash_fwd=N_LAYERS * EVAL_ITERS, flash_fwd_sm90=N_LAYERS * EVAL_ITERS,
                    fused_ln_fwd=(2 * N_LAYERS + 1) * EVAL_ITERS)
        check(used == want, f"eval launches {used}, expected {want}")
        log(f"  eval CLI over step_{CLI_STEPS}: loss {res['eval_loss']:.6f} (in-process "
            f"{loss:.6f}), ppl {res['metric']['ppl']:.2f}, acc {res['metric']['acc']:.4f}, "
            f"{EVAL_ITERS} batches of {TRAIN_GLOBAL}, {wall:.1f}s wall; launches {used}")
        report = {"cli": res, "in_process_loss": loss, "wall_s": wall, "launches": used}
        log("eval_cli " + json.dumps(report))
        return report
    finally:
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)



# ---------------------------------------------------------------------------
# phases 26-27: serving a float16 model (K7, K8 and K9 on their float16
# routes)
# ---------------------------------------------------------------------------

# phase 26: (entry, cache kind, q kind): K7 over float16 caches, K8 over
# int8 caches under float16 q; K9 over float16 and over int8 pools
F16_DECODE = (("flash_decode_f16", "float16", None), ("flash_decode_q8_f16", "int8", "float16"))
F16_PAGED = (("paged_decode_f16", "float16", None), ("paged_decode_q8_f16", "int8", "float16"))
# phase 27: an answer token's logit under its prefix's argmax, in float16
# ulps of the argmax (8x finer than bf16's at the same magnitude: SPEC_ULPS'
# 4 bf16 ulps would be 32 here).  The first run read 0.0 for every served
# token and 0.002 for beam search's one near tie (PERF.md): float16 moves
# the logits 8x less than bf16 does, so a flip at a near tie costs a few
# float16 ulps at most, and a wrong token sits far below; the gate is one
# bf16 ulp
F16_ULPS = 8.0


def log_f16(row, paged=False):
    if paged:
        log_paged("float16", row)
    else:
        log_case(row)
    log(f"    the bf16 kernel at this shape in this run: {row['bf16_ms']:.4f} ms")


def phase_f16_decode_kernels(torch, F, da, main_rows, paged_rows, verify_rows, chunk_rows):
    """K7, K8 and K9 under float16 q against their plain versions at the
    bf16 rows' shapes, each with the bf16 kernel's time of the same run
    beside it: K7 (float16 caches) and K8 (int8 caches) at request D's
    decode step, its prefill (t = 64) and the verify chunk (t = 5 and 17);
    K9 (float16 and int8 pools) at phase 7's decode step, its verify chunk
    (t = 5) and a chunk of t = 256 over a 512-token cached prefix.  Every
    launch on the sm90 route and counted in ``*_f16``; NaN past the limit
    (and in the null block and past each row's bound) leaves each output
    bitwise unchanged, and a repeat call gives the same bits."""
    out = {}
    for name, kind, q_kind in F16_DECODE:
        base = name[:-4]
        row = kernel_case(torch, F, da, kind, *main_path_shape(), iters=50, q_kind=q_kind)
        row["bf16_ms"] = main_rows[base]["ms"]
        pre = kernel_case(torch, F, da, kind, *main_prefill_shape(), iters=50, q_kind=q_kind)
        pre["bf16_ms"] = main_rows[base]["prefill"]["ms"]
        row["prefill"], row["verify"] = pre, []
        for t in (SPEC_K + 1, 17):
            v = kernel_case(torch, F, da, kind, *verify_shape(t), iters=50, q_kind=q_kind)
            v["bf16_ms"] = next(r["ms"] for r in verify_rows[base] if r["t"] == t)
            row["verify"].append(v)
        for r in (row, pre, *row["verify"]):
            check(r["route"] == "sm90" and r["q"] == "float16", f"{name}: {r['route']} {r['q']}")
            log_f16(r)
        out[name] = row
    decode_poison(torch, da, shapes=(main_path_shape(), main_prefill_shape(),
                                     verify_shape(SPEC_K + 1), verify_shape(17)),
                  kinds=(("float16", None, "K7 f16"), ("int8", "float16", "K8 f16 q")))
    for name, kind, q_kind in F16_PAGED:
        base = name[:-4]
        row = paged_case(torch, F, da, kind, 1, paged_main_positions(), iters=50,
                         q_kind=q_kind, sweep=False)
        row["bf16_ms"] = paged_rows[base]["ms"]
        v = paged_case(torch, F, da, kind, SPEC_K + 1, paged_main_positions(), iters=50,
                       q_kind=q_kind, sweep=False)
        v["bf16_ms"] = next(r["ms"] for r in verify_rows[base] if r["t"] == SPEC_K + 1)
        row["verify"] = [v]
        c = paged_case(torch, F, da, kind, 256, [512], iters=50, q_kind=q_kind, sweep=False)
        c["pos"] = 512
        c["bf16_ms"] = next(r["ms"] for r in chunk_rows[base] if (r["t"], r["pos"]) == (256, 512))
        for r in (row, v, c):
            check(r["route"] == "sm90" and r["q"] == "float16", f"{name}: {r['route']} {r['q']}")
            log_f16(r, paged=True)
        out[name] = row
        out[f"{base}_sm90_chunk_f16"] = c
        paged_poison(torch, da, positions=paged_main_positions(), ts=(1, SPEC_K + 1),
                     kinds=(kind,), slack=SPEC_K, q_kind="float16")
        paged_poison(torch, da, positions=[512], ts=(256,), kinds=(kind,), q_kind="float16")
    log("f16_decode_cases " + json.dumps(out))
    return out


def plain_deficits(torch, pm, model, cfg, prompt, answer):
    """Each answer token's logit under its prefix's argmax, in float16
    ulps of the argmax, under the plain forward of ``cfg`` (no cache) over
    ``prompt + answer``; 0 where the token is the argmax."""
    if not answer:
        return []
    ids = torch.tensor([prompt + answer], device="cuda")
    with torch.no_grad():
        lg = pm.forward(model, ids, cfg)[0].float()
    lg = lg[len(prompt) - 1: len(prompt) - 1 + len(answer)]
    top = lg.max(dim=-1).values
    chosen = lg.gather(-1, torch.tensor(answer, device="cuda")[:, None])[:, 0]
    return [(a - c) / f16_ulp(a) for a, c in zip(top.tolist(), chosen.tolist())]


def engine_serve(eng, prompt):
    """One prompt through a PagedDecodeEngine to its end (its chunks, then
    its decode steps); returns its tokens cut at EOS."""
    slot = eng.admit(prompt, MAX_NEW)
    row = eng.slots[slot]
    for _ in range(4 * MAX_NEW + 64):
        if row.prefill_done and not eng.active[slot]:
            break
        eng.step()
    check(row.prefill_done and not eng.active[slot], "an engine row never finished")
    toks = [int(x) for x in row.tokens]
    eng.release(slot)
    return toks[:toks.index(50256)] if 50256 in toks else toks


def phase_f16_serving(torch, env, ckpt):
    """Phase 27: phase 23's float16 step_12 served at full width with phase
    21's tokenizer, every pairing on its float16 sm90 route: (a) the
    coalescing serve CLI with float16 caches and --draft-k (K7: prefill
    and verify chunks); (b) the continuous serve CLI with int8 pools,
    --prefill-chunk and the prefix cache over phase 18's prompt families
    (K9 on int8 pools: decode steps and its chunk kernel; hits, spills,
    readmits); (c) ``generate`` with an int8 cache (K8) and a
    PagedDecodeEngine with float16 pools, chunked prefill and the prefix
    cache (K9 on float16 pools, its chunk kernel) in-process; (d) beam
    search in-process (K7 over the reordered float16 cache), replayed step
    by step under the plain forward.  0 CUDA-core and 0 plain launches;
    every served token within ``F16_ULPS`` float16 ulps of its prefix's
    argmax under the plain forward (``attn_impl=xla``, float16; the int8
    runs under the cached forward with an int8 cache)."""
    import dataclasses
    import shutil
    import tempfile

    import torch.nn.functional as F

    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.models.gpt import model as pm
    from paddlefleetx_tpu_torch.models.gpt.model import GPTModel
    from paddlefleetx_tpu_torch.ops import decode_attention as da
    from paddlefleetx_tpu_torch.utils.checkpoint import load_params_into, restore_params
    from paddlefleetx_tpu_torch.utils.config import get_config

    tmp = tempfile.mkdtemp(prefix="smoke_f16_serve_")
    servers = []
    report = {}
    try:
        tok_dir = write_tokenizer(os.path.join(tmp, "tok"))
        tok = GPTTokenizer.from_pretrained(tok_dir)
        ids = [tok.encode(smoke_text(100 + i, 6 + 3 * i)) for i in range(TEXT_PROMPTS)]
        seq, _ = prefix_prompts()
        model_gen = ["Model.dtype=float16", f"Generation.max_dec_len={MAX_NEW}",
                     "Generation.decode_strategy=greedy_search"]
        overrides = model_gen + [f"Engine.save_load.ckpt_dir={ckpt}",
                                 f"Generation.tokenizer_dir={tok_dir}"]
        flags = [x for o in overrides for x in ("-o", o)]
        coal = start_serve(env, "f16 coalesce", flags + ["--draft-k", str(SPEC_K)])
        cont = start_serve(env, "f16 continuous", flags + [
            "--scheduler", "continuous", "--cb-batch", "8", "--kv-dtype", "int8",
            "--prefill-chunk", str(PFX_CHUNK), "--prefix-cache-blocks", str(PFX_BLOCKS),
            "--prefix-spill-bytes", str(PFX_SPILL)])
        servers += [coal, cont]
        cfg = get_config(str(REPO / CONFIG), model_gen)
        module = GPTModule(cfg)
        mcfg = module.config
        model = load_params_into(GPTModel(mcfg), restore_params(ckpt), ckpt).to("cuda")
        check(mcfg.dtype == "float16" and model.embeddings.word.dtype == torch.float16,
              f"served model dtype {mcfg.dtype} / {model.embeddings.word.dtype}")
        cx = dataclasses.replace(mcfg, attn_impl="xla")
        deficits = {}

        # (c) K8: generate with an int8 cache, float16 q
        gen = G.GenerationConfig(max_dec_len=MAX_NEW, decode_strategy="greedy_search",
                                 eos_token_id=50256, pad_token_id=0)
        pids, plens = G.pad_prompts(ids, 0, 64, torch.device("cuda"))
        cache = G.init_cache(mcfg, len(ids), pids.shape[1] + MAX_NEW, torch.device("cuda"),
                             kv_dtype="int8")
        da.reset_counts()
        q8_out = G.generate(model, pids, gen, prompt_lens=plens, cache=cache).cpu().tolist()
        k_q8 = dict(da.COUNTS)
        del cache
        check(k_q8["flash_decode_q8"] > 0
              and k_q8["flash_decode_q8_f16"] == k_q8["flash_decode_q8_sm90"] == k_q8["flash_decode_q8"]
              and k_q8["flash_decode"] == k_q8["plain"] == 0,
              f"generate, int8 cache: K8 off its float16 sm90 route: {k_q8}")
        q8_answers = [r[:r.index(50256)] if 50256 in r else r for r in q8_out]
        deficits["generate_int8"] = max([0.0] + [
            d for p, a in zip(ids, q8_answers)
            for d in greedy_deficits(torch, G, model, mcfg, p, a, "int8", f16_ulp)])

        # (c) K9 on float16 pools: the engine with chunked prefill and the
        # prefix cache over phase 18's families, one request at a time
        server = GenerationServer(cfg, module, model, torch.device("cuda"))
        eng = PagedDecodeEngine(server, max_batch=8, block=KV_BLOCK, kv_dtype="bf16",
                                prefill_chunk=PFX_CHUNK, prefix_cache_blocks=PFX_BLOCKS,
                                prefix_spill_bytes=PFX_SPILL)
        check(eng.pools.k.dtype == torch.float16, f"engine pools {eng.pools.k.dtype}")
        da.reset_counts()
        eng_answers = [engine_serve(eng, p) for p in seq]
        k_eng = dict(da.COUNTS)
        acct = {"prefix": dict(eng.cache.prefix.stats), "spill": dict(eng.cache.spill.stats),
                "prefill_chunks": eng.stats["prefill_chunks"]}
        del eng, server
        check(k_eng["paged_decode"] > 0
              and k_eng["paged_decode_f16"] == k_eng["paged_decode_sm90"] == k_eng["paged_decode"]
              and k_eng["paged_decode_sm90_chunk"] == k_eng["paged_decode_chunk"] > 0
              and k_eng["flash_decode"] == k_eng["plain"] == k_eng["paged_plain"] == 0,
              f"engine, float16 pools: K9 off its float16 sm90 route: {k_eng}")
        check(acct["prefix"]["hits"] > 0 and acct["spill"]["spills"] > 0
              and acct["spill"]["readmits"] > 0, f"engine, float16 pools: no reuse: {acct}")
        deficits["engine_f16"] = max([0.0] + [d for p, a in zip(seq, eng_answers)
                                              for d in plain_deficits(torch, pm, model, cx, p, a)])

        # (d) beam search over the text prompts: K7 over the float16 cache
        # reordered by parent beam, replayed under the plain forward
        gen_b = G.GenerationConfig(max_dec_len=MAX_NEW, decode_strategy="beam_search",
                                   num_beams=TEXT_BEAMS, eos_token_id=50256, pad_token_id=0)
        da.reset_counts()
        beams, rec, k7 = beam_traced(torch, G, model, ids, gen_b)
        k_beam = dict(da.COUNTS)
        check_rows(beams, "float16 beam search")
        want = N_LAYERS * MAX_NEW  # the prefill and MAX_NEW - 1 steps, a launch a layer
        check(k_beam["flash_decode"] == k_beam["flash_decode_sm90"] == k_beam["flash_decode_f16"]
              == want and k_beam["flash_decode_sm90_prefill"] == N_LAYERS
              and k_beam["plain"] == 0, f"beam, float16: K7 launches {k_beam}, expected {want}")
        held = beam_kernel_case(torch, F, da, k7)
        del k7
        replay = dict(zip(("worst_ulps", "near_ties", "reordered_rows"),
                          beam_deficits(torch, G, pm, model, cx, ids, gen_b, rec, ulp=f16_ulp)))
        del rec
        deficits["beam"] = replay["worst_ulps"]

        # (a) the coalescing CLI: float16 caches, --draft-k
        wait_serve(coal)
        h0 = http(coal["port"], "/healthz")["serving"]
        batch = http(coal["port"], "/generate", {"prompts_ids": ids, "max_tokens": MAX_NEW})
        single = http(coal["port"], "/generate", {"prompt_ids": ids[0], "max_tokens": MAX_NEW})
        health = http(coal["port"], "/healthz")
        stop_serve(coal)
        k_coal = health["kernels"]
        coal_answers = batch["completions_ids"] + [single["completion_ids"]]
        check_rows(coal_answers, "float16 coalescing")
        proposed = health["serving"]["spec_proposed"] - h0["spec_proposed"]
        check(proposed > 0, f"float16 coalescing: no drafts proposed: {health['serving']}")
        check(k_coal["plain"] == 0 and k_coal["flash_decode"] > 0
              and k_coal["flash_decode_f16"] == k_coal["flash_decode_sm90"] == k_coal["flash_decode"]
              and k_coal["flash_decode_sm90_multi"] == k_coal["flash_decode_multi"] > 0
              and k_coal["flash_decode"] == k_coal["flash_decode_multi"]
              + k_coal["flash_decode_sm90_prefill"] and k_coal["flash_decode_q8"] == 0,
              f"float16 coalescing: K7 off its float16 sm90 route: {k_coal}")
        deficits["coalesce_f16"] = max([0.0] + [
            d for p, a in zip(ids + ids[:1], coal_answers)
            for d in plain_deficits(torch, pm, model, cx, p, a)])

        # (b) the continuous CLI: int8 pools, chunked prefill, prefix cache
        wait_serve(cont)
        h0 = http(cont["port"], "/healthz")["serving"]
        cont_answers = [http(cont["port"], "/generate", {"prompt_ids": p, "max_tokens": MAX_NEW})
                        ["completion_ids"] for p in seq]
        health = http(cont["port"], "/healthz")
        stop_serve(cont)
        check_rows(cont_answers, "float16 continuous")
        k_cont, sv = health["kernels"], health["serving"]
        reuse = {"hits": sv["prefix"]["hits"] - h0["prefix"]["hits"],
                 "spills": sv["spill"]["spills"] - h0["spill"]["spills"],
                 "readmits": sv["spill"]["readmits"] - h0["spill"]["readmits"],
                 "chunks": sv["prefill_chunks"] - h0["prefill_chunks"]}
        check(reuse["hits"] > 0 and reuse["spills"] > 0 and reuse["readmits"] > 0
              and reuse["chunks"] > 0, f"float16 continuous: no reuse: {reuse}")
        check(k_cont["plain"] == k_cont["paged_plain"] == 0 and k_cont["paged_decode_q8"] > 0
              and k_cont["paged_decode_q8_f16"] == k_cont["paged_decode_q8_sm90"]
              == k_cont["paged_decode_q8"]
              and k_cont["paged_decode_q8_sm90_chunk"] == k_cont["paged_decode_q8_chunk"] > 0
              and k_cont["flash_decode"] == k_cont["flash_decode_q8"] == 0,
              f"float16 continuous: K9 off its float16 sm90 route: {k_cont}")
        deficits["continuous_int8"] = max([0.0] + [
            d for p, a in zip(seq, cont_answers)
            for d in greedy_deficits(torch, G, model, mcfg, p, a, "int8", f16_ulp)])
        del model
        worst = max(deficits.values())
        check(worst <= F16_ULPS, f"float16 serving: a token sits {worst:.1f} float16 ulps under "
                                 f"its prefix's argmax (gate {F16_ULPS}): {deficits}")
        report = {"coalesce": {"kernels": k_coal, "spec_proposed": proposed,
                               "boot_s": round(coal["boot_s"], 1)},
                  "continuous": {"kernels": k_cont, "reuse": reuse,
                                 "boot_s": round(cont["boot_s"], 1)},
                  "generate_int8": {"kernels": k_q8}, "engine_f16": {"kernels": k_eng, **acct},
                  "beam": {"kernels": k_beam, "replay": replay, "held": held,
                           "rows": len(ids) * TEXT_BEAMS},
                  "deficits_f16_ulps": deficits}
        log(f"  (a) coalescing CLI, float16 caches, --draft-k {SPEC_K}: {proposed} drafts, K7 "
            f"{k_coal['flash_decode']} launches ({k_coal['flash_decode_multi']} verify, "
            f"{k_coal['flash_decode_sm90_prefill']} prefill) all float16 sm90")
        log(f"  (b) continuous CLI, int8 pools: {reuse}, K9 {k_cont['paged_decode_q8']} launches "
            f"({k_cont['paged_decode_q8_sm90_chunk']} on the chunk kernel) all float16 sm90")
        log(f"  (c) generate, int8 cache: K8 {k_q8['flash_decode_q8']} launches; engine, float16 "
            f"pools: K9 {k_eng['paged_decode']} ({k_eng['paged_decode_sm90_chunk']} chunk), "
            f"{acct}")
        log(f"  (d) beam search: K7 {k_beam['flash_decode']} launches, replay {replay}, K7 on "
            f"step {BEAM_CAPTURE_STEP}'s cache err {held['max_abs_err']:.3e} "
            f"{held['ms']:.4f} ms")
        log(f"  every served token within {worst:.2f} float16 ulps of its prefix's argmax (gate "
            f"{F16_ULPS}): {deficits}")
        log("f16_serving " + json.dumps(report))
        return report
    finally:
        for srv in servers:
            kill_serve(srv)
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)




# ---------------------------------------------------------------------------
# phase 30: disaggregated prefill/decode and the router
# ---------------------------------------------------------------------------


def fleet_engine_round(torch, server, dtype, kv, ps):
    """Phase 30 (a), one pool dtype: export each prompt on one engine,
    carry it through the PFXH1 codec, adopt it on a second engine whose
    blocks and scales must then hold the payload's bytes, and decode it
    there; the same engine's ``admit`` of the prompt decodes the reference
    tokens.  Returns (rows with identical tokens, rows, payload bytes)."""
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
    from paddlefleetx_tpu_torch.core.paged_cache import pack_handoff, unpack_handoff
    from paddlefleetx_tpu_torch.models.gpt.generation import gather_kv_blocks

    src = PagedDecodeEngine(server, max_batch=2, block=KV_BLOCK, kv_dtype=kv or "bf16")
    dst = PagedDecodeEngine(server, max_batch=2, block=KV_BLOCK, kv_dtype=kv or "bf16")

    def decode(slot):
        for _ in range(4 * MAX_NEW):
            dst.step()
            if not dst.active[slot]:
                break
        toks = list(dst.slots[slot].tokens)
        dst.release(slot)
        return toks

    same, nbytes = 0, 0
    for prompt in ps:
        slot = dst.admit(prompt, MAX_NEW)
        want = decode(slot)
        payload = pack_handoff(*src.prefill_export(prompt, MAX_NEW))
        nbytes += len(payload)
        meta, arrays = unpack_handoff(payload)
        slot = dst.adopt(meta, arrays)
        landed = gather_kv_blocks(dst.pools, dst.slots[slot].table[: arrays["k"].shape[1]])
        for name, t in landed.items():
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            check(raw.numpy().tobytes() == arrays[name].tobytes(),
                  f"phase 30 {dtype} kv={kv or 'native'}: adopted {name} "
                  "blocks differ from the payload's bytes")
        same += decode(slot) == want
    check(src.cache.stats()["kv_blocks_used"] == 0 and dst.cache.stats()["kv_blocks_used"] == 0,
          "phase 30: blocks left allocated after the round")
    return same, len(ps), nbytes


def start_router(env, tag, args, port=None):
    """The port's ``tools.router`` on the card's host (on ``port``, else a
    free one), its output drained by a thread; :func:`wait_router` waits
    for its replicas."""
    port = port or free_port()
    cmd = [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.router", "--port", str(port),
           "--poll-interval", "0.2", *args]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    return {"tag": tag, "proc": proc, "port": port, "lines": lines, "reader": reader,
            "t0": time.time()}


def wait_router(srv, n=2, limit=420):
    """Poll the router's /healthz until ``n`` replicas are eligible."""
    while True:
        check(srv["proc"].poll() is None,
              f"{srv['tag']} exited {srv['proc'].returncode}: {''.join(srv['lines'])[-3000:]}")
        check(time.time() - srv["t0"] < limit, f"{srv['tag']}: replicas not eligible in {limit} s")
        try:
            if http(srv["port"], "/healthz", timeout=5).get("eligible", 0) >= n:
                break
        except OSError:
            pass
        time.sleep(0.2)
    srv["boot_s"] = time.time() - srv["t0"]


def stop_router(srv):
    srv["proc"].send_signal(signal.SIGTERM)
    rc = srv["proc"].wait(timeout=60)
    srv["reader"].join(timeout=10)
    out = "".join(srv["lines"])
    check(rc == 0 and "drained cleanly" in out, f"{srv['tag']} drain exit {rc}: {out[-3000:]}")


def fleet_traffic(port, ps, max_new=MAX_NEW, phase="30"):
    """The prompts sent at once; returns (answers, each request's wall)."""
    results, walls = {}, {}

    def post(i):
        t0 = time.time()
        try:
            results[i] = http(port, "/generate", {"prompt_ids": ps[i], "max_tokens": max_new})
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = e
        walls[i] = time.time() - t0

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(ps))]
    for th in threads:
        th.start()
        time.sleep(0.01)  # within the router's accept backlog (5)
    for th in threads:
        th.join(timeout=600)
    for i in range(len(ps)):
        check(isinstance(results.get(i), dict), f"phase {phase} request {i}: {results.get(i)}")
        check_rows([results[i]["completion_ids"]], f"phase {phase} request {i}", max_new)
    return [results[i]["completion_ids"] for i in range(len(ps))], [walls[i] for i in
                                                                    range(len(ps))]


def histogram_median(vals, name):
    """The median of a /metrics histogram, interpolated in its buckets as
    Prometheus' histogram_quantile does."""
    buckets = sorted((float(dict(lab)["le"]), v) for (n, lab), v in vals.items()
                     if n == f"{name}_bucket" and dict(lab)["le"] != "+Inf")
    count = vals.get((f"{name}_count", ()), 0.0)
    if not count:
        return None
    lo_le, lo_cum = 0.0, 0.0
    for le, cum in buckets:
        if cum >= count / 2:
            return lo_le + (le - lo_le) * (count / 2 - lo_cum) / max(cum - lo_cum, 1e-12)
        lo_le, lo_cum = le, cum
    return buckets[-1][0] if buckets else None


def phase_fleet(torch, da, env, card):
    """Phase 30 (see the module docstring).  Returns the phase's report."""
    import tempfile

    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.utils.config import get_config

    report = {"card": card, "engine": {}}
    ps = prompts(7, D_LENS)
    # (a) in process, full width cut to PFX_F32_LAYERS layers: float32 tokens
    # identical to admit's; bf16 and int8 blocks bitwise through the codec
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(str(REPO / CONFIG), [
            "Generation.decode_strategy=greedy_search", f"Generation.max_dec_len={MAX_NEW}",
            f"Model.dtype={dtype}", f"Model.num_layers={PFX_F32_LAYERS}"])
        module = GPTModule(cfg)
        server = GenerationServer(cfg, module, module.init_model(cfg.Global.seed, "cuda"),
                                  torch.device("cuda"))
        for kv in ("", "int8"):
            same, rows, nbytes = fleet_engine_round(torch, server, dtype, kv,
                                                    ps[:FLEET_ENGINE_ROWS])
            if dtype == "float32":
                check(same == rows, f"phase 30 float32 kv={kv or 'native'}: {rows - same} "
                      "adopted rows decoded other tokens than admit")
            report["engine"][f"{dtype}_{kv or 'native'}"] = {
                "rows": rows, "identical_to_admit": same, "payload_bytes": nbytes}
            log(f"  in process {dtype} kv={kv or 'native'}: {same} of {rows} adopted rows' "
                f"tokens identical to admit, blocks bitwise equal through the codec, "
                f"{nbytes / rows:.0f} payload bytes a request")
        del server
    torch.cuda.empty_cache()

    # (b) served at full width, bf16: a prefill, a decode and a monolithic
    # replica, and an int8 prefill/decode pair, booted together and warmed
    # at the traffic's prompt bucket (the decode replicas capture the step
    # graph at its table width), with the three routers booting beside them
    (REPO / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase30-", dir=str(REPO / "build"))
    fenv = dict(env, PFX_FLIGHT_DIR=tmp)
    gen = ["-o", "Generation.decode_strategy=greedy_search",
           "-o", f"Generation.max_dec_len={MAX_NEW}", "--warmup-buckets", str(max(D_LENS))]
    specs = {"prefill": ["--role", "prefill", "--cb-batch", "1"],
             "decode": ["--role", "decode", "--cb-batch", "8"],
             "mono": ["--scheduler", "continuous", "--cb-batch", "8"],
             "prefill_q8": ["--role", "prefill", "--cb-batch", "1", "--kv-dtype", "int8"],
             "decode_q8": ["--role", "decode", "--cb-batch", "8", "--kv-dtype", "int8"]}
    reps, routers = {}, []
    try:
        for tag, args in specs.items():
            reps[tag] = start_serve(fenv, tag, [*args, "--replica-id", tag, *gen], warmup=True)
        url = {tag: f"http://127.0.0.1:{srv['port']}" for tag, srv in reps.items()}
        pairs = (("proxy", "prefill", "decode"), ("direct", "prefill", "decode"),
                 ("direct_q8", "prefill_q8", "decode_q8"))
        for transport, pre, dec in pairs:
            routers.append(start_router(fenv, f"router_{transport}", [
                "--prefill", url[pre], "--decode", url[dec],
                "--handoff", transport.split("_")[0], "--router-id", f"router_{transport}"]))
        # wait for the five at once, so each boot's seconds are its own
        healths, errors = {}, []

        def wait_one(srv):
            try:
                healths[srv["tag"]] = wait_serve(srv)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        waiters = [threading.Thread(target=wait_one, args=(srv,)) for srv in reps.values()]
        for th in waiters:
            th.start()
        for th in waiters:
            th.join()
        if errors:
            raise errors[0]
        for srv in reps.values():
            health = healths[srv["tag"]]
            role = {"prefill": "prefill", "decode": "decode"}.get(srv["tag"].split("_")[0],
                                                                  "monolith")
            check(health["identity"]["role"] == role and health["identity"]["replica_id"] ==
                  srv["tag"], f"phase 30 {srv['tag']}: identity {health['identity']}")
        report["boot_s"] = {tag: round(srv["boot_s"], 1) for tag, srv in reps.items()}
        for rt in routers:
            wait_router(rt)
        mono, _ = fleet_traffic(reps["mono"]["port"], ps)
        runs, walls = {}, {}
        for (transport, pre, dec), rt in zip(pairs, routers):
            before = {t: metric_values(reps[t]["port"]) for t in (pre, dec)}
            runs[transport], walls[transport] = fleet_traffic(rt["port"], ps)
            rv = metric_values(rt["port"])
            after = {t: metric_values(reps[t]["port"]) for t in (pre, dec)}

            def delta(tag, name, **labels):
                key = (name, tuple(sorted(labels.items())))
                return after[tag].get(key, 0.0) - before[tag].get(key, 0.0)

            exports = delta(pre, "pfx_handoff_exports_total")
            adopts = delta(dec, "pfx_handoff_adopts_total")
            check(exports == adopts == len(ps),
                  f"phase 30 {transport}: {exports} exports, {adopts} adoptions for "
                  f"{len(ps)} requests")
            proxied = rv.get(("pfx_router_handoff_bytes_total", ()), 0.0)
            got_proxy = delta(dec, "pfx_handoff_bytes_total", transport="proxy")
            got_direct = delta(dec, "pfx_handoff_bytes_total", transport="direct")
            sent_direct = delta(pre, "pfx_handoff_bytes_total", transport="direct")
            if transport == "proxy":
                check(proxied == got_proxy > 0 and got_direct == 0,
                      f"phase 30 proxy: the router carried {proxied} bytes, the decode "
                      f"replica received {got_proxy} (direct {got_direct})")
                nbytes = got_proxy
            else:
                check(proxied == 0 and got_direct == sent_direct > 0 and got_proxy == 0,
                      f"phase 30 {transport}: router bytes {proxied} (must stay flat), direct "
                      f"{sent_direct} sent / {got_direct} received, proxy {got_proxy}")
                nbytes = got_direct
            med = histogram_median(rv, "pfx_router_handoff_seconds")
            report[transport] = {"bytes_per_request": nbytes / len(ps),
                                 "router_handoff_bytes": proxied,
                                 "handoff_seconds_median": med,
                                 "request_wall_median_s": sorted(walls[transport])[
                                     len(ps) // 2],
                                 "router_ready_s": round(rt["boot_s"], 1)}
            stop_router(rt)
            log(f"  {transport}: {nbytes / len(ps):.0f} handoff bytes a request, router bytes "
                f"{proxied:.0f}, pfx_router_handoff_seconds median {med} s (bucket "
                f"interpolation), request walls {[round(w, 3) for w in walls[transport]]} s")
        kern = {tag: http(srv["port"], "/healthz", timeout=30)["kernels"]
                for tag, srv in reps.items()}
        for tag, k in kern.items():
            check(k.get("plain", 0) == 0 and k.get("paged_plain", 0) == 0,
                  f"phase 30 {tag}: plain version ran on the card: {k}")
        for pre, dec, key in (("prefill", "decode", "paged_decode"),
                              ("prefill_q8", "decode_q8", "paged_decode_q8")):
            check(kern[pre]["flash_decode"] > 0
                  and kern[pre]["flash_decode_sm90"] == kern[pre]["flash_decode"],
                  f"phase 30 {pre}: K7 launches {kern[pre]}")
            check(kern[pre].get(key, 0) == 0, f"phase 30 {pre}: K9 ran on a prefill replica")
            check(kern[dec][key] > 0 and kern[dec][f"{key}_sm90"] == kern[dec][key]
                  and kern[dec]["flash_decode"] == 0,
                  f"phase 30 {dec}: K9 launches {kern[dec]}")
        report["kernels"] = {tag: {k: v for k, v in kern[tag].items() if v}
                             for tag in kern}
        # tokens: the 4-bf16-ulp argmax rule under teacher forcing, against
        # the monolithic replica's answers
        cfg = get_config(str(REPO / CONFIG))
        module = GPTModule(cfg)
        model = module.init_model(cfg.Global.seed, "cuda")
        for transport, answers in runs.items():
            kv = "int8" if transport.endswith("q8") else ""
            worst = 0.0
            for prompt, ans in zip(ps, answers):
                worst = max([worst] + greedy_deficits(torch, G, model, module.config, prompt,
                                                      ans, kv))
            same = sum(a == b for a, b in zip(answers, mono))
            check(worst <= SPEC_ULPS,
                  f"phase 30 {transport}: a token sits {worst:.1f} bf16 ulps under its "
                  f"prefix's argmax (> {SPEC_ULPS})")
            report[transport].update({"identical_to_monolith": same,
                                      "worst_deficit_ulps": worst})
            log(f"  {transport}: {same} of {len(ps)} answers identical to the monolithic "
                f"replica's; every token within {worst:.1f} bf16 ulps of its prefix's argmax")
        del model
        for srv in reps.values():
            stop_serve(srv)
    finally:
        for srv in list(reps.values()) + routers:
            kill_serve(srv)
    log("  boot seconds " + json.dumps(report["boot_s"]))
    return report


# ---------------------------------------------------------------------------
# phase 31: the elastic control plane
# ---------------------------------------------------------------------------


def elastic_template(*args):
    """A port serve command template for the supervisor ({port} and
    {replica_id} stay placeholders): bf16, greedy, warmed at phase 7's
    bucket."""
    return " ".join([sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c",
                     str(REPO / CONFIG), "--port", "{port}", "--replica-id", "{replica_id}",
                     "-o", "Generation.decode_strategy=greedy_search",
                     "-o", f"Generation.max_dec_len={ELASTIC_NEW}",
                     "--warmup-buckets", str(max(D_LENS)), "--queue-depth", "64", *args])


def free_ports(n):
    """The first of ``n`` consecutive free ports."""
    while True:
        base = free_port()
        try:
            for p in range(base, base + n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue


def pid_running(pid):
    """True while ``pid`` is a live process (not gone, not a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


class FleetWatch:
    """Polls a supervising router every 0.1 s: the wall time each managed
    process (replica id, pid) was first seen spawned (``/debug/controller``)
    and first seen serving (``/replicas``)."""

    def __init__(self, port):
        self.port, self.spawned, self.serving = port, {}, {}
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.wait(0.1):
            try:
                _, dbg = admin_http(self.port, "/debug/controller", token=ELASTIC_TOKEN,
                                    timeout=5)
                views = http(self.port, "/replicas", timeout=5)["replicas"]
            except Exception:  # noqa: BLE001 — the router is restarting
                continue
            now = time.time()
            slots = dbg.get("replicas") or [v for p in (dbg.get("pools") or {}).values()
                                             for v in p["replicas"]]
            for m in slots:
                if m.get("pid"):
                    self.spawned.setdefault((m["replica_id"], m["pid"]), now)
            for v in views:
                if v.get("state") == "serving" and v.get("pid") and v.get("replica_id"):
                    self.serving.setdefault((v["replica_id"], v["pid"]), now)

    def boots(self):
        return {f"{rid} pid {pid}": round(self.serving[(rid, pid)] - t, 2)
                for (rid, pid), t in sorted(self.spawned.items(), key=lambda kv: kv[1])
                if (rid, pid) in self.serving}


def controller_view(port):
    status, dbg = admin_http(port, "/debug/controller", token=ELASTIC_TOKEN, timeout=30)
    check(status == 200, f"phase 31: /debug/controller answered {status}: {dbg}")
    return dbg


def replica_ports(port):
    """{replica_id: port} of a supervising router's managed slots."""
    dbg = controller_view(port)
    views = [v for p in dbg["pools"].values() for v in p["replicas"]] if "pools" in dbg \
        else dbg["replicas"]
    return {v["replica_id"]: v["port"] for v in views}


def elastic_kernels_ok(tag, k, k7=True, k9=True):
    check(k.get("plain", 0) == 0 and k.get("paged_plain", 0) == 0,
          f"phase 31 {tag}: the plain version ran on the card: {k}")
    if k7:
        check(k["flash_decode"] > 0 and k["flash_decode_sm90"] == k["flash_decode"]
              and k["flash_decode_sm90_prefill"] > 0, f"phase 31 {tag}: K7 launches {k}")
    else:
        check(k["flash_decode"] == 0, f"phase 31 {tag}: K7 ran on a decode replica: {k}")
    if k9:
        check(k["paged_decode"] > 0 and k["paged_decode_sm90"] == k["paged_decode"],
              f"phase 31 {tag}: K9 launches {k}")
    else:
        check(k.get("paged_decode", 0) == 0, f"phase 31 {tag}: K9 ran on a prefill replica: {k}")


def elastic_replay(port):
    """The decision log against /metrics, read until no tick lands between
    the reads; returns the replay."""
    from paddlefleetx_tpu_torch.core.controller import replay_controller_log

    for _ in range(20):
        rows = controller_view(port)["decisions"]
        vals = metric_values(port)
        if len(controller_view(port)["decisions"]) != len(rows):
            continue
        replay = replay_controller_log(rows)
        got = {k: vals.get((f"pfx_controller_{k}_total", ()), 0.0)
               for k in ("ticks", "scale_ups", "scale_downs")}
        check(got == {k: float(replay[k]) for k in got},
              f"phase 31: the decision log replays to {replay}, /metrics reads {got}")
        return replay
    raise SmokeFailure("phase 31: the controller never held still between two reads")


def phase_elastic(torch, env, card):
    """Phase 31 (see the module docstring).  Returns the phase's report."""
    import tempfile

    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.models.gpt import generation as G
    from paddlefleetx_tpu_torch.ops import _build
    from paddlefleetx_tpu_torch.utils.config import get_config

    report = {"card": card, "kernels": {}}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase31-", dir=str(REPO / "build")))
    kdir = str(_build.BUILD_DIR)
    # the down-cooldown outlasts m1's boot and the kill drill, so the one
    # idle scale-down comes after them
    rport, bport = free_port(), free_ports(2)
    pre_port, dec_port = free_port(), free_port()
    mono_args = [
        "--supervise", "--replica-cmd", elastic_template("--scheduler", "continuous",
                                                         "--cb-batch", "8"),
        "--min-replicas", "1", "--max-replicas", "2", "--base-port", str(bport),
        "--compile-cache-dir", kdir, "--replica-log-dir", str(tmp / "mono-logs"),
        "--control-interval", "0.5", "--scale-high-depth", "4", "--scale-up-cooldown", "2",
        "--scale-idle", "4", "--scale-down-cooldown", "40", "--restart-backoff", "0.5",
        "--router-id", "elastic"]
    menv = dict(env, PFX_ADMIN_TOKEN=ELASTIC_TOKEN, PFX_FLIGHT_DIR=str(tmp / "mono"))
    penv = dict(env, PFX_ADMIN_TOKEN=ELASTIC_TOKEN, PFX_FLIGHT_DIR=str(tmp / "pools"))
    routers, watches = [], []
    try:
        t0 = time.time()
        mono = start_router(menv, "elastic", mono_args, port=rport)
        routers.append(mono)
        watch = FleetWatch(rport)
        watches.append(watch)
        wait_router(mono, n=1)
        report["first_serving_s"] = round(time.time() - t0, 1)
        # (1) one replica: the flood pushes the depth past the watermark
        ps = prompts(31, [D_LENS[i % len(D_LENS)] for i in range(ELASTIC_FLOOD)])
        t1 = time.time()
        ans1, _ = fleet_traffic(rport, ps, ELASTIC_NEW, "31")
        wall1 = time.time() - t1
        ups = [d for d in controller_view(rport)["decisions"] if d["action"] == "scale_up"]
        check(len(ups) == 1 and "avg depth" in ups[0]["reason"] and ups[0]["target"] == 2,
              f"phase 31: the flood's scale-up decisions {ups}")
        wait_router(mono, n=2)
        ports = replica_ports(rport)
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
        # (2) two replicas sharing the card: the same flood
        t2 = time.time()
        ans2, _ = fleet_traffic(rport, ps, ELASTIC_NEW, "31")
        wall2 = time.time() - t2
        report["one_replica"] = {"tokens": sum(map(len, ans1)), "wall_s": round(wall1, 3),
                                 "tokens_per_s": round(sum(map(len, ans1)) / wall1, 1)}
        report["two_replicas"] = {"tokens": sum(map(len, ans2)), "wall_s": round(wall2, 3),
                                  "tokens_per_s": round(sum(map(len, ans2)) / wall2, 1)}
        report["compute_apps"] = apps
        log(f"  {ELASTIC_FLOOD} requests x {ELASTIC_NEW} tokens at once: one replica "
            f"{report['one_replica']['tokens_per_s']} tokens/s ({wall1:.2f} s, m1 booting "
            f"beside it), two {report['two_replicas']['tokens_per_s']} tokens/s "
            f"({wall2:.2f} s); nvidia-smi compute apps {apps}")
        # the supervised pools boot beside the next steps
        pools = start_router(penv, "elastic_pools", [
            "--supervise", "--prefill-cmd", elastic_template("--role", "prefill",
                                                             "--cb-batch", "1"),
            "--decode-cmd", elastic_template("--role", "decode", "--cb-batch", "8"),
            "--min-prefill", "1", "--max-prefill", "1", "--min-decode", "1",
            "--max-decode", "1", "--prefill-base-port", str(pre_port), "--decode-base-port",
            str(dec_port), "--compile-cache-dir", kdir, "--replica-log-dir",
            str(tmp / "pool-logs"), "--control-interval", "0.5", "--handoff", "direct",
            "--router-id", "elastic_pools"])
        routers.append(pools)
        watches.append(FleetWatch(pools["port"]))
        # (3) SIGKILL m0 under a flood: restarted with a new pid and readmitted
        report["kernels"]["m0"] = http(ports["m0"], "/healthz", timeout=30)["kernels"]
        victim = {v["replica_id"]: v["pid"] for v in controller_view(rport)["replicas"]}["m0"]
        stop, codes = threading.Event(), []

        def flood(i):
            while not stop.is_set():
                try:
                    codes.append(admin_http(rport, "/generate", {
                        "prompt_ids": ps[i], "max_tokens": 16}, token=None, timeout=300)[0])
                except Exception as e:  # noqa: BLE001 — a dropped exchange
                    codes.append(repr(e))

        threads = [threading.Thread(target=flood, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        t_kill = time.time()
        os.kill(victim, signal.SIGKILL)
        while True:
            check(time.time() - t_kill < 240, "phase 31: m0 not readmitted in 240 s")
            views = {v.get("replica_id"): v for v in http(rport, "/replicas")["replicas"]}
            m0 = views.get("m0") or {}
            if m0.get("state") == "serving" and m0.get("pid") not in (None, victim):
                break
            time.sleep(0.1)
        report["restart_readmitted_s"] = round(time.time() - t_kill, 2)
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(timeout=300)
        check(not any(th.is_alive() for th in threads), "phase 31: a request hung through "
              "the kill")
        check(codes and set(codes) <= {200, 503} and 200 in codes,
              f"phase 31: responses through the kill {sorted(set(map(str, codes)))}")
        report["kill_flood"] = {"200": codes.count(200), "503": codes.count(503)}
        report["kernels"]["m1"] = http(ports["m1"], "/healthz", timeout=30)["kernels"]
        # (4) idle: the controller drains m1 through the token-gated remote drain
        t_idle = time.time()
        while True:
            check(time.time() - t_idle < 120, "phase 31: no idle scale-down in 120 s")
            dbg = controller_view(rport)
            slot1 = {v["slot"]: v for v in dbg["replicas"]}[1]
            downs = [d for d in dbg["decisions"] if d["action"] == "scale_down"]
            if downs and slot1["last_exit_rc"] is not None:
                break
            time.sleep(0.2)
        check(slot1["last_exit_rc"] == 0 and not slot1["desired"] and "idle" in downs[0][
            "reason"], f"phase 31: the scale-down {downs}, slot {slot1}")
        report["scale_down_exit_s"] = round(time.time() - t_idle, 2)
        vals = metric_values(rport)
        check(vals.get(("pfx_replica_restarts_total", (("replica", "m0"),))) == 1.0
              and not any(n == "pfx_replica_quarantines_total" for n, _ in vals),
              "phase 31: restart counters "
              f"{ {k: v for k, v in vals.items() if k[0].startswith('pfx_replica_')} }")
        # (5) the decision log replays to the counters
        report["replay"] = elastic_replay(rport)
        check(report["replay"]["scale_ups"] == 1 and report["replay"]["scale_downs"] == 1,
              f"phase 31: replay {report['replay']}")
        # (6) SIGKILL the router; its successor re-adopts the live replica
        pids = {v["key"]: v["pid"] for v in http(rport, "/replicas")["replicas"]
                if v["state"] == "serving"}
        check(len(pids) == 1, f"phase 31: serving after the scale-down {pids}")
        mono["proc"].kill()
        mono["proc"].wait(timeout=30)
        t_re = time.time()
        mono2 = start_router(menv, "elastic_restarted", mono_args, port=rport)
        routers.append(mono2)
        while True:
            check(mono2["proc"].poll() is None, "phase 31: the restarted router exited: "
                  + "".join(mono2["lines"])[-3000:])
            check(time.time() - t_re < 120, "phase 31: no re-adoption in 120 s")
            try:
                got = {v["key"]: v["pid"] for v in http(rport, "/replicas", timeout=5)[
                    "replicas"] if v["state"] == "serving"}
            except OSError:
                got = {}
            if got == pids:
                break
            time.sleep(0.1)
        report["readopted_s"] = round(time.time() - t_re, 2)
        vals = metric_values(rport)
        check(vals.get(("pfx_router_recoveries_total", ())) == 1.0
              and vals.get(("pfx_router_adopted_replicas_total", (("replica", "m0"),))) == 1.0
              and not any(n == "pfx_replica_restarts_total" for n, _ in vals),
              "phase 31: re-adoption counters "
              f"{ {k: v for k, v in vals.items() if 'adopt' in k[0] or 'recover' in k[0]} }")
        check(isinstance(http(rport, "/generate", {"prompt_ids": ps[0], "max_tokens": 8})[
            "completion_ids"], list), "phase 31: no answer through the restarted router")
        report["kernels"]["m0_restarted"] = http(ports["m0"], "/healthz", timeout=30)["kernels"]
        # (7) the supervised pools: phase 7's prompts disaggregated
        wait_router(pools, n=2)
        pports = replica_ports(pools["port"])
        ps7 = prompts(7, D_LENS)
        pool_ans, _ = fleet_traffic(pools["port"], ps7, phase="31")
        adopts = metric_values(pports["d0"]).get(("pfx_handoff_adopts_total", ()), 0.0)
        check(adopts == len(ps7), f"phase 31: the decode replica adopted {adopts} of {len(ps7)}")
        for rid in ("p0", "d0"):
            report["kernels"][rid] = http(pports[rid], "/healthz", timeout=30)["kernels"]
        for tag in ("m0", "m1", "m0_restarted"):
            elastic_kernels_ok(tag, report["kernels"][tag])
        elastic_kernels_ok("p0", report["kernels"]["p0"], k9=False)
        elastic_kernels_ok("d0", report["kernels"]["d0"], k7=False)
        report["kernels"] = {t: {k: v for k, v in c.items() if v}
                             for t, c in report["kernels"].items()}
        # (8) cleanup: SIGTERM drains each router and its replicas
        report["boot_s"] = {k: v for w in watches for k, v in w.boots().items()}
        seen = {pid for w in watches for _, pid in w.spawned}
        for w in watches:
            w.stop.set()
        for rt in (mono2, pools):
            stop_router(rt)
        t_gone = time.time()
        while any(pid_running(p) for p in seen | set(pids.values())) and time.time() - t_gone < 30:
            time.sleep(0.2)
        check(not any(pid_running(p) for p in seen), "phase 31: replica processes outlived "
              f"their routers: {[p for p in seen if pid_running(p)]}")
        logs = {f.name: f.read_text() for d in ("mono-logs", "pool-logs")
                for f in (tmp / d).glob("*.log")}
        check(not any("kernel build:" in t for t in logs.values()),
              f"phase 31: a supervised replica built kernels: {sorted(logs)}")
        check("drained cleanly" in logs.get("m1.log", ""), "phase 31: m1 did not drain cleanly")
    finally:
        for w in watches:
            w.stop.set()
        for rt in routers:  # a failed step: each router drains its replicas
            if rt["proc"].poll() is None:
                rt["proc"].send_signal(signal.SIGTERM)
                try:
                    rt["proc"].wait(timeout=60)
                except subprocess.TimeoutExpired:
                    kill_serve(rt)
        for pid in {pid for w in watches for _, pid in w.spawned}:
            if pid_running(pid):
                os.kill(pid, signal.SIGKILL)
    # answers: the argmax rule under teacher forcing
    cfg = get_config(str(REPO / CONFIG))
    module = GPTModule(cfg)
    model = module.init_model(cfg.Global.seed, "cuda")
    worst = 0.0
    for prompt, ans in list(zip(ps, ans1))[:ELASTIC_CHECKED] + list(zip(ps7, pool_ans)):
        worst = max([worst] + greedy_deficits(torch, G, model, module.config, prompt, ans, ""))
    check(worst <= SPEC_ULPS, f"phase 31: a token sits {worst:.1f} bf16 ulps under its prefix's "
          f"argmax (> {SPEC_ULPS})")
    report["worst_deficit_ulps"] = worst
    del model
    torch.cuda.empty_cache()
    log(f"  boots (spawn to serving) {report['boot_s']}; m0 restarted and readmitted in "
        f"{report['restart_readmitted_s']} s ({report['kill_flood']}); m1 drained at idle, "
        f"exit 0 after {report['scale_down_exit_s']} s; re-adopted in {report['readopted_s']} s; "
        f"replay {report['replay']}; tokens within {worst:.1f} bf16 ulps")
    return report


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
    cli, trained_ckpt, cli_data = phase_train_cli(env)
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
    begin("21", "a trained and a converted GPT-345M served with text: both schedulers, beam "
          "search, the HF GPT-2 converter")
    text = phase_text(torch, env, trained_ckpt)
    begin("22", "K1-K6 in float16 against their plain versions")
    f16_rows = phase_f16_kernels(torch, F, fa, fl, flash_rows, ln_rows)
    begin("23", "the float16 train CLI at 345M: dynamic loss scaling, the worker loader, "
          "async saves and their resume")
    f16 = phase_f16_train(torch, fa, fl, env, cli_data)
    begin("24", "memory levers at 345M: main_grad=False, bf16 moments, "
          "multi_precision=False, chunked cross-entropy")
    phase_levers(torch, fa, fl)
    begin("25", "the eval CLI over phase 13's checkpoint")
    evald = phase_eval(torch, fa, fl, trained_ckpt, cli_data)
    begin("26", "K7, K8 and K9 in float16 against their plain versions")
    f16_decode = phase_f16_decode_kernels(torch, F, da, main_rows, paged_rows, verify_rows,
                                          chunk_rows)
    begin("27", "phase 23's float16 step_12 served at full width: both schedulers, native and "
          "int8 KV, speculation, chunked prefill and the prefix cache, beam search")
    f16_serve = phase_f16_serving(torch, env, f16["ckpt"])
    begin("28", "the continuous engine's dispatch path at full width: CUDA graphs with "
          "dispatch-ahead, graphs alone, eager and synchronous")
    graph_report = phase_graphs(torch, da, card)
    log("step_graphs " + json.dumps(graph_report))
    begin("29", "serving observability at full width: traces, the decision log, the goodput "
          "ledgers, SLO burn, /debug/*, /admin/profile and /admin/drain, the flight recorder")
    log("observability " + json.dumps(phase_observability(torch, da, env, card)))
    begin("30", "disaggregated prefill/decode and the router at full width: the PFXH1 "
          "handoff in process, proxy and direct transports, int8 KV")
    fleet = phase_fleet(torch, da, env, card)
    log("fleet " + json.dumps(fleet))
    begin("31", "the elastic control plane at full width: supervised replicas, scale-up, "
          "crash-restart, idle scale-down, router re-adoption, supervised pools")
    elastic = phase_elastic(torch, env, card)
    log("elastic " + json.dumps(elastic))
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
                "fused_ln_fwd": cli["fused_ln_fwd"], "fused_ln_bwd": cli["fused_ln_bwd"],
                # phase 23: the float16 CLI run (K1, K2, K3, K6) and the bare
                # split step at scale 2**31 (K4, K5)
                "fused_ln_fwd_f16": f16["launches"]["fused_ln_fwd"],
                "fused_ln_bwd_f16": f16["launches"]["fused_ln_bwd"],
                "flash_fwd_f16": f16["launches"]["flash_fwd"],
                "flash_bwd_fused_f16": f16["launches"]["flash_bwd_fused"],
                "flash_bwd_dq_f16": f16["bare_split_launches"]["flash_bwd_dq"],
                "flash_bwd_dkv_f16": f16["bare_split_launches"]["flash_bwd_dkv"]}
    kernels = []
    for name, row in {**main_rows, **paged_rows, **flash_rows, **ln_rows, **f16_rows}.items():
        base = name[:-4] if name.endswith("_f16") else name
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
            "name": name, "route": "cuda", "source": SOURCES[base],
            "replaces": REPLACES[base], "launches": launches[name],
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
            # phase 28: the same traffic in process per dispatch mode (the
            # launches of the graph modes are replays, counted per replay)
            kv = "int8" if name == "paged_decode_q8" else "native"
            entry["step_graphs"] = {
                r["mode"]: {k: r[k] for k in ("steps", "replays", "k9_launches", "k9_sm90",
                                              "step_wall_ms", "device_ms", "host_gap_ms")}
                for r in graph_report["runs"] if r["layers"] == N_LAYERS and r["kv"] == kv}
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
        if name in ("flash_decode", "paged_decode", "paged_decode_q8"):
            # phase 20: launches in the multi-tenant run (bf16 KV for K7's
            # monolithic prefills; K9 by pool dtype), a preempted row's
            # resume chunk in "chunk" and "sm90_chunk" (t > 16)
            counts = ten_runs["int8" if name == "paged_decode_q8" else ""][0]
            entry["tenancy"] = {k: counts[k] for k in counts
                                if (k == name or k.startswith(f"{name}_"))
                                and ("_q8" in k) == ("_q8" in name)}
            entry["tenancy"]["preemptions"] = ten_runs[
                "int8" if name == "paged_decode_q8" else ""][1]["preemptions"]
        if name in ("flash_decode", "paged_decode", "paged_decode_q8"):
            # phase 30: the fleet's launches, K7 on the prefill replicas (its
            # bf16 scratch cache under either pool dtype), K9 on the decode
            # replicas by pool dtype
            fk = fleet["kernels"]
            entry["fleet"] = (
                {"prefill_replica": fk["prefill"].get("flash_decode", 0),
                 "prefill_q8_replica": fk["prefill_q8"].get("flash_decode", 0),
                 "decode_replicas": fk["decode"].get("flash_decode", 0)
                 + fk["decode_q8"].get("flash_decode", 0)}
                if name == "flash_decode" else
                {"decode_replica": fk["decode_q8" if name.endswith("q8") else "decode"].get(
                    name, 0)})
        if name in ("flash_decode", "paged_decode"):
            # phase 31: the supervised replicas' launches (K7 on the monolith
            # and prefill replicas, K9 on the monolith and decode replicas)
            ek = elastic["kernels"]
            entry["elastic"] = {tag: ek[tag].get(name, 0) for tag in ek}
        if name == "flash_decode":
            # phase 21: beam search over b * num_beams rows (its prefill and
            # MAX_NEW - 1 steps), and the text-serving runs' K7 launches
            kb = text["b"]["kernels"]
            entry["beam"] = {"launches": kb["flash_decode"], "sm90": kb["flash_decode_sm90"],
                             "sm90_prefill": kb["flash_decode_sm90_prefill"],
                             "plain": kb["plain"], "rows": text["b"]["rows"],
                             "steps": text["b"]["steps"],
                             "converted_launches": text["c"]["beam"]["kernels"]["flash_decode"],
                             # one step's captured inputs (the reordered cache)
                             "held": text["b"]["held"]}
            entry["text_serving"] = {
                run: {k: text["a"][f"{run}_kernels"][k] for k in
                      ("flash_decode", "flash_decode_sm90", "flash_decode_sm90_prefill", "plain")}
                for run in ("coalesce", "continuous")}
            entry["text_serving"]["converted"] = {
                k: text["c"]["kernels"][k] for k in ("flash_decode", "flash_decode_sm90", "plain")}
        if name == "paged_decode":
            kc = text["a"]["continuous_kernels"]
            entry["text_serving"] = {k: kc[k] for k in ("paged_decode", "paged_decode_sm90",
                                                        "paged_plain")}
        if base == "fused_ln_fwd":
            entry["kernel_route"] = row["path"]
        if name.endswith("_f16"):
            entry["bf16_ms"] = row["bf16_ms"]
        if name in ("flash_fwd", "fused_ln_fwd"):
            # phase 25: the eval CLI's forwards (bf16), checked in-process
            entry["eval_launches"] = evald["launches"][name]
        kernels.append(entry)
    for name, rows in chunk_rows.items():
        # K9's chunk kernel (t > 16, a chunked prefill's chunk or a prefix
        # hit's suffix): launches in phase 18 (t = PFX_CHUNK) and in phase
        # 20 (a preempted row's resume), the kernel held and timed in phase
        # 17 at t = 256 over a 512-token cached prefix (and the other cases;
        # ms: through the engine's wrapper, launch_ms: the bare launch), the
        # CUDA-core kernel (csrc/paged_attention.cu) on the same inputs beside it
        head = next(r for r in rows if (r["t"], r["pos"]) == (256, 512))
        kind = "int8" if name == "paged_decode_q8" else ""
        counts, ten = pfx_runs[kind][0], ten_runs[kind][0]
        cc = head["cuda_core"]
        kernels.append({
            "name": f"{name}_sm90_chunk", "route": "cuda",
            "source": SOURCES[f"{name}_sm90_chunk"], "replaces": REPLACES[f"{name}_sm90_chunk"],
            "launches": counts[f"{name}_sm90_chunk"],
            **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "launch_ms", "split_ms")},
            "shape": {"b": 1, "n": 16, "t": 256, "d": 64, "bs": KV_BLOCK, "positions": [512],
                      "dtype": head["kind"]},
            "tenancy_launches": ten[f"{name}_sm90_chunk"],
            "cuda_core": {"source": "paddlefleetx_tpu_torch/csrc/paged_attention.cu",
                          "launches": counts[f"{name}_chunk"] - counts[f"{name}_sm90_chunk"],
                          "max_abs_err": cc["max_abs_err"], "ms": cc["launch_ms"]},
            "rows": [{k: r[k] for k in ("t", "pos", "route", "max_abs_err", "ms", "launch_ms",
                                        "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "split_ms")
                      + (("bf16_ms",) if "bf16_ms" in r else ())}
                     | {"cuda_core_ms": r["cuda_core"]["launch_ms"]}
                     for r in rows]})
    # phase 26's float16 rows with phase 27's launches: K7 on the coalescing
    # CLI's float16 caches, K8 in generate's int8 cache, K9 on the
    # in-process engine's float16 pools and the continuous CLI's int8 pools
    # (the chunk entries: those runs' chunk-kernel launches)
    fk = {run: f16_serve[run]["kernels"] for run in ("coalesce", "continuous", "generate_int8",
                                                      "engine_f16", "beam")}
    f16_launches = {"flash_decode_f16": fk["coalesce"]["flash_decode_f16"],
                    "flash_decode_q8_f16": fk["generate_int8"]["flash_decode_q8_f16"],
                    "paged_decode_f16": fk["engine_f16"]["paged_decode_f16"],
                    "paged_decode_q8_f16": fk["continuous"]["paged_decode_q8_f16"],
                    "paged_decode_sm90_chunk_f16": fk["engine_f16"]["paged_decode_sm90_chunk"],
                    "paged_decode_q8_sm90_chunk_f16":
                        fk["continuous"]["paged_decode_q8_sm90_chunk"]}
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bf16_ms")
    for name, row in f16_decode.items():
        base = name[:-4]
        if base.startswith("paged"):
            shape = {"b": row["b"], "n": 16, "t": row["t"], "d": 64, "bs": row["bs"],
                     "positions": row["positions"], "dtype": row["kind"], "q": row["q"]}
        else:
            shape = {"b": row["b"], "n": row["n"], "t": row["t"], "d": row["d"], "L": row["L"],
                     "limit": row["limit"], "dtype": row["kind"], "q": row["q"]}
        entry = {"name": name, "route": "cuda", "source": SOURCES[base],
                 "replaces": REPLACES[base], "launches": f16_launches[name],
                 "kernel_route": row["route"], **{k: row[k] for k in timed}, "shape": shape}
        if "launch_ms" in row:
            entry["launch_ms"] = row["launch_ms"]
        if "prefill" in row:
            entry["prefill"] = {k: row["prefill"][k] for k in ("t",) + timed}
        if "verify" in row:
            entry["verify"] = {"rows": [{k: r[k] for k in ("t",) + timed} for r in row["verify"]]}
        if name == "flash_decode_f16":
            # phase 27's in-process beam search over b * num_beams rows
            entry["beam"] = {"launches": fk["beam"]["flash_decode_f16"],
                             "held": f16_serve["beam"]["held"]}
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
