"""Profile the paged engine's admission (prefill) and decode step, per KV
cache dtype, with ``torch.profiler``.

    python -m paddlefleetx_tpu_torch.tools.profile_engine \\
        -c configs/gpt/pretrain_gpt_345M_single.yaml [--kv-dtype bf16,int8] \\
        [--mode step|traffic] [--batch 8] [--steps 8] [--out FILE.json]

Random weights from Global.seed; prompts of lengths 12 .. 64.
``--mode step`` (default): the prompts fill the running batch, then the
engine steps.  For each KV dtype it prints the host wall time of one
admission and one step (each ends in a device sync), the device time per
step (the sum of the card's kernel times in the profiled steps), and the
ops that take the most host and device time per step.  ``--mode
traffic``: a fresh engine, warmed as the serve CLI warms it, takes the
prompts one at a time (the first, two steps, then one admission before
each step, 32 new tokens each) and steps until every row is done; it
prints the wall time of the whole run and of every admission and step.
``--device cpu`` runs the same on the CPU (host times only).  On the card
the engine's decode step is a CUDA graph replay (``core/step_graphs.py``),
captured at its first step of each table width.
"""

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
from paddlefleetx_tpu_torch.tools.serve import build_server

PROMPT_LENS = [12, 20, 28, 36, 44, 52, 60, 64]
TOP = 12  # operators and kernels listed per table
SEED = 0  # prompt tokens


def _device_us(evt) -> float:
    if hasattr(evt, "self_device_time_total"):
        return float(evt.self_device_time_total)
    return float(evt.self_cuda_time_total)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _table(prof, steps: int) -> dict:
    """Per-step host (self CPU) time of the top operators and per-step
    device time of the top kernels, in microseconds."""
    evts = prof.key_averages()
    host = sorted((e for e in evts if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    kern = sorted((e for e in evts if e.device_type == DeviceType.CUDA),
                  key=_device_us, reverse=True)
    return {
        "host_us_per_step": sum(e.self_cpu_time_total for e in host) / steps,
        "device_us_per_step": sum(_device_us(e) for e in kern) / steps,
        "host_ops": [{"op": e.key, "calls": e.count / steps,
                      "self_cpu_us": e.self_cpu_time_total / steps} for e in host[:TOP]],
        "kernels": [{"kernel": e.key[:96], "calls": e.count / steps,
                     "device_us": _device_us(e) / steps} for e in kern[:TOP]],
    }


def profile_kv(server, kv_dtype: str, batch: int, steps: int) -> dict:
    dev = server.device
    eng = PagedDecodeEngine(server, max_batch=batch, kv_dtype=kv_dtype)
    rng = np.random.default_rng(SEED)
    vocab = int(server.module.config.vocab_size)
    prompts = [rng.integers(1, vocab, size=n).tolist()
               for n in (PROMPT_LENS * batch)[:batch]]
    max_new = 2 * steps + 8
    admit_s = []
    for p in prompts:
        t0 = time.perf_counter()
        eng.admit(p, max_new)
        _sync(dev)
        admit_s.append(time.perf_counter() - t0)
    for _ in range(2):  # warm
        eng.step()
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.step()  # ends in the tokens' device-to-host copy
        step_s.append(time.perf_counter() - t0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as step_prof:
        for _ in range(steps):
            eng.step()
        _sync(dev)
    slot = 0
    eng.release(slot)
    with profile(activities=acts) as admit_prof:
        eng.admit(prompts[slot], max_new)
        _sync(dev)
    return {
        "kv_dtype": kv_dtype, "batch": batch, "steps": steps,
        "admit_ms": [s * 1e3 for s in admit_s[1:]],  # the first also builds the kernels
        "step_ms": [s * 1e3 for s in step_s],
        "step": _table(step_prof, steps),
        "admit": _table(admit_prof, 1),
    }


def traffic_kv(server, kv_dtype: str, batch: int, max_new: int = 32) -> dict:
    dev = server.device
    eng = PagedDecodeEngine(server, max_batch=batch, kv_dtype=kv_dtype)
    eng.warmup([8])
    rng = np.random.default_rng(SEED)
    vocab = int(server.module.config.vocab_size)
    pending = [rng.integers(1, vocab, size=n).tolist() for n in (PROMPT_LENS * batch)[:batch]]
    admit_s, step_s = [], []
    t_start = time.perf_counter()
    while pending or eng.active.any():
        if pending and (len(step_s) >= 2 or not eng.active.any()):
            t0 = time.perf_counter()
            eng.admit(pending.pop(0), max_new)
            _sync(dev)
            admit_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for slot in eng.step():
            eng.release(slot)
        step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_start
    return {"kv_dtype": kv_dtype, "batch": batch, "wall_s": wall,
            "admit_ms": [s * 1e3 for s in admit_s], "step_ms": [s * 1e3 for s in step_s],
            "mid_decode_admits": eng.stats["mid_decode_admits"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.profile_engine")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--kv-dtype", default="bf16,int8",
                    help="comma-separated KV cache dtypes to profile in turn")
    ap.add_argument("--mode", default="step", choices=("step", "traffic"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="", help="write the full result as JSON here")
    args = ap.parse_args(argv)
    server = build_server(args.config, args.override, args.device)
    results = []
    for kv in [x.strip() for x in args.kv_dtype.split(",") if x.strip()]:
        if args.mode == "traffic":
            r = traffic_kv(server, kv, args.batch)
            results.append(r)
            print(f"kv {kv}: traffic wall {r['wall_s']:.3f} s, {len(r['admit_ms'])} "
                  f"admissions {sum(r['admit_ms']):.1f} ms, {len(r['step_ms'])} steps "
                  f"{sum(r['step_ms']):.1f} ms (median {np.median(r['step_ms']):.2f}, max "
                  f"{max(r['step_ms']):.2f}); admissions ms "
                  f"{[round(a, 1) for a in r['admit_ms']]}", flush=True)
            continue
        r = profile_kv(server, kv, args.batch, args.steps)
        results.append(r)
        st = r["step"]
        print(f"kv {kv}: admit {np.median(r['admit_ms']):.2f} ms (median), step "
              f"{np.median(r['step_ms']):.2f} ms (median, host wall); profiled step: host "
              f"{st['host_us_per_step'] / 1e3:.2f} ms of operator time, device "
              f"{st['device_us_per_step'] / 1e3:.3f} ms of kernel time", flush=True)
        for o in st["host_ops"]:
            print(f"  host {o['self_cpu_us']:9.1f} us x{o['calls']:6.1f}  {o['op']}")
        for k in st["kernels"]:
            print(f"  dev  {k['device_us']:9.1f} us x{k['calls']:6.1f}  {k['kernel']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
