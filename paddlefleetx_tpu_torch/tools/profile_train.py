"""Profile the training step (``Engine.train_step``) with ``torch.profiler``.

    python -m paddlefleetx_tpu_torch.tools.profile_train \\
        -c configs/gpt/pretrain_gpt_345M_single.yaml [-o Model.flash_bwd=fused ...] \\
        [--batch 16] [--seq 1024] [--steps 3] [--out FILE.json]

Random weights from Global.seed and one fixed random batch of ``--batch``
sequences of ``--seq`` tokens (``Global.micro_batch_size`` sets the
accumulation).  After two warm steps it prints the host wall time of
each step (each ends in a host read of the metrics), then profiles
``--steps`` steps and prints the device time per step (the sum of the
card's kernel times), that time split into groups (the flash attention
kernels, the fused LayerNorm kernels, matrix products, the rest), the
host time of the fused LayerNorm operators, and the kernels and host
operators that take the most time.  ``--device cpu`` runs the same on the CPU (host
times only).
"""

import argparse
import json
import time

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.tools.profile_engine import _device_us, _sync, _table
from paddlefleetx_tpu_torch.utils.config import get_config

# kernel-name substrings per group, checked in order
GROUPS = (("flash attention (K3-K6)", ("flash_fwd", "flash_bwd")),
          ("fused LayerNorm (K1/K2)", ("fused_ln",)),
          ("matrix products", ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")))


def _groups(prof, steps: int) -> dict:
    out = {name: 0.0 for name, _ in GROUPS}
    out["other kernels"] = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = e.key.lower()
        group = next((name for name, subs in GROUPS if any(x in key for x in subs)),
                     "other kernels")
        out[group] += _device_us(e) / steps
    return out


def _host_fused_ln(prof, steps: int) -> dict:
    """Host (self CPU) time and calls per step of the fused LayerNorm's
    operators: the ``pfx::fused_ln_fwd`` op and the autograd backward node,
    the wrappers' Python included."""
    us = calls = 0.0
    for e in prof.key_averages():
        key = e.key.lower()
        if e.device_type == DeviceType.CPU and ("fused_ln" in key or "fusedlayernorm" in key):
            us += e.self_cpu_time_total / steps
            calls += e.count / steps
    return {"self_cpu_us": us, "calls": calls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.profile_train")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="", help="write the full result as JSON here")
    args = ap.parse_args(argv)
    cfg = get_config(args.config, args.override)
    engine = Engine(cfg, GPTModule(cfg), device=args.device)
    dev = engine.device
    vocab = int(engine.module.config.vocab_size)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, vocab, (args.batch, args.seq)),
             "labels": rng.integers(0, vocab, (args.batch, args.seq)),
             "loss_mask": np.ones((args.batch, args.seq), np.float32)}
    for _ in range(2):  # warm
        engine.train_step(batch)
    step_s = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        engine.train_step(batch)
        step_s.append(time.perf_counter() - t0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            engine.train_step(batch)
        _sync(dev)
    table = _table(prof, args.steps)
    groups = _groups(prof, args.steps)
    host_ln = _host_fused_ln(prof, args.steps)
    result = {"device": str(dev), "batch": args.batch, "seq": args.seq,
              "accumulate_steps": engine.accumulate_steps,
              "step_ms": [s * 1e3 for s in step_s], "groups_us_per_step": groups,
              "host_fused_ln_per_step": host_ln, **table}
    print(f"train step {np.median(step_s) * 1e3:.1f} ms (median host wall, {args.batch} x "
          f"{args.seq} tokens, {engine.accumulate_steps} micro-batches); profiled step: host "
          f"{table['host_us_per_step'] / 1e3:.1f} ms of operator time, device "
          f"{table['device_us_per_step'] / 1e3:.1f} ms of kernel time", flush=True)
    for name, us in groups.items():
        print(f"  group {us / 1e3:9.2f} ms  {name}")
    print(f"  host  {host_ln['self_cpu_us'] / 1e3:9.2f} ms x{host_ln['calls']:6.1f}  "
          f"fused LayerNorm operators (self CPU)")
    for k in table["kernels"]:
        print(f"  dev  {k['device_us'] / 1e3:9.2f} ms x{k['calls']:6.1f}  {k['kernel']}")
    for o in table["host_ops"]:
        print(f"  host {o['self_cpu_us'] / 1e3:9.2f} ms x{o['calls']:6.1f}  {o['op']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
