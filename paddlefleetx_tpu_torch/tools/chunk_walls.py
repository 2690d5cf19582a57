"""Time the chunk-path servers of ``chip_smoke.py`` from one checkout, to
compare two checkouts on one card.

    python -m paddlefleetx_tpu_torch.tools.chunk_walls [--repo DIR] [--label NAME]

Runs ``serve_prefix`` (phase 18: ``--prefill-chunk 256`` with the prefix
cache and its spill tier) and ``serve_tenants`` (phase 20: two tenants and
a priority preemption resumed as a prefix hit) of DIR's ``chip_smoke.py``
against DIR's own code, bf16 and int8 KV, with that script's checks.
Prints one JSON line: each run's boot and traffic walls, the server's time
to first token (p50 and p99 of its last ``/healthz``) and its K9 launch
counts.  Needs the card; DIR defaults to this checkout.  To compare a
parent with a change, unpack the parent into a git-ignored directory and
run parent, change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def load_smoke(repo: Path):
    """DIR's chip_smoke.py as a module, its ``http`` wrapped to keep the
    last ``/healthz`` answer (the server's final one when a run returns)."""
    spec = importlib.util.spec_from_file_location(f"chip_smoke_{abs(hash(repo))}",
                                                  repo / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    http, last = mod.http, {}

    def keep(port, path, body=None, timeout=600):
        out = http(port, path, body, timeout)
        if path == "/healthz":
            last["health"] = out
        return out

    mod.http = keep
    return mod, last


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO), help="checkout whose chip_smoke.py and code run")
    ap.add_argument("--label", default="", help="name printed with the numbers")
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    smoke, last = load_smoke(repo)
    env = dict(os.environ, PYTHONPATH=str(repo))
    runs = {}
    for phase, serve in (("prefix", smoke.serve_prefix), ("tenants", smoke.serve_tenants)):
        for kv in ("", "int8"):
            t0 = time.time()
            kernels, info = serve(kv, env)
            health = last["health"]
            runs[f"{phase}_{kv or 'bf16'}"] = {
                "boot_s": info["boot_s"], "traffic_s": info["traffic_s"],
                "run_s": time.time() - t0, "ttft_p50_s": health.get("ttft_p50_s"),
                "ttft_p99_s": health.get("ttft_p99_s"),
                "kernels": {k: v for k, v in kernels.items() if k.startswith("paged") and v}}
    out = {"label": args.label, "repo": str(repo), "runs": runs}
    print("chunk_walls " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
