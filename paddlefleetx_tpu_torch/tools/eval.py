"""Evaluation CLI of the PyTorch port.

    python -m paddlefleetx_tpu_torch.tools.eval \\
        -c configs/gpt/pretrain_gpt_345M_single.yaml \\
        -o Model.module=GPTEvalModule -o Engine.save_load.ckpt_dir=DIR [-o ...]

Counterpart of ``tools/eval.py:34-54``: read the config, build the module
``Model.module`` names (``GPTEvalModule`` streams per-sequence rows into
its metric: perplexity and sequence accuracy; ``GPTModule`` reports the
loss), the engine, restore ``Engine.save_load.ckpt_dir`` when it is set,
build the Eval loader and run ``Engine.evaluate`` over
``Engine.eval_iters`` batches.  Prints one JSON line, ``{"eval_loss": ..,
"batches": .., "metric": {..}}`` (the metric's values when the module has
one).

The run is on the card (``--device cuda``, the default) and fails
without one; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json

from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import build_module
from paddlefleetx_tpu_torch.data.builders import build_dataloader
from paddlefleetx_tpu_torch.models.metrics import format_metric
from paddlefleetx_tpu_torch.utils.config import get_config
from paddlefleetx_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.eval")
    ap.add_argument("-c", "--config", required=True, help="config file path")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="override config option key.sub=value (repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config, overrides=args.override)
    module = build_module(cfg)
    engine = Engine(cfg, module, device=device)
    ckpt_dir = (cfg.Engine.get("save_load") or {}).get("ckpt_dir")
    if ckpt_dir:
        engine.load(ckpt_dir)
    loader = build_dataloader(cfg, "Eval")
    iters = int(cfg.Engine.get("eval_iters", 10))
    loss = engine.evaluate(loader, iters=iters)
    metric = engine.last_metric
    print(json.dumps({"eval_loss": loss, "batches": iters,
                      "metric": format_metric(metric) if metric is not None else {}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
