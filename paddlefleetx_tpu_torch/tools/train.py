"""Training CLI of the PyTorch port.

    python -m paddlefleetx_tpu_torch.tools.train \\
        -c configs/gpt/pretrain_gpt_345M_single.yaml [-o key=value ...]

Counterpart of ``tools/train.py:26-144``: read the config, build the
module and the engine, resume if asked (``Engine.save_load.ckpt_dir``, or
``auto_resume`` from the newest restorable ``step_N`` under
``output_dir``), build the train and eval loaders from the restored
``consumed_samples``, run ``Engine.fit``, report the data pipeline's
skips and waits, and save at the end when ``save_steps`` is set.
SIGTERM/SIGINT checkpoint with a ``preempted`` marker and exit 0, so a
relaunch with ``auto_resume`` continues; ``--exit-after-save`` stops
cleanly after the next periodic checkpoint.

The run is on the card (``--device cuda``, the default) and fails
without one; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse

from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.data.builders import build_dataloader
from paddlefleetx_tpu_torch.utils.checkpoint import latest_checkpoint, resume_with_fallback
from paddlefleetx_tpu_torch.utils.config import get_config
from paddlefleetx_tpu_torch.utils.device import resolve_device
from paddlefleetx_tpu_torch.utils.log import logger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.train")
    ap.add_argument("-c", "--config", required=True, help="config file path")
    ap.add_argument("-o", "--override", action="append", default=[],
                    help="override config option key.sub=value (repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; fails without a card) or cpu")
    ap.add_argument("--exit-after-save", action="store_true",
                    help="stop cleanly (exit 0) right after the next periodic checkpoint")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config, overrides=args.override)
    module = GPTModule(cfg)

    save_load = cfg.Engine.get("save_load") or {}
    output_dir = save_load.get("output_dir") or "./output"
    ckpt_dir = save_load.get("ckpt_dir")
    auto_resume = not ckpt_dir and bool(save_load.get("auto_resume"))
    # side-effect-free peek: does a resume have something to restore?
    resuming = auto_resume and latest_checkpoint(output_dir, quarantine=False) is not None
    if resuming and save_load.get("pretrained_params"):
        # the resume load replaces the params wholesale: skip the warm start
        logger.info("pretrained_params skipped: resume checkpoint takes over")
        cfg.Engine.save_load.pretrained_params = None

    engine = Engine(cfg, module, device=device)
    if args.exit_after_save:
        engine.exit_after_save = True
    if ckpt_dir:
        engine.load(ckpt_dir)
    elif auto_resume:
        loaded = resume_with_fallback(engine, output_dir)
        if loaded is None and resuming:
            raise RuntimeError(
                f"auto_resume: checkpoints exist under {output_dir} but none restored (see "
                "the QUARANTINED logs); refusing to silently restart from scratch: inspect "
                "or remove the *.corrupt dirs, or disable auto_resume to start over"
            )
    # loaders built after the load, so the sampler resumes the data order
    train_loader = build_dataloader(cfg, "Train", consumed_samples=engine._consumed_samples)
    eval_loader = None
    if "Eval" in (cfg.get("Data") or {}) and engine.eval_freq:
        eval_loader = build_dataloader(cfg, "Eval")
    engine.fit(train_loader, eval_loader)
    engine.wait_for_save()  # an asynchronous save's write error fails the run here

    skips = int(getattr(train_loader, "skips", 0) or 0)
    if skips:
        logger.warning(f"run finished with {skips} corrupt sample(s) skipped (data_skip "
                       "events in the metrics stream): inspect the shard before the next run")
    wait = train_loader.stats().get("data_wait_s", 0)
    if wait:
        logger.info(f"host data pipeline: {wait}s total step wait")
    if engine.preempted:
        logger.info("clean early exit: final checkpoint saved; exiting 0")
        return 0
    if engine.save_steps and engine._last_good_ckpt != engine.checkpoint_path():
        engine.save()
        engine.wait_for_save()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
