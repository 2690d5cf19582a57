"""Engine: the training step on one device.

Counterpart of ``paddlefleetx_tpu/core/engine.py``, narrowed to
``__init__`` and ``train_step`` (``_build_train_step:718-932``).  One call
of :meth:`Engine.train_step` takes a host batch (numpy ``tokens``,
``labels``, ``loss_mask``, ``position_ids``) and:

  - splits it into ``Engine.accumulate_steps`` micro-batches, runs forward
    and backward on each and takes the mean of the grads and the losses
    (float32 grads: the parameters are float32 masters);
  - takes the float32 global grad norm; when it is not finite the step is
    skipped: the parameters and the optimizer state (its step counts
    included) stay as they were, so the learning rate and Adam's bias
    correction follow the optimizer's own count, while the ``lr`` metric
    follows the engine step, as in the JAX engine;
  - otherwise applies the optimizer update (clip, AdamW, schedule).

It returns ``loss``, ``grad_norm``, ``lr`` and ``found_inf`` as floats.
Reading ``found_inf`` on the host is the step's one synchronisation.

Refused with ``NotImplementedError``: fp16 loss scaling,
``mix_precision.main_grad: False``, QAT (``Compress.Quantization``),
optimizer offload, any parallel degree above 1 (``utils/config.py``) and
model statistics (``Engine.logging.model_stats_every``).  ``fit``,
``evaluate``, ``save``/``load``, resilience and telemetry come with the
data path in a later slice; until then their config keys
(``max_steps``, ``eval_freq``, ``save_load``, ``resilience``,
``logging``, ``metrics_file``) are ignored.
"""

from typing import Dict, Optional, Union

import numpy as np
import torch

from paddlefleetx_tpu_torch.models.common import fold_in
from paddlefleetx_tpu_torch.models.gpt.model import GPTModel, check_trainable
from paddlefleetx_tpu_torch.optims.optimizer import (
    apply_updates,
    build_optimizer,
    global_norm_f32,
)
from paddlefleetx_tpu_torch.utils.device import resolve_device


def _check_precision(cfg, model_dtype: str) -> None:
    """The JAX engine's mixed-precision checks (``:296-313``), and the
    refusals of what the port does not have."""
    mix = cfg.get("Engine", {}).get("mix_precision", {}) or {}
    enable = bool(mix.get("enable", True))
    if (enable and str(mix.get("dtype", "bfloat16")) in ("float16", "fp16")) or \
            model_dtype in ("float16", "fp16"):
        raise NotImplementedError(
            "float16 training with dynamic loss scaling is not ported yet; use "
            "mix_precision.dtype=bfloat16"
        )
    main_grad = bool(mix.get("main_grad", True))
    if not enable and not main_grad and "main_grad" in mix:
        raise ValueError(
            "mix_precision.main_grad=False requires mix_precision.enable=True "
            "(main_grad only controls the AMP gradient dtype)"
        )
    if enable and "dtype" in mix and model_dtype and model_dtype != str(mix["dtype"]):
        raise ValueError(
            f"Model.dtype={model_dtype} contradicts mix_precision.dtype="
            f"{mix['dtype']}: pin one or make them agree (the model dtype wins, "
            "so the AMP request would be silently ignored)"
        )
    if enable and not main_grad:
        raise NotImplementedError(
            "mix_precision.main_grad=False (low-precision grads) is not ported "
            "yet; the port keeps float32 grads"
        )


def _check_unported(cfg) -> None:
    q = (cfg.get("Compress") or {}).get("Quantization") or {}
    if bool(q.get("enable", False)):
        raise NotImplementedError("QAT (Compress.Quantization) is not ported yet")
    sharding = (cfg.get("Distributed") or {}).get("sharding") or {}
    if bool(sharding.get("sharding_offload", sharding.get("offload", False))):
        raise NotImplementedError(
            "optimizer offload (Distributed.sharding.offload) is not ported yet"
        )
    eng = cfg.get("Engine", {})
    every = (eng.get("logging") or {}).get("model_stats_every", eng.get("model_stats_every"))
    if every is not None and int(every) > 0:
        raise NotImplementedError(
            "model statistics (model_stats_every > 0) are not ported yet; set it to 0"
        )


class Engine:
    """The train step of one GPT module on one device (the card unless
    ``device="cpu"``).  ``model`` replaces the seeded trainable model
    (tests load the JAX engine's weights through the bridge)."""

    def __init__(self, cfg, module, device: Optional[Union[str, torch.device]] = None,
                 model: Optional[GPTModel] = None):
        self.cfg = cfg
        self.module = module
        check_trainable(module.config)
        _check_precision(cfg, str(module.config.dtype))
        _check_unported(cfg)
        eng = cfg.Engine
        self.accumulate_steps = int(eng.get("accumulate_steps", 1))
        if cfg.Global.get("global_batch_size") is None:
            raise ValueError("Global.global_batch_size (or local_batch_size) is required")
        self.global_batch_size = int(cfg.Global.global_batch_size)
        self.seed = int(cfg.Global.get("seed", 1024))
        self.device = resolve_device(device)
        if model is None:
            model = module.init_params(self.seed, self.device)
        elif not model.trainable:
            raise ValueError("Engine needs a trainable model (GPTModel(cfg, trainable=True))")
        self.model = model.to(self.device)
        self.params: Dict[str, torch.Tensor] = dict(self.model.named_parameters())
        # use_increments schedules count samples: scaled inside build_optimizer
        self.tx, self.schedule = build_optimizer(
            cfg.Optimizer, count_scale=self.global_batch_size
        )
        self.opt_state = self.tx.init(self.params)
        self.step = 0

    def _device_batch(self, host_batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in host_batch.items() if v is not None}

    def train_step(self, host_batch) -> Dict[str, float]:
        """One optimizer step on ``host_batch``; returns the step's metrics."""
        batch = self._device_batch(host_batch)
        accum = self.accumulate_steps
        bsz = batch["tokens"].shape[0]
        if bsz % accum:
            raise ValueError(f"batch {bsz} not divisible by accumulate_steps {accum}")
        mb = bsz // accum
        # per-step dropout stream, the same for every micro-batch (as the
        # JAX engine's step key)
        step_seed = fold_in(self.seed, self.step)
        for p in self.params.values():
            p.grad = None
        loss_sum = None
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = self.module.loss_fn(self.model, micro, dropout_seed=step_seed, train=True)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        grads = {n: p.grad if accum == 1 else p.grad / accum for n, p in self.params.items()}
        loss = loss_sum if accum == 1 else loss_sum / accum
        gnorm = global_norm_f32(grads)
        finite = bool(torch.isfinite(gnorm))
        if finite:
            updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
            apply_updates(self.params, updates)
        for p in self.params.values():
            p.grad = None
        metrics = {
            "loss": float(loss),
            "grad_norm": float(gnorm),
            "lr": float(self.schedule(self.step)),
            "found_inf": 0.0 if finite else 1.0,
        }
        self.step += 1
        return metrics
