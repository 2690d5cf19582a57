"""Engine: training on one device — the step, the loop, evaluation and
checkpoints.

Counterpart of ``paddlefleetx_tpu/core/engine.py`` on one device:
``train_step`` (``_build_train_step:718-932``), ``fit:1193`` with
``_fit_loop:1410``, ``evaluate:1717`` and its step (``_build_eval_step:954``),
``save:1858``, ``load:1969``, ``_rollback:1274``, ``_preempt_save:1373`` and
``_build_anomaly_guard:1260``.

One call of :meth:`Engine.train_step` takes a host batch (numpy
``tokens``, ``labels``, ``loss_mask``, ``position_ids``) and:

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

:meth:`Engine.fit` runs steps up to ``Engine.max_steps`` over a loader,
writes a metrics record every ``logging_freq`` steps (JSON lines to
``Engine.metrics_file`` when set: ``step``, ``loss``, ``lr``,
``grad_norm``, ``ips`` = ``tokens_per_sec``, ``consumed_samples``,
``data_wait_s``, ``host_s``, ``step_s``, ``compile_s`` once,
``model_flops``, ``mfu`` where the card's peak is known, the loader's
stats, a ``mem`` block with the card's peak memory, and the port's own
``tokens_digest`` of the logged step's tokens and ``kernels``, the
window's kernel launches and plain-version calls), evaluates every
``eval_freq`` steps, saves every ``save_load.save_steps`` steps (keeping
``keep_last_n``), rolls back to the last checkpoint when the anomaly
guard (``Engine.resilience``) trips, and on SIGTERM/SIGINT finishes the
step, saves with a ``preempted`` marker and returns with
``self.preempted`` set.  The port's timings: the step ends in a host read
of its metrics, so ``host_s`` counts the batch's placement on the device
only, and ``compile_s`` is the first step's wall (the kernels' build at
first use and the card's lazy set-up), kept out of the throughput window.

The checkpoint is the port's own format (``utils/checkpoint.py``):
``step_N/state.pt`` (params and optimizer state, ``torch.save``) written
first, then an atomic ``meta.json`` with the JAX engine's keys (``step``,
``consumed_samples``, ``loader``, ``preempted``).

Refused with ``NotImplementedError``: fp16 loss scaling,
``mix_precision.main_grad: False``, QAT (``Compress.Quantization``),
optimizer offload, any parallel degree above 1 (``utils/config.py``),
model statistics (``Engine.logging.model_stats_every``), the
``Profiler`` block, ``consistency_check_freq``, asynchronous saves
(``save_load.async_save``), warm starts from ``save_load.pretrained_params``,
fault injection (``PFX_FAULT``) and the tracing and flight-recorder
observability (``PFX_TRACE_SAMPLE``, ``PFX_FLIGHT_RECORDER``).
"""

import hashlib
import json
import os
import pickle
import time
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from paddlefleetx_tpu_torch.models.common import fold_in
from paddlefleetx_tpu_torch.models.gpt.model import GPTModel, check_trainable
from paddlefleetx_tpu_torch.ops import flash_attention, fused_layernorm
from paddlefleetx_tpu_torch.optims.optimizer import (
    apply_updates,
    build_optimizer,
    global_norm_f32,
)
from paddlefleetx_tpu_torch.utils.checkpoint import (
    META,
    PAYLOAD,
    CorruptCheckpoint,
    gc_checkpoints,
)
from paddlefleetx_tpu_torch.utils.device import resolve_device
from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.resilience import AnomalyGuard, PreemptionGuard
from paddlefleetx_tpu_torch.utils.telemetry import model_flops_per_token, peak_flops

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
    if bool((cfg.get("Profiler") or {}).get("enable", False)):
        raise NotImplementedError(
            "the Profiler block is not ported yet (tools/profile_train.py traces the "
            "step with torch.profiler); set Profiler.enable=False"
        )
    if int(eng.get("consistency_check_freq", 0) or 0) > 0:
        raise NotImplementedError(
            "consistency_check_freq > 0: cross-replica checks come with the parallel "
            "layouts; the port trains on one device"
        )
    save_load = eng.get("save_load") or {}
    if bool(save_load.get("async_save", False)):
        raise NotImplementedError(
            "save_load.async_save is not ported yet; the port saves synchronously"
        )
    if save_load.get("pretrained_params"):
        raise NotImplementedError(
            "save_load.pretrained_params: warm starts from a params checkpoint (the JAX "
            "package's orbax format) are not ported yet"
        )
    for var, what in (("PFX_FAULT", "fault injection"),
                      ("PFX_TRACE_SAMPLE", "sampled tracing"),
                      ("PFX_FLIGHT_RECORDER", "the flight recorder")):
        raw = (os.environ.get(var) or "").strip()
        if raw and raw != "0":
            raise NotImplementedError(f"{var}={raw!r}: {what} is not ported yet; unset it")


class Engine:
    """Training of one GPT module on one device (the card unless
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

        # the loop's settings (JAX Engine.__init__:150-195)
        self.max_steps = int(eng.get("max_steps", 0) or 0)
        self.eval_freq = int(eng.get("eval_freq", 0) or 0)
        self.eval_iters = int(eng.get("eval_iters", 10))
        self.logging_freq = int(eng.get("logging_freq", 10))
        save_load = eng.get("save_load") or {}
        self.save_steps = int(save_load.get("save_steps", 0) or 0)
        self.output_dir = save_load.get("output_dir") or "./output"
        self.keep_last_n = int(save_load.get("keep_last_n", 0) or 0)
        self.exit_after_save = bool(eng.get("exit_after_save", False))
        self.metrics_file = eng.get("metrics_file", "") or ""
        res = eng.get("resilience") or {}
        self.res_enable = bool(res.get("enable", True))
        self.res_max_skip_streak = int(res.get("max_skip_streak", 10))
        self.res_spike_zscore = float(res.get("loss_spike_zscore", 0.0))
        self.res_spike_streak = int(res.get("loss_spike_streak", 5))
        self.res_loss_window = int(res.get("loss_window", 64))
        self.res_max_rollbacks = int(res.get("max_rollbacks", 2))
        self._flops_per_token = model_flops_per_token(module.config)
        self._peak_flops = peak_flops(self.device)
        self._consumed_samples = 0
        self._train_loader = None  # held during fit: checkpoint meta, rollback rewind
        self._loader_state = None  # loader state of a restored checkpoint's meta
        self._last_good_ckpt: Optional[str] = None
        self._resumed = False
        self._metrics_mode: Optional[str] = None
        self._compile_s: Optional[float] = None
        self._compile_emitted = False
        self._placement_s = 0.0
        self.preempted = False

    def _device_batch(self, host_batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in host_batch.items() if v is not None}

    def train_step(self, host_batch) -> Dict[str, float]:
        """One optimizer step on ``host_batch``; returns the step's metrics."""
        t0 = time.monotonic()
        batch = self._device_batch(host_batch)
        self._placement_s = time.monotonic() - t0
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

    # ------------------------------------------------------------------
    # Evaluation (JAX evaluate:1717, eval step _build_eval_step:954)

    @torch.no_grad()
    def eval_step(self, host_batch, eval_it: int) -> float:
        """The module's loss with ``train=False`` on one eval batch (the
        dropout seed folded with the step and the batch index, as the JAX
        eval key is)."""
        batch = self._device_batch(host_batch)
        seed = fold_in(fold_in(self.seed, self.step), eval_it)
        return float(self.module.loss_fn(self.model, batch, dropout_seed=seed, train=False))

    def evaluate(self, loader: Iterable, iters: Optional[int] = None,
                 on_empty: str = "raise") -> float:
        """The mean eval loss over up to ``iters`` batches (default
        ``Engine.eval_iters``).  A loader that yields nothing raises
        (``on_empty="raise"``) or logs and writes an ``eval_empty`` event
        and returns nan (``"event"``, the periodic eval inside fit)."""
        if on_empty not in ("raise", "event"):
            raise ValueError(f"on_empty={on_empty!r}: use 'raise' or 'event'")
        iters = iters if iters is not None else self.eval_iters
        losses = []
        it = iter(loader)
        try:
            for i, batch in enumerate(it):
                if i >= iters:
                    break
                losses.append(self.eval_step(batch, i))
        finally:
            # a stream made here from a loader is ours to close; the
            # caller's long-lived iterator (iter(it) is it) stays live
            if it is not loader:
                close = getattr(loader, "close", None)
                if callable(close):
                    close()
        if not losses:
            msg = (f"evaluate saw ZERO batches (iters={iters}): the eval loader is empty "
                   "or exhausted")
            if on_empty == "raise":
                raise RuntimeError(msg)
            logger.error(msg)
            self._write_metrics({"event": "eval_empty", "step": self.step, "iters": iters})
            return float("nan")
        avg = float(np.mean(losses))
        logger.info(f"eval loss: {avg:.5f} (ppl {np.exp(min(avg, 20.0)):.2f})")
        return avg

    # ------------------------------------------------------------------
    # The training loop (JAX fit:1193, _fit_loop:1410)

    def _write_metrics(self, record: Dict) -> None:
        """One JSON line to ``Engine.metrics_file`` (when set): a fresh run
        truncates it, a run resumed from a checkpoint appends."""
        if not self.metrics_file:
            return
        mode = self._metrics_mode or ("a" if self._resumed else "w")
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.metrics_file)), exist_ok=True)
            with open(self.metrics_file, mode) as f:
                f.write(json.dumps(record) + "\n")
            self._metrics_mode = "a"
        except OSError as e:
            logger.warning(f"metrics_file write failed (disabling): {e}")
            self.metrics_file = ""

    def _sample_memory(self, record: Dict) -> None:
        """The ``mem`` block: on the card the bytes allocated now and the
        peak since fit began (``torch.cuda.max_memory_allocated``, reset
        at the start of fit); on the CPU the process's resident bytes."""
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
            record["mem"] = {"device_in_use_bytes": torch.cuda.memory_allocated(self.device),
                             "device_peak_bytes": peak, "fit_peak_bytes": peak}
        elif os.path.exists("/proc/self/statm"):
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            record["mem"] = {"host_rss_bytes": pages * os.sysconf("SC_PAGE_SIZE")}

    def _drain_skip_events(self, loader) -> None:
        """Move the loader's ``data_skip`` events into the metrics stream,
        stamped with the coming step."""
        events = getattr(loader, "skip_events", None)
        while events:
            ev = dict(events.pop(0))
            ev.setdefault("step", self.step + 1)
            self._write_metrics(ev)

    def _build_anomaly_guard(self) -> Optional[AnomalyGuard]:
        if not self.res_enable or (self.res_max_skip_streak <= 0
                                   and self.res_spike_zscore <= 0):
            return None
        return AnomalyGuard(max_skip_streak=self.res_max_skip_streak,
                            spike_zscore=self.res_spike_zscore,
                            spike_streak=self.res_spike_streak, window=self.res_loss_window)

    def fit(self, train_loader: Iterable, eval_loader: Optional[Iterable] = None) -> GPTModel:
        """Train up to ``Engine.max_steps`` steps over ``train_loader``,
        evaluating on ``eval_loader`` every ``eval_freq`` steps.  The
        engine holds the train loader for the checkpoint meta and rewinds
        it on a rollback; both loaders are closed on the way out.
        SIGTERM/SIGINT end the loop after the step in flight with a
        checkpoint marked ``preempted`` (``self.preempted`` set)."""
        if self.max_steps <= 0:
            raise ValueError("Engine.max_steps must be > 0 to fit")
        eval_iter = iter(eval_loader) if eval_loader is not None else None
        self._train_loader = train_loader
        # a restored checkpoint's loader state (the skip budget spent); the
        # position itself came in through consumed_samples when the loader
        # was built, and a stale entry must not reach a later fit
        loader_state, self._loader_state = self._loader_state, None
        if loader_state and hasattr(train_loader, "load_state"):
            train_loader.load_state(loader_state)
        self.preempted = False
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        preempt = PreemptionGuard().install()
        try:
            self._fit_loop(train_loader, eval_iter, preempt)
        finally:
            preempt.uninstall()
            for ldr in (train_loader, eval_loader):
                close = getattr(ldr, "close", None)
                if callable(close):
                    close()
        return self.model

    def _fit_loop(self, train_loader, eval_iter, preempt) -> None:
        guard = self._build_anomaly_guard()
        tokens_per_sample = self.module.tokens_per_sample
        t_last = time.time()
        window_tokens = steps_in_window = 0
        data_wait_total = host_total = 0.0
        # the guard reads a step's metrics after the next step ran (the
        # JAX loop's one-step lag behind its asynchronous dispatch), so a
        # rollback lands on the same step and stream position as there
        prev_metrics = None
        rollbacks = 0
        window_counts = _kernel_counts()
        data_iter = iter(train_loader)
        while True:
            try:
                t_fetch = time.monotonic()
                batch = next(data_iter)
                data_wait_total += time.monotonic() - t_fetch
            except StopIteration:
                break
            if self.step >= self.max_steps:
                break
            self._drain_skip_events(train_loader)
            step_before = self.step
            t_step = time.monotonic()
            metrics = self.train_step(batch)
            first = self._compile_s is None
            if first:
                self._compile_s = time.monotonic() - t_step
                t_last = time.time()
            else:
                host_total += self._placement_s
            if guard is not None and prev_metrics is not None:
                reason = guard.observe(prev_metrics["loss"], prev_metrics["found_inf"] > 0)
                if reason is not None:
                    # the step just run is discarded with the anomalous
                    # state: load() restores the params, the optimizer,
                    # the step and consumed_samples
                    rewound = self._rollback(step_before, reason, rollbacks)
                    rollbacks += 1
                    guard.reset()
                    prev_metrics = None
                    if rewound:
                        data_iter = iter(train_loader)
                    continue
            if guard is not None:
                prev_metrics = metrics
            self._consumed_samples += self.global_batch_size
            if not first:  # the first step's wall is compile_s, not throughput
                window_tokens += self.global_batch_size * tokens_per_sample
                steps_in_window += 1
            step = self.step

            if step % self.logging_freq == 0:
                dt = time.time() - t_last
                ips = window_tokens / dt if steps_in_window else 0.0
                logger.info(
                    f"step {step}/{self.max_steps} loss: {metrics['loss']:.5f} "
                    f"lr: {metrics['lr']:.3e} grad_norm: {metrics['grad_norm']:.3f} "
                    f"ips: {ips:,.0f} tokens/s"
                )
                record = {
                    "step": step, "loss": metrics["loss"], "lr": metrics["lr"],
                    "grad_norm": metrics["grad_norm"], "ips": round(ips, 1),
                    "consumed_samples": self._consumed_samples,
                    "tokens_per_sec": round(ips, 1),
                    "data_wait_s": round(data_wait_total, 3),
                    "host_s": round(host_total, 3),
                    "step_s": round(dt / max(1, steps_in_window), 4),
                }
                if not self._compile_emitted:
                    record["compile_s"] = round(self._compile_s, 3)
                    self._compile_emitted = True
                if self._flops_per_token:
                    model_fps = ips * self._flops_per_token
                    record["model_flops"] = round(model_fps, 1)
                    if self._peak_flops:
                        record["mfu"] = round(model_fps / self._peak_flops, 6)
                stats_fn = getattr(train_loader, "stats", None)
                if callable(stats_fn):
                    record.update((k, v) for k, v in stats_fn().items()
                                  if k in ("data_wait_s", "prefetch_depth", "stall_warnings",
                                           "skips"))
                # the port's own keys: the logged step's tokens (resume
                # checks compare streams by it) and the kernel launches of
                # the window (plain versions included)
                record["tokens_digest"] = hashlib.sha1(
                    np.ascontiguousarray(batch["tokens"]).tobytes()).hexdigest()[:16]
                counts = _kernel_counts()
                record["kernels"] = {k: v - window_counts.get(k, 0) for k, v in counts.items()}
                window_counts = counts
                self._sample_memory(record)
                self._write_metrics(record)
                t_last = time.time()
                window_tokens = steps_in_window = 0

            if self.eval_freq and eval_iter is not None and step % self.eval_freq == 0:
                self.evaluate(eval_iter, iters=self.eval_iters, on_empty="event")
                t_last = time.time()
                window_tokens = steps_in_window = 0

            if self.save_steps and step % self.save_steps == 0:
                self.save()
                # a save while the stream is healthy proves recovery: the
                # rollback budget guards against thrash, not against
                # anomalies far apart
                if guard is None or (guard.skip_streak == 0 and guard.spike_streak == 0):
                    rollbacks = 0
                t_last = time.time()
                window_tokens = steps_in_window = 0
                if self.exit_after_save:
                    logger.info(f"exit_after_save: checkpoint at step {step} complete, "
                                "exiting cleanly")
                    self.preempted = True
                    break

            if preempt is not None and preempt.requested:
                self._preempt_save(step, "preemption signal")
                break

    def _rollback(self, step: int, reason: str, rollbacks: int) -> bool:
        """Restore params and optimizer state from the last good checkpoint
        after an anomaly.  Past ``resilience.max_rollbacks``, or with no
        checkpoint, the run fails loudly.  Returns True when the train
        loader was rewound to the checkpoint's position (the caller
        re-iterates it and the window replays token for token); False
        when it cannot rewind and keeps its live position."""
        if self._last_good_ckpt is None:
            raise RuntimeError(
                f"anomaly budget exceeded at step {step} ({reason}) and no checkpoint "
                "exists to roll back to: enable periodic saves "
                "(Engine.save_load.save_steps) or disable the guard "
                "(Engine.resilience.enable=False)"
            )
        if rollbacks >= self.res_max_rollbacks:
            raise RuntimeError(
                f"anomaly budget exceeded at step {step} ({reason}) after {rollbacks} "
                f"rollback(s): max_rollbacks={self.res_max_rollbacks} exhausted; the run is "
                "not recovering, stopping instead of thrashing"
            )
        loader = self._train_loader
        rewindable = loader is not None and hasattr(loader, "rewind")
        logger.error(f"ANOMALY at step {step}: {reason}; rolling back to "
                     f"{self._last_good_ckpt} (rollback {rollbacks + 1}/"
                     f"{self.res_max_rollbacks})")
        self._write_metrics({"event": "rollback", "step": step, "reason": reason,
                             "ckpt": self._last_good_ckpt, "rollback_index": rollbacks + 1,
                             "rewound": bool(rewindable)})
        # without a rewind the stream keeps its live position: every step
        # served so far plus the discarded batch
        live_consumed = self._consumed_samples + self.global_batch_size
        self.load(self._last_good_ckpt)
        loader_state, self._loader_state = self._loader_state, None
        if rewindable:
            if loader_state and hasattr(loader, "load_state"):
                loader.load_state(loader_state)
            else:
                loader.rewind(self._consumed_samples)
            logger.warning(f"data stream rewound to consumed_samples={self._consumed_samples} "
                           "for a token-for-token replay")
            return True
        self._consumed_samples = live_consumed
        return False

    def _preempt_save(self, step: int, cause: str) -> None:
        """The final checkpoint of a clean early exit, marked
        ``preempted``; when the periodic save already wrote this step,
        only its meta is re-stamped."""
        logger.warning(f"{cause} at step {step}: writing final checkpoint, then exiting "
                       "cleanly for auto-resume")
        expected = self.checkpoint_path()
        if self._last_good_ckpt == expected:
            with open(os.path.join(expected, META)) as f:
                meta = json.load(f)
            meta["preempted"] = True
            self._write_meta(expected, meta)
            path = expected
            logger.info(f"preempt marker stamped on existing {expected}")
        else:
            path = self.save(preempted=True)
        self._write_metrics({"event": "preempt_save", "step": step, "cause": cause,
                             "ckpt": path})
        self.preempted = True

    # ------------------------------------------------------------------
    # Checkpoints (JAX save:1858, load:1969)

    def checkpoint_path(self) -> str:
        """``output_dir/step_<step>``, where :meth:`save` writes by default."""
        return os.path.abspath(os.path.join(self.output_dir, f"step_{self.step}"))

    @staticmethod
    def _write_meta(path: str, meta: Dict[str, Any]) -> None:
        """meta.json marks a complete checkpoint: written last, atomically."""
        tmp = os.path.join(path, META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, META))

    def save(self, path: Optional[str] = None, preempted: bool = False) -> str:
        """Checkpoint params, optimizer state and the stream position into
        ``path`` (default ``output_dir/step_<step>``); returns the path.
        The payload is written and renamed into place before the meta, and
        a stale meta is removed first, so a crash mid-save never leaves a
        directory that looks complete."""
        step = self.step
        path = os.path.abspath(path or self.checkpoint_path())
        os.makedirs(path, exist_ok=True)
        meta_path = os.path.join(path, META)
        if os.path.exists(meta_path):
            os.remove(meta_path)
        payload = {"params": {n: p.detach() for n, p in self.params.items()},
                   "opt_state": self.opt_state}
        tmp = os.path.join(path, f"{PAYLOAD}.tmp{os.getpid()}")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, PAYLOAD))
        meta: Dict[str, Any] = {"step": step, "consumed_samples": self._consumed_samples}
        loader = self._train_loader
        if loader is not None and hasattr(loader, "state_dict"):
            # the engine's count, not the sampler's: a prefetching loader
            # runs ahead of the trained data by its lookahead
            loader_state = dict(loader.state_dict())
            loader_state["consumed_samples"] = self._consumed_samples
            skips_at = getattr(loader, "skips_at", None)
            if callable(skips_at):
                skips = skips_at(self._consumed_samples)
                if skips is not None:
                    loader_state["skips"] = skips
            meta["loader"] = loader_state
        if preempted:
            meta["preempted"] = True
        self._write_meta(path, meta)
        logger.info(f"saved checkpoint: {path}")
        self._last_good_ckpt = path
        if self.keep_last_n:
            try:
                gc_checkpoints(self.output_dir, self.keep_last_n, protect=path)
            except OSError as e:
                logger.warning(f"checkpoint retention GC failed: {e}")
        return path

    def load(self, path: str) -> None:
        """Restore a checkpoint written by :meth:`save`: params (copied into
        the live parameters), optimizer state, step, consumed_samples and
        the loader state (applied at the next fit).  Unreadable bytes raise
        :class:`~paddlefleetx_tpu_torch.utils.checkpoint.CorruptCheckpoint`;
        a checkpoint of another model or optimizer raises ``ValueError``."""
        path = os.path.abspath(path)
        try:
            with open(os.path.join(path, META)) as f:
                meta = json.load(f)
            payload = torch.load(os.path.join(path, PAYLOAD), map_location=self.device,
                                 weights_only=True)
        except torch.OutOfMemoryError:
            raise
        except (RuntimeError, EOFError, pickle.UnpicklingError, ValueError) as e:
            raise CorruptCheckpoint(f"checkpoint {path} unreadable: {e}") from e
        params = payload["params"]
        if set(params) != set(self.params) or any(
                params[n].shape != p.shape or params[n].dtype != p.dtype
                for n, p in self.params.items()):
            raise ValueError(f"checkpoint {path} holds other parameters than this model "
                             "(a different Model config?)")
        if _structure(payload["opt_state"]) != _structure(self.opt_state):
            raise ValueError(f"checkpoint {path} holds another optimizer's state (a "
                             "different Optimizer config?)")
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(params[n])
        self.opt_state = payload["opt_state"]
        self.step = int(meta["step"])
        self._consumed_samples = int(meta.get("consumed_samples", 0))
        self._loader_state = meta.get("loader")
        self._resumed = True
        self._last_good_ckpt = path
        logger.info(f"loaded checkpoint: {path} (step {self.step})")


def _kernel_counts() -> Dict[str, int]:
    """Launches of the training kernels and calls of their plain versions
    so far (``ops/flash_attention.COUNTS``, ``ops/fused_layernorm.COUNTS``)."""
    return {**flash_attention.COUNTS, **fused_layernorm.COUNTS}


def _structure(tree) -> Any:
    """The shape of an optimizer state: containers and tensor shapes."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return type(tree).__name__
