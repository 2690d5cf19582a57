"""LR schedules: functions ``count -> lr``, copied from
``paddlefleetx_tpu/optims/lr_scheduler.py`` (the six schedules and
``build_lr_scheduler:128``).

Each schedule does the JAX package's float32 arithmetic on a 0-d float32
tensor, so the two packages agree to float32 rounding.  The caller picks
the counter: ``optims/optimizer.build_optimizer`` scales it for
``use_increments``.
"""

import math
from typing import Callable, Optional

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_annealing_with_warmup_decay(
    max_lr: float,
    min_lr: float,
    warmup_rate: Optional[float] = None,
    decay_steps: int = 0,
    warmup_steps: Optional[int] = None,
    **_unused,
) -> Schedule:
    """Linear warmup to max_lr, cosine decay to min_lr; ``warmup_rate`` is
    the fraction of decay_steps spent warming up."""
    if warmup_steps is None:
        warmup_steps = int((warmup_rate or 0.0) * decay_steps)

    def schedule(count):
        count = _f32(count)
        warm = max_lr * count / max(warmup_steps, 1)
        frac = torch.clamp((count - warmup_steps) / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_lr + 0.5 * (max_lr - min_lr) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(count < warmup_steps, warm, cos)

    return schedule


def linear_decay_with_warmup(
    learning_rate: float, total_steps: int, warmup: float = 0.1, **_unused
) -> Schedule:
    """Linear warmup, then linear decay to 0."""
    warmup_steps = int(warmup * total_steps) if warmup < 1 else int(warmup)

    def schedule(count):
        count = _f32(count)
        warm = learning_rate * count / max(warmup_steps, 1)
        decay = learning_rate * torch.clamp(
            (total_steps - count) / max(total_steps - warmup_steps, 1), min=0.0
        )
        return torch.where(count < warmup_steps, warm, decay)

    return schedule


def vit_lr_scheduler(
    learning_rate: float,
    total_steps: int = 0,
    warmup_steps: int = 0,
    decay_type: str = "cosine",
    linear_end: float = 1e-5,
    **_unused,
) -> Schedule:
    """Warmup, then cosine or linear decay to ``linear_end``."""

    def schedule(count):
        count = _f32(count)
        warm = learning_rate * count / max(warmup_steps, 1)
        frac = torch.clamp((count - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        if decay_type == "cosine":
            main = linear_end + 0.5 * (learning_rate - linear_end) * (
                1.0 + torch.cos(math.pi * frac)
            )
        else:
            main = learning_rate + (linear_end - learning_rate) * frac
        return torch.where(count < warmup_steps, warm, main)

    return schedule


def multi_step_decay(
    learning_rate: float, milestones=(30, 60, 90), gamma: float = 0.1, **_unused
) -> Schedule:
    """Multiply by ``gamma`` at each milestone passed."""
    ms = _f32(sorted(milestones))

    def schedule(count):
        n = (_f32(count) >= ms).sum().to(torch.int32)
        return learning_rate * _f32(gamma) ** n

    return schedule


def cosine_decay(learning_rate: float, total_steps: int, **_unused) -> Schedule:
    """Plain cosine to 0."""

    def schedule(count):
        frac = torch.clamp(_f32(count) / max(total_steps, 1), 0.0, 1.0)
        return 0.5 * learning_rate * (1.0 + torch.cos(math.pi * frac))

    return schedule


def constant(learning_rate: float, **_unused) -> Schedule:
    return lambda count: _f32(learning_rate)


LR_SCHEDULERS = {
    "CosineAnnealingWithWarmupDecay": cosine_annealing_with_warmup_decay,
    "LinearDecayWithWarmup": linear_decay_with_warmup,
    "ViTLRScheduler": vit_lr_scheduler,
    "MultiStepDecay": multi_step_decay,
    "CosineDecay": cosine_decay,
    "Constant": constant,
}


def build_lr_scheduler(cfg) -> Schedule:
    """From the YAML ``Optimizer.lr`` block."""
    cfg = dict(cfg)
    name = cfg.pop("name")
    if name not in LR_SCHEDULERS:
        raise KeyError(f"unknown lr scheduler {name!r}; known: {sorted(LR_SCHEDULERS)}")
    return LR_SCHEDULERS[name](**cfg)
