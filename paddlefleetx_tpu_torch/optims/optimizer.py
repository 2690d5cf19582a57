"""Optimizers: AdamW / FusedAdamW, Adam and Momentum with the float32
global-norm clip, as plain PyTorch tensor code.

Counterpart of ``paddlefleetx_tpu/optims/optimizer.py``, which chains
optax transformations.  The port keeps optax's shape, so the order of
operations is the reference's: a transformation is an ``(init, update)``
pair over dicts ``{parameter name: tensor}``; ``update(updates, state,
params)`` returns new updates and a new state and mutates neither, so a
caller that skips a step keeps the old state whole (its step counts
included).  AdamW is the clip, then Adam with bias correction, then
decoupled weight decay (masked), then the scheduled learning rate,
applied as ``p + u``.

Weight decay applies where the parameter has ``ndim > 1`` **in the JAX
layout** (``_no_decay_mask:27`` maps over the JAX tree, whose decoder
layer leaves are stacked on a leading ``[num_layers]`` axis).  So every
decoder-layer leaf is decayed, its LayerNorm and 1-D biases included,
and of the top-level leaves only ``final_ln``'s scale and bias are not.
:func:`decay_mask` computes that from the port's parameter names.

``moment_dtype: bfloat16`` and ``multi_precision: False`` are refused:
the port keeps float32 masters and float32 moments.
"""

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from paddlefleetx_tpu_torch.optims.lr_scheduler import Schedule, build_lr_scheduler

Params = Dict[str, Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Tuple[Params, Any]]


def decay_mask(params: Params) -> Dict[str, bool]:
    """True where weight decay applies: ``ndim > 1`` of the JAX-layout leaf
    (a ``layers.<i>.`` parameter has one more, stacked, dimension)."""
    return {n: p.dim() + (1 if n.startswith("layers.") else 0) > 1 for n, p in params.items()}


def sqsum_f32(x: Tensor) -> Tensor:
    """Sum of squares of one leaf, accumulated in float32."""
    return x.float().square().sum()


def global_norm_f32(tree: Params) -> Tensor:
    """Global L2 norm with the sum of squares in float32."""
    return torch.sqrt(sum(sqsum_f32(x) for x in tree.values()))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in txs)

    def update(updates, state, params):
        new_state = []
        for t, s in zip(txs, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm_f32(clip_norm: float) -> GradientTransformation:
    """Scale every update by min(1, clip / max(global norm, 1e-16)), the
    norm taken in float32."""

    def update(updates, state, params):
        g_norm = global_norm_f32(updates)
        scale = torch.clamp(clip_norm / torch.clamp(g_norm, min=1e-16), max=1.0)
        return {n: (u.float() * scale).to(u.dtype) for n, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32 (a float32 value, exact as a float)."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)


def scale_by_adam(b1: float, b2: float, eps: float) -> GradientTransformation:
    """optax.scale_by_adam: moments, then bias correction by 1 - b**t with
    t the count after this step."""

    def init(params):
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params):
        mu = {n: (1 - b1) * g + b1 * state["mu"][n] for n, g in updates.items()}
        nu = {n: (1 - b2) * (g * g) + b2 * state["nu"][n] for n, g in updates.items()}
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps) for n in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """u + weight_decay * p where :func:`decay_mask` is true."""

    def update(updates, state, params):
        use = decay_mask(params)
        return {n: (u + weight_decay * params[n]) if use[n] else u
                for n, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def scale_by_schedule(step_size: Callable[[int], Tensor]) -> GradientTransformation:
    """Multiply by the float32 ``step_size(count)``, count from 0 and
    advanced by one per update."""

    def update(updates, state, params):
        s = float(step_size(state["count"]))
        return {n: s * u for n, u in updates.items()}, {"count": state["count"] + 1}

    return GradientTransformation(lambda params: {"count": 0}, update)


def scale_by_learning_rate(schedule: Schedule) -> GradientTransformation:
    return scale_by_schedule(lambda count: -schedule(count))


def trace(decay: float) -> GradientTransformation:
    """Momentum: t = g + decay * t; the update is t."""

    def update(updates, state, params):
        new = {n: g + decay * state["trace"][n] for n, g in updates.items()}
        return new, {"trace": new}

    return GradientTransformation(
        lambda params: {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}, update
    )


def apply_updates(params: Params, updates: Params) -> None:
    """``p <- p + u`` in place."""
    with torch.no_grad():
        for n, p in params.items():
            p.add_(updates[n])


def _clip(grad_clip: Optional[float]):
    return [clip_by_global_norm_f32(grad_clip)] if grad_clip else []


def adamw(
    schedule: Schedule,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: Optional[float] = None,
    multi_precision: bool = True,
    moment_dtype: Optional[str] = None,
    **_unused,
) -> GradientTransformation:
    if moment_dtype not in (None, "", "float32"):
        raise NotImplementedError(
            f"Optimizer.moment_dtype={moment_dtype!r}: the PyTorch port keeps "
            "float32 moments (low-precision moments are not ported yet)"
        )
    if not multi_precision:
        raise NotImplementedError(
            "Optimizer.multi_precision=False: the PyTorch port keeps float32 "
            "master weights (low-precision params are not ported yet)"
        )
    return chain(
        *_clip(grad_clip),
        scale_by_adam(beta1, beta2, epsilon),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(schedule),
    )


def adam(
    schedule: Schedule,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
    grad_clip: Optional[float] = None,
    **_unused,
) -> GradientTransformation:
    return chain(*_clip(grad_clip), scale_by_adam(beta1, beta2, epsilon),
                 scale_by_learning_rate(schedule))


def momentum(
    schedule: Schedule,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
    **_unused,
) -> GradientTransformation:
    txs = _clip(grad_clip)
    if weight_decay:
        txs.append(add_decayed_weights(weight_decay))
    return chain(*txs, trace(momentum), scale_by_learning_rate(schedule))


OPTIMIZERS = {"AdamW": adamw, "FusedAdamW": adamw, "Adam": adam, "Momentum": momentum}


def build_optimizer(cfg, count_scale: int = 1) -> Tuple[GradientTransformation, Schedule]:
    """From the YAML ``Optimizer`` block: ``name``, the optimizer's own
    keys, ``lr`` (a schedule block, ``use_increments`` making it count
    samples: ``schedule(step * count_scale)``) and ``grad_clip`` (a
    ``ClipGradByGlobalNorm`` block or a bare number).  Returns (the
    transformation, the schedule it applies)."""
    cfg = dict(cfg)
    name = cfg.pop("name")
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; known: {sorted(OPTIMIZERS)}")
    lr_cfg = dict(cfg.pop("lr", {"name": "Constant", "learning_rate": 1e-4}))
    use_increments = bool(lr_cfg.pop("use_increments", False))
    base_schedule = build_lr_scheduler(lr_cfg)
    if use_increments and count_scale != 1:
        def schedule(count):
            return base_schedule(count * count_scale)
    else:
        schedule = base_schedule
    clip_cfg = cfg.pop("grad_clip", None) or {}
    if isinstance(clip_cfg, (int, float)):
        clip_cfg = {"name": "ClipGradByGlobalNorm", "clip_norm": float(clip_cfg)}
    clip_norm = clip_cfg.get("clip_norm") if clip_cfg.get("name") != "None" else None
    tx = OPTIMIZERS[name](schedule=schedule, grad_clip=clip_norm, **cfg)
    return tx, schedule

