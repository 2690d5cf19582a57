"""Pieces the model families share: dropout from explicit seeds and the
checkpoint-name tag of selective recompute.

Counterpart of ``paddlefleetx_tpu/models/common.py:110`` (``dropout``) and
of ``jax.ad_checkpoint.checkpoint_name``.

Dropout draws from a ``torch.Generator`` seeded with an integer that the
caller derives per step, layer and site (:func:`fold_in`), as the JAX
model folds its dropout key.  A recomputed segment
(``torch.utils.checkpoint``) re-seeds and so redraws the same mask.  The
masks cannot match JAX's threefry bits: parity tests run with both
dropout rates at 0.
"""

from typing import Optional, Tuple

import torch
from torch import Tensor

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 mixing)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def split(seed: Optional[int]) -> Tuple[Optional[int], Optional[int]]:
    """Two independent seeds (``jax.random.split``); None stays None."""
    if seed is None:
        return None, None
    return fold_in(seed, 0), fold_in(seed, 1)


def keep_mask(seed: int, shape, keep: float, device) -> Tensor:
    """Bernoulli(``keep``) mask drawn from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout(seed: Optional[int], x: Tensor, rate: float, train: bool) -> Tensor:
    """Inverted dropout: ``x / keep`` where kept, 0 elsewhere, in x's type."""
    if not train or rate == 0.0 or seed is None:
        return x
    keep = 1.0 - rate
    mask = keep_mask(seed, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@torch.library.custom_op("pfx::checkpoint_tag", mutates_args=())
def _checkpoint_tag(x: Tensor, name: str) -> Tensor:
    return x.clone()


@_checkpoint_tag.register_fake
def _checkpoint_tag_fake(x, name):
    return torch.empty_like(x)


_checkpoint_tag.register_autograd(lambda ctx, grad: (grad, None))


def checkpoint_name(x: Tensor, name: str) -> Tensor:
    """``x`` through the ``pfx::checkpoint_tag`` op (a copy), so that a
    selective-recompute policy can keep it by ``name``.  Callers tag only
    the names that policy keeps (``models/gpt/model._save_set``); anywhere
    else the copy would buy nothing."""
    return torch.ops.pfx.checkpoint_tag(x, name)
