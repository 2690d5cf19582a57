"""Shared plumbing of the HF checkpoint converters.

Counterpart of ``paddlefleetx_tpu/models/convert_common.py``: torch-or-numpy
leaf extraction (``to_numpy``), backbone-prefix detection
(``detect_prefix``), a getter that prefers the prefixed key and falls back
to the bare one (``make_getter``), and per-layer stacking
(``make_stacker``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np


def to_numpy(v) -> np.ndarray:
    """torch tensor or array-like -> float32 numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        # numpy has no bfloat16: widen first (exact)
        v = v.float().numpy() if v.dtype.is_floating_point else v.numpy()
    return np.asarray(v).astype(np.float32)


def detect_prefix(sd: Dict, candidates: Sequence[str]) -> str:
    """First candidate prefix ('' always matches last) present in the keys:
    classification/pretraining wrappers nest the backbone under one."""
    names = list(sd.keys())
    for p in candidates:
        if p and any(n.startswith(p) for n in names):
            return p
    return ""


def make_getter(sd: Dict, prefix: str = "") -> Callable[[str], np.ndarray]:
    """get(name): prefer the prefixed key, fall back to the bare one."""

    def get(name: str) -> np.ndarray:
        key = prefix + name if prefix + name in sd else name
        return to_numpy(sd[key])

    return get


def make_stacker(get: Callable[[str], np.ndarray], num_layers: int):
    """stack(fmt): per-layer tensors -> one leading-L array, with optional
    transpose and reshape."""

    def stack(fmt: str, reshape: Optional[tuple] = None, transpose: bool = False):
        arrs = []
        for i in range(num_layers):
            a = get(fmt.format(i=i))
            if transpose:
                a = a.T
            arrs.append(a.reshape(reshape) if reshape is not None else a)
        return np.stack(arrs)

    return stack
