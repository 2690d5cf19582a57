"""Streaming evaluation metrics: the ``Metric`` protocol, the ``METRICS``
registry and ``format_metric``.

Counterpart of the part of ``paddlefleetx_tpu/models/metrics.py`` that
evaluation needs (``Metric:18``, ``METRICS:15``, ``format_metric:224``):
a metric takes ``update(preds, labels)`` per batch, numpy arrays on the
host, and ``accumulate()`` returns its value(s).  The finetune metrics
(accuracy and F1, MCC, Pearson and Spearman) come with the finetune
module.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from paddlefleetx_tpu_torch.utils.registry import Registry

METRICS = Registry("metric")


class Metric:
    """Streaming metric: ``update(preds, labels)`` per batch,
    ``accumulate()`` -> value(s), ``reset()``."""

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


def format_metric(m: Metric) -> Dict[str, float]:
    """``accumulate()``'s value(s) as a ``{name: value}`` dict for logging:
    a dict as it is, a tuple as ``v0``, ``v1``, .., a scalar under the
    metric's lower-cased name."""
    val = m.accumulate()
    if isinstance(val, dict):
        return {k: float(v) for k, v in val.items()}
    if isinstance(val, tuple):
        return {f"v{i}": float(v) for i, v in enumerate(val)}
    return {m.name.lower(): float(val)}
