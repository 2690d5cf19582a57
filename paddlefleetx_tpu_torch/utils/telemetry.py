"""Model FLOPs and the card's peak, for the ``mfu`` column of the training
metrics record.

Counterpart of ``model_flops_per_token:859`` and ``peak_flops:899`` of
``paddlefleetx_tpu/utils/telemetry.py`` (the analytic ``6 * N`` per
trained token, PaLM's MFU convention: no recompute extra, attention
scores excluded).  The peak is the card's dense bf16 tensor-core rate,
picked by ``torch.cuda.get_device_name``; ``PFX_PEAK_FLOPS`` overrides
it.  On the CPU, or on a card the table does not know, there is no peak
and the record carries no ``mfu``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from paddlefleetx_tpu_torch.utils.log import logger

# dense bf16 tensor-core FLOP/s by a substring of the device name (NVIDIA
# data sheets, SXM parts at their full power limit)
PEAK_FLOPS_BY_DEVICE_NAME: Dict[str, float] = {
    "h100": 989e12,
    "h200": 989e12,
}


def gpt_param_count(*, vocab_size: int, hidden_size: int, num_layers: int,
                    ffn_hidden_size: Optional[int] = None) -> int:
    """The matmul-bearing parameter count N of a GPT stack: the tied
    embedding once, per layer fused qkv, the output projection and the
    two MLP matmuls with biases, two LayerNorms, and the final LayerNorm;
    position embeddings excluded."""
    h = int(hidden_size)
    ffn = int(ffn_hidden_size or 4 * h)
    per_layer = (3 * h * h + 3 * h) + (h * h + h) + (h * ffn + ffn) + (ffn * h + h) + 4 * h
    return int(vocab_size) * h + int(num_layers) * per_layer + 2 * h


def model_flops_per_token(config: Any) -> Optional[float]:
    """``6 * N`` per trained token; None when the config lacks the GPT
    fields."""
    vocab = getattr(config, "vocab_size", None)
    hidden = getattr(config, "hidden_size", None)
    layers = getattr(config, "num_layers", None)
    if not vocab or not hidden or not layers:
        return None
    n = gpt_param_count(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                        ffn_hidden_size=getattr(config, "ffn_hidden_size", None))
    return float(6 * n)


def peak_flops(device: torch.device) -> Optional[float]:
    """Per-card peak FLOP/s: ``PFX_PEAK_FLOPS`` (> 0) if set, else the
    table's entry for the card's name, else None (on the CPU too)."""
    raw = os.environ.get("PFX_PEAK_FLOPS") or ""
    if raw.strip():
        try:
            val = float(raw)
        except ValueError:
            raise ValueError(f"PFX_PEAK_FLOPS={raw!r} is not a number; unset it or pass "
                             "FLOP/s") from None
        if val <= 0:
            raise ValueError(f"PFX_PEAK_FLOPS={raw!r} must be > 0")
        return val
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for sub, peak in PEAK_FLOPS_BY_DEVICE_NAME.items():
        if sub in name:
            return peak
    logger.warning(f"peak_flops: unknown card {name!r} and no PFX_PEAK_FLOPS set; mfu "
                   "left out of the metrics")
    return None
