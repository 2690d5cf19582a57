"""Model module: binds a config to a model family (GPT only so far).

Counterpart of ``paddlefleetx_tpu/core/module.py:19-100``, config and
initialization only: loss, metrics and export come with the training
slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.model import GPTModel, init_params
from paddlefleetx_tpu_torch.utils.device import resolve_device


def resolve_model_dtype(cfg, model_cfg: Dict[str, Any]) -> None:
    """Fill ``model_cfg['dtype']`` from ``Engine.mix_precision`` unless the
    Model section pins it (mix disabled = float32)."""
    if "dtype" not in model_cfg:
        mix = cfg.get("Engine", {}).get("mix_precision", {})
        model_cfg["dtype"] = (
            mix.get("dtype", "bfloat16") if mix.get("enable", True) else "float32"
        )


class GPTModule:
    """GPT: the config from the ``Model`` section and a seeded model."""

    def __init__(self, cfg):
        model_cfg = dict(cfg.Model)
        name = model_cfg.pop("module", "GPTModule")
        if name != "GPTModule":
            raise NotImplementedError(
                f"Model.module {name!r} is not ported yet; the PyTorch port "
                "serves GPTModule"
            )
        model_cfg.pop("name", None)
        resolve_model_dtype(cfg, model_cfg)
        self.config = GPTConfig.from_config(model_cfg)

    def init_model(
        self, seed: int, device: Optional[Union[str, torch.device]] = None
    ) -> GPTModel:
        """A ``GPTModel`` with ``normal(initializer_range)`` weights drawn on
        the CPU from ``torch.Generator().manual_seed(seed)``, then moved to
        ``device`` (the card unless "cpu" is asked for): the same seed gives
        the same weights on every device."""
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        return init_params(GPTModel(self.config), gen).to(dev)
