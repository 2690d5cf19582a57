"""Model module: binds a config to a model family (GPT only so far).

Counterpart of ``paddlefleetx_tpu/core/module.py:19-100``: the config,
initialization (serving and trainable models) and the training loss.
Metrics and export come with later slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from paddlefleetx_tpu_torch.models.gpt import model as gpt
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
    """GPT: the config from the ``Model`` section, seeded serving and
    trainable models, and the training loss."""

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
        if cfg.get("Distributed", {}).get("sequence_parallel", False):
            model_cfg["sequence_parallel"] = True
        self.config = GPTConfig.from_config(model_cfg)
        # tokens per sample, for the throughput metrics (Data.Train's
        # max_seq_len when set)
        self.tokens_per_sample = self.config.max_position_embeddings
        seq_len = (cfg.get("Data") or {}).get("Train", {}).get("dataset", {}).get("max_seq_len")
        if seq_len:
            self.tokens_per_sample = int(seq_len)

    def init_model(
        self, seed: int, device: Optional[Union[str, torch.device]] = None,
        trainable: bool = False,
    ) -> GPTModel:
        """A ``GPTModel`` with ``normal(initializer_range)`` weights drawn on
        the CPU from ``torch.Generator().manual_seed(seed)``, then moved to
        ``device`` (the card unless "cpu" is asked for): the same seed gives
        the same weights on every device.  ``trainable`` as in
        :class:`GPTModel`."""
        dev = resolve_device(device)
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        return init_params(GPTModel(self.config, trainable), gen).to(dev)

    def init_params(
        self, seed: int, device: Optional[Union[str, torch.device]] = None
    ) -> GPTModel:
        """The trainable model: float32 masters that require grad."""
        return self.init_model(seed, device, trainable=True)

    def loss_fn(self, model: GPTModel, batch: Dict[str, torch.Tensor], *,
                dropout_seed: Optional[int] = None, train: bool = True) -> torch.Tensor:
        """The masked-mean token cross-entropy (``models/gpt/model.loss_fn``)."""
        return gpt.loss_fn(model, batch, self.config, dropout_seed=dropout_seed,
                           train=train)
