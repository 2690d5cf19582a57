"""Weight bridge between the JAX parameter tree and the port's modules.

The JAX tree (``paddlefleetx_tpu/models/gpt/model.py:76-122``) is a
nested dict ``{"embeddings": {"word", "position"}, "layers": {...},
"final_ln": {"scale", "bias"}}`` whose ``layers`` leaves are stacked on a
leading ``[num_layers, ...]`` axis; the port holds one ``DecoderLayer``
per layer with the same per-layer shapes.  Both directions exchange
numpy arrays, so this module needs no JAX: the caller converts with
``np.asarray``.

Values are copied bit for bit into each parameter's dtype.  With a
float32 model the round trip ``params_to_jax(params_from_jax(tree))`` is
exact; with a bfloat16 model the non-LayerNorm weights are rounded to
bfloat16 on the way in, which is the rounding the JAX forward applies
per use.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.model import GPTModel, gpt_specs, _layer_specs


def _check(name: str, arr: np.ndarray, shape) -> np.ndarray:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape} != expected {tuple(shape)}")
    return arr


@torch.no_grad()
def params_from_jax(cfg: GPTConfig, tree: Dict[str, Any]) -> GPTModel:
    """A new CPU ``GPTModel`` holding a JAX GPT parameter tree's values
    (numpy leaves, each shape-checked)."""
    model = GPTModel(cfg)
    for group, specs in gpt_specs(cfg).items():
        mod = getattr(model, group)
        for name, (shape, _) in specs.items():
            arr = _check(f"{group}.{name}", tree[group][name], shape)
            getattr(mod, name).copy_(torch.tensor(arr))
    layers = tree["layers"]
    for group, specs in _layer_specs(cfg).items():
        for name, (shape, _) in specs.items():
            stacked = _check(
                f"layers.{group}.{name}", layers[group][name], (cfg.num_layers,) + shape
            )
            for i, layer in enumerate(model.layers):
                getattr(getattr(layer, group), name).copy_(torch.tensor(stacked[i]))
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def params_to_jax(model: GPTModel) -> Dict[str, Any]:
    """The model's parameters as a JAX-layout tree of float32 numpy arrays
    (stacked ``layers`` leaves)."""
    cfg = model.config
    tree: Dict[str, Any] = {}
    for group, specs in gpt_specs(cfg).items():
        mod = getattr(model, group)
        tree[group] = {name: _to_numpy(getattr(mod, name)) for name in specs}
    tree["layers"] = {
        group: {
            name: np.stack(
                [_to_numpy(getattr(getattr(layer, group), name)) for layer in model.layers]
            )
            for name in specs
        }
        for group, specs in _layer_specs(cfg).items()
    }
    return tree
