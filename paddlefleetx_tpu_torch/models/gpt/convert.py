"""HF GPT-2 checkpoint -> the GPT parameter tree.

Counterpart of ``paddlefleetx_tpu/models/gpt/convert.py``
(``hf_gpt2_config`` :24 with its five variant refusals,
``convert_hf_gpt2_state_dict`` :54 with ``pad_vocab_to``).  It returns the
same stacked numpy tree as the JAX converter, which
``models/gpt/bridge.params_from_jax`` loads into the port's model.
Mapping notes (as in JAX):

- HF ``Conv1D`` weights are already [in, out]: no transpose.
- ``c_attn`` packs q|k|v along the output dim: [h, 3h] reshapes to
  [h, 3, nh, hd], the fused qkv kernel's layout.
- tanh-GELU and LayerNorm eps 1e-5 already agree.
- the LM head is tied to the word embedding in both models.

Two things the JAX converter never saw, because it reads
``GPT2LMHeadModel.state_dict()``: hub files spell the keys both as
``transformer.h.0.…`` and as bare ``h.0.…`` (both are read here), and
carry the ``attn.bias`` / ``attn.masked_bias`` mask buffers (ignored).
``hf_cfg`` is a ``GPT2Config``-like object or the mapping of its
``config.json``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from paddlefleetx_tpu_torch.models.convert_common import (
    detect_prefix,
    make_getter,
    make_stacker,
)
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig


def _field(hf_cfg, key: str, default: Any = None) -> Any:
    if isinstance(hf_cfg, Mapping):
        return hf_cfg.get(key, default)
    return getattr(hf_cfg, key, default)


def hf_gpt2_config(hf_cfg, **overrides) -> GPTConfig:
    """GPTConfig from a GPT-2 config.

    Raises on variants the model hardcodes differently: a silent convert
    would give wrong logits with no error anywhere downstream."""
    act = _field(hf_cfg, "activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(f"unsupported activation_function {act!r} (need gelu_new)")
    eps = float(_field(hf_cfg, "layer_norm_epsilon", 1e-5))
    if abs(eps - 1e-5) > 1e-12:
        raise ValueError(f"unsupported layer_norm_epsilon {eps} (model hardcodes 1e-5)")
    n_inner = _field(hf_cfg, "n_inner")
    if n_inner is not None and int(n_inner) != 4 * int(_field(hf_cfg, "n_embd")):
        raise ValueError(f"unsupported n_inner {n_inner} (need 4*n_embd)")
    if _field(hf_cfg, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx not supported")
    if _field(hf_cfg, "reorder_and_upcast_attn", False):
        raise ValueError("reorder_and_upcast_attn not supported")
    kw = dict(
        vocab_size=int(_field(hf_cfg, "vocab_size")),
        hidden_size=int(_field(hf_cfg, "n_embd")),
        num_layers=int(_field(hf_cfg, "n_layer")),
        num_attention_heads=int(_field(hf_cfg, "n_head")),
        max_position_embeddings=int(_field(hf_cfg, "n_positions")),
    )
    kw.update(overrides)
    return GPTConfig(**kw)


def convert_hf_gpt2_state_dict(
    sd: Dict[str, Any], cfg: GPTConfig, pad_vocab_to: Optional[int] = None
) -> Dict:
    """A GPT-2 state dict (``transformer.``-prefixed or bare keys; torch
    tensors or numpy arrays) -> the stacked float32 param tree.
    ``pad_vocab_to`` grows the embedding with zero rows; the model config
    must then use the padded vocab_size."""
    get = make_getter(sd, detect_prefix(sd, ("transformer.",)))

    h, L = cfg.hidden_size, cfg.num_layers
    nh, hd = cfg.num_attention_heads, cfg.head_dim

    word = get("wte.weight").astype(np.float32)
    if pad_vocab_to is not None:
        if pad_vocab_to < word.shape[0]:
            raise ValueError(f"pad_vocab_to {pad_vocab_to} < vocab {word.shape[0]}")
        pad = np.zeros((pad_vocab_to - word.shape[0], h), np.float32)
        word = np.concatenate([word, pad], axis=0)
    if word.shape[0] != cfg.vocab_size:
        raise ValueError(
            f"config vocab_size {cfg.vocab_size} != embedding rows {word.shape[0]}"
        )

    stack = make_stacker(get, L)

    return {
        "embeddings": {
            "word": word,
            "position": get("wpe.weight").astype(np.float32),
        },
        "layers": {
            "ln_1": {
                "scale": stack("h.{i}.ln_1.weight"),
                "bias": stack("h.{i}.ln_1.bias"),
            },
            "attn": {
                "qkv_kernel": stack("h.{i}.attn.c_attn.weight", (h, 3, nh, hd)),
                "qkv_bias": stack("h.{i}.attn.c_attn.bias", (3, nh, hd)),
                "out_kernel": stack("h.{i}.attn.c_proj.weight", (nh, hd, h)),
                "out_bias": stack("h.{i}.attn.c_proj.bias"),
            },
            "ln_2": {
                "scale": stack("h.{i}.ln_2.weight"),
                "bias": stack("h.{i}.ln_2.bias"),
            },
            "mlp": {
                "fc_in_kernel": stack("h.{i}.mlp.c_fc.weight"),
                "fc_in_bias": stack("h.{i}.mlp.c_fc.bias"),
                "fc_out_kernel": stack("h.{i}.mlp.c_proj.weight"),
                "fc_out_bias": stack("h.{i}.mlp.c_proj.bias"),
            },
        },
        "final_ln": {
            "scale": get("ln_f.weight").astype(np.float32),
            "bias": get("ln_f.bias").astype(np.float32),
        },
    }
