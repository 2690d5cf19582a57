"""GPT decoder-only LM: parameters as ``nn.Module``s plus plain tensor
functions for the pieces the serving forward shares.

Counterpart of ``paddlefleetx_tpu/models/gpt/model.py:76-150,370-420``
and ``models/common.py``.  Architecture: learned word + position
embeddings, pre-LayerNorm decoder blocks (fused-qkv attention, tanh-GELU
MLP), final LayerNorm, LM head tied to the word embedding.

Parameters keep the JAX per-layer shapes (``qkv_kernel [h, 3, nh, hd]``,
``out_kernel [nh, hd, h]``, ``fc_*_kernel`` as ``x @ W``), so the weight
bridge (``bridge.py``) only slices the stacked ``layers`` axis.  The
LayerNorm ``scale``/``bias`` stay float32 (the JAX forward applies them
in float32 before casting); every other weight is stored in the model
dtype, which rounds exactly as the JAX forward's per-use
``.astype(dtype)`` does.  The slice is inference only: parameters do not
require grad.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig

# (shape, initializer) with initializer in {"normal", "ones", "zeros"}
Spec = Tuple[Tuple[int, ...], str]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer_specs(cfg: GPTConfig) -> Dict[str, Dict[str, Spec]]:
    """One decoder layer's parameter shapes (JAX ``_layer_specs``)."""
    h, nh, hd, ffn = (
        cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim, cfg.ffn_hidden_size,
    )
    return {
        "ln_1": {"scale": ((h,), "ones"), "bias": ((h,), "zeros")},
        "attn": {
            "qkv_kernel": ((h, 3, nh, hd), "normal"),
            "qkv_bias": ((3, nh, hd), "zeros"),
            "out_kernel": ((nh, hd, h), "normal"),
            "out_bias": ((h,), "zeros"),
        },
        "ln_2": {"scale": ((h,), "ones"), "bias": ((h,), "zeros")},
        "mlp": {
            "fc_in_kernel": ((h, ffn), "normal"),
            "fc_in_bias": ((ffn,), "zeros"),
            "fc_out_kernel": ((ffn, h), "normal"),
            "fc_out_bias": ((h,), "zeros"),
        },
    }


def gpt_specs(cfg: GPTConfig) -> Dict[str, Dict[str, Spec]]:
    """Top-level (non-layer) parameter shapes (JAX ``gpt_specs``)."""
    h = cfg.hidden_size
    return {
        "embeddings": {
            "word": ((cfg.vocab_size, h), "normal"),
            "position": ((cfg.max_position_embeddings, h), "normal"),
        },
        "final_ln": {"scale": ((h,), "ones"), "bias": ((h,), "zeros")},
    }


def _is_norm(group: str) -> bool:
    return group in ("ln_1", "ln_2", "final_ln")


class ParamGroup(nn.Module):
    """A named bag of parameters (one JAX sub-dict such as ``attn``)."""

    def __init__(self, specs: Dict[str, Spec], dtype: torch.dtype):
        super().__init__()
        self.inits = {name: init for name, (_, init) in specs.items()}
        for name, (shape, _) in specs.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)
            )


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GPTConfig, dtype: torch.dtype):
        super().__init__()
        for group, specs in _layer_specs(cfg).items():
            self.add_module(
                group, ParamGroup(specs, torch.float32 if _is_norm(group) else dtype)
            )


class GPTModel(nn.Module):
    """GPT parameters: ``embeddings``, ``layers[i]`` and ``final_ln``.

    Built on the CPU with uninitialized storage; call
    :func:`init_params` (or load through the bridge) and then ``.to()``
    the target device."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.config = cfg
        self.dtype = DTYPES[cfg.dtype]
        top = gpt_specs(cfg)
        self.embeddings = ParamGroup(top["embeddings"], self.dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, self.dtype) for _ in range(cfg.num_layers)
        )
        self.final_ln = ParamGroup(top["final_ln"], torch.float32)


@torch.no_grad()
def init_params(model: GPTModel, generator: torch.Generator) -> GPTModel:
    """``normal(initializer_range)`` weights, ones/zeros LayerNorm and
    biases, drawn in float32 from ``generator`` in ``named_parameters``
    order and cast to each parameter's dtype.  The draws are not the JAX
    package's (threefry and torch's generator differ): tests that compare
    the two move weights through ``bridge.py``."""
    std = model.config.initializer_range
    for mod in model.modules():
        if not isinstance(mod, ParamGroup):
            continue
        for name, p in mod.named_parameters(recurse=False):
            init = mod.inits[name]
            if init == "normal":
                w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                w.normal_(0.0, std, generator=generator)
                p.copy_(w)
            elif init == "ones":
                p.fill_(1.0)
            else:
                p.zero_()
    return model


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm with float32 statistics and a float32 affine (``scale``
    and ``bias`` are float32), cast back to ``x.dtype`` at the end —
    ``paddlefleetx_tpu/models/gpt/model.py:145-150``."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def embed(
    model: GPTModel, tokens: torch.Tensor, position_ids: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Word + position embedding: tokens [b, s] -> [b, s, h] in the model
    dtype (inference: no dropout).  ``position_ids`` defaults to
    ``arange(s)``; it may be [s] or [b, s]."""
    if position_ids is None:
        position_ids = torch.arange(tokens.shape[1], device=tokens.device)
    emb = model.embeddings
    return emb.word[tokens] + emb.position[position_ids]


def logits_from_hidden(model: GPTModel, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head: [b, s, h] -> [b, s, vocab] in the model dtype."""
    return hidden @ model.embeddings.word.t()
