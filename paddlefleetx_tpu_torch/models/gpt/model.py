"""GPT decoder-only LM: parameters as ``nn.Module``s, the serving
pieces, and the training forward and loss.

Counterpart of ``paddlefleetx_tpu/models/gpt/model.py`` (parameters
:76-122, ``layer_norm`` :138, ``_layer_remat`` :153, ``_attention_block``
:180, ``_mlp_block`` :251, ``_decoder_layer`` :274, the non-pipelined
``transformer_stack`` :303-367, ``_embed`` :370 (here ``embed``),
``forward_hidden`` :391, ``forward`` :423, ``cross_entropy`` :450,
``loss_fn`` :581).
Architecture: learned word + position embeddings, pre-LayerNorm decoder
blocks (fused-qkv attention, tanh-GELU MLP), final LayerNorm, LM head
tied to the word embedding.

Parameters keep the JAX per-layer shapes (``qkv_kernel [h, 3, nh, hd]``,
``out_kernel [nh, hd, h]``, ``fc_*_kernel`` as ``x @ W``), so the weight
bridge (``bridge.py``) only slices the stacked ``layers`` axis.  One spec
table builds two kinds of model:

  - serving (``GPTModel(cfg)``): weights stored in the model dtype, which
    rounds exactly as the JAX forward's per-use ``.astype(dtype)`` does;
    no grad;
  - training (``GPTModel(cfg, trainable=True)``): float32 masters that
    require grad, cast to ``cfg.dtype`` at each use as the JAX forward
    does.  No ``torch.autocast``.

LayerNorm ``scale``/``bias`` are float32 in both, with float32 statistics.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from paddlefleetx_tpu_torch.models.common import checkpoint_name, dropout, fold_in, split
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.ops.attention import attention
from paddlefleetx_tpu_torch.ops.fused_layernorm import fused_layer_norm

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

    def __init__(self, specs: Dict[str, Spec], dtype: torch.dtype, trainable: bool = False):
        super().__init__()
        self.inits = {name: init for name, (_, init) in specs.items()}
        for name, (shape, _) in specs.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=trainable)
            )


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GPTConfig, dtype: torch.dtype, trainable: bool = False):
        super().__init__()
        for group, specs in _layer_specs(cfg).items():
            self.add_module(
                group,
                ParamGroup(specs, torch.float32 if _is_norm(group) else dtype, trainable),
            )


class GPTModel(nn.Module):
    """GPT parameters: ``embeddings``, ``layers[i]`` and ``final_ln``.

    ``trainable=False`` (serving) stores the weights in the model dtype,
    without grad; ``trainable=True`` stores float32 masters that require
    grad.  ``dtype`` is the compute dtype either way.  Built on the CPU
    with uninitialized storage; call :func:`init_params` (or load through
    the bridge) and then ``.to()`` the target device."""

    def __init__(self, cfg: GPTConfig, trainable: bool = False):
        super().__init__()
        self.config = cfg
        self.trainable = trainable
        self.dtype = DTYPES[cfg.dtype]
        store = torch.float32 if trainable else self.dtype
        top = gpt_specs(cfg)
        self.embeddings = ParamGroup(top["embeddings"], store, trainable)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, store, trainable) for _ in range(cfg.num_layers)
        )
        self.final_ln = ParamGroup(top["final_ln"], torch.float32, trainable)


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
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
    fused: bool = False,
) -> torch.Tensor:
    """LayerNorm with float32 statistics and a float32 affine (``scale``
    and ``bias`` are float32), cast back to ``x.dtype`` at the end —
    ``paddlefleetx_tpu/models/gpt/model.py:138-150``.  ``fused``
    (``Model.use_fused_ln``) takes the fused kernels K1/K2
    (``ops/fused_layernorm``), the same math."""
    if fused:
        return fused_layer_norm(x, scale, bias, eps=eps)
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def embed(
    model: GPTModel, tokens: torch.Tensor, position_ids: Optional[torch.Tensor] = None, *,
    dtype: Optional[torch.dtype] = None, seed: Optional[int] = None, rate: float = 0.0,
    train: bool = False,
) -> torch.Tensor:
    """Word + position embedding: tokens [b, s] -> [b, s, h] in ``dtype``
    (default the tables' own), with embedding dropout when training.  The
    rows are gathered, then cast: the values of JAX's cast-then-gather.
    ``position_ids`` defaults to ``arange(s)``; it may be [s] or [b, s]."""
    if position_ids is None:
        position_ids = torch.arange(tokens.shape[1], device=tokens.device)
    emb = model.embeddings
    dtype = dtype or emb.word.dtype
    x = emb.word[tokens].to(dtype) + emb.position[position_ids].to(dtype)
    return dropout(seed, x, rate, train)


def logits_from_hidden(model: GPTModel, hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head: [b, s, h] -> [b, s, vocab] in hidden's dtype
    (the word table cast to it, a no-op for the serving model)."""
    return hidden @ model.embeddings.word.to(hidden.dtype).t()


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _recompute(cfg: GPTConfig, granularity: str) -> bool:
    return cfg.use_recompute and cfg.recompute_granularity == granularity


def _checkpointed(fn, **kw):
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _selective_policy(names: Tuple[str, ...]):
    """Keep the outputs of the ops tagged with one of ``names`` (and, for
    "attn_lse", the flash forward op's out and lse); recompute the rest."""
    tag = torch.ops.pfx.checkpoint_tag.default
    flash = torch.ops.pfx.flash_attn_fwd.default

    def policy(ctx, op, *args, **kwargs):
        if (op is tag and args[1] in names) or (op is flash and "attn_lse" in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _save_set(cfg: GPTConfig) -> Tuple[str, ...]:
    """The names selective recompute keeps (default qkv, attn_out,
    attn_lse; on the flash path "attn_out" implies "attn_lse", whose op
    also returns the attention output); () under any other setting.  Only
    these are tagged: a tag is a copy, and an untagged output is
    recomputed all the same."""
    if not _recompute(cfg, "selective"):
        return ()
    names = cfg.recompute_name_tuple or ("qkv", "attn_out", "attn_lse")
    if cfg.attn_impl == "flash" and "attn_out" in names and "attn_lse" not in names:
        names = names + ("attn_lse",)
    return names


def _layer_remat(cfg: GPTConfig, fn, save: Tuple[str, ...]):
    """Wrap a decoder layer per recompute granularity
    (``torch.utils.checkpoint``, non-reentrant).  "full" recomputes the
    whole layer; "selective" keeps the outputs named in ``save``
    (:func:`_save_set`) and recomputes the rest; "full_attn" and
    "core_attn" are placed inside the layer."""
    if _recompute(cfg, "full"):
        return _checkpointed(fn)
    if _recompute(cfg, "selective"):
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _selective_policy(save))
        return _checkpointed(fn, context_fn=ctx_fn)
    return fn


def _attention_block(p: ParamGroup, x: torch.Tensor, cfg: GPTConfig,
                     seed: Optional[int], train: bool,
                     save: Tuple[str, ...] = ()) -> torch.Tensor:
    """Fused-qkv causal self-attention.  x: [b, s, h] -> [b, s, h]; the
    outputs named in ``save`` are tagged for selective recompute."""
    dtype = x.dtype
    b, s, h = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    k_attn, k_resid = split(seed)
    qkv = (x @ p.qkv_kernel.to(dtype).reshape(h, 3 * nh * hd)).reshape(b, s, 3, nh, hd)
    qkv = qkv + p.qkv_bias.to(dtype)[None, None]
    if "qkv" in save:
        qkv = checkpoint_name(qkv, "qkv")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def core(q, k, v):
        return attention(
            q, k, v, impl=cfg.attn_impl, causal=True, dropout_seed=k_attn,
            dropout_rate=cfg.attention_probs_dropout_prob, train=train,
            flash_block=cfg.flash_block, flash_bwd=cfg.flash_bwd, tag="attn_out" in save,
        )

    if _recompute(cfg, "core_attn"):
        core = _checkpointed(core)
    out = core(q, k, v)  # [b, s, nh, hd]
    out = out.reshape(b, s, nh * hd) @ p.out_kernel.to(dtype).reshape(nh * hd, h)
    out = out + p.out_bias.to(dtype)
    return dropout(k_resid, out, cfg.hidden_dropout_prob, train)


def _mlp_block(p: ParamGroup, x: torch.Tensor, cfg: GPTConfig, seed: Optional[int],
               train: bool, save: Tuple[str, ...] = ()) -> torch.Tensor:
    dtype = x.dtype
    h = x @ p.fc_in_kernel.to(dtype) + p.fc_in_bias.to(dtype)
    if "mlp_hidden" in save:
        h = checkpoint_name(h, "mlp_hidden")
    h = F.gelu(h, approximate="tanh")
    h = h @ p.fc_out_kernel.to(dtype) + p.fc_out_bias.to(dtype)
    return dropout(seed, h, cfg.hidden_dropout_prob, train)


def _decoder_layer(layer: DecoderLayer, x: torch.Tensor, cfg: GPTConfig,
                   seed: Optional[int], train: bool,
                   save: Tuple[str, ...] = ()) -> torch.Tensor:
    """Pre-LN block: x + attn(ln_1(x)), then + mlp(ln_2(x))."""
    k_attn, k_mlp = split(seed)

    def attn_part(x):
        y = layer_norm(x, layer.ln_1.scale, layer.ln_1.bias, fused=cfg.use_fused_ln)
        return _attention_block(layer.attn, y, cfg, k_attn, train, save)

    if _recompute(cfg, "full_attn"):
        attn_part = _checkpointed(attn_part)
    x = x + attn_part(x)
    y = layer_norm(x, layer.ln_2.scale, layer.ln_2.bias, fused=cfg.use_fused_ln)
    return x + _mlp_block(layer.mlp, y, cfg, k_mlp, train, save)


def transformer_stack(model: GPTModel, x: torch.Tensor, cfg: GPTConfig,
                      seed: Optional[int], train: bool) -> torch.Tensor:
    """The layers in order (the JAX scan over the stacked axis); layer i
    draws its dropout from ``fold_in(seed, i)``."""
    save = _save_set(cfg)
    for idx, layer in enumerate(model.layers):
        k = fold_in(seed, idx) if seed is not None else None
        body = functools.partial(_decoder_layer, layer, cfg=cfg, seed=k, train=train,
                                 save=save)
        x = _layer_remat(cfg, body, save)(x)
    return x


def forward_hidden(model: GPTModel, tokens: torch.Tensor, cfg: GPTConfig, *,
                   position_ids: Optional[torch.Tensor] = None,
                   dropout_seed: Optional[int] = None, train: bool = False) -> torch.Tensor:
    """Token ids [b, s] -> final hidden [b, s, h] in ``cfg.dtype``."""
    k_embed, k_layers = split(dropout_seed)
    x = embed(model, tokens, position_ids, dtype=DTYPES[cfg.dtype], seed=k_embed,
              rate=cfg.hidden_dropout_prob, train=train)
    x = transformer_stack(model, x, cfg, k_layers, train)
    return layer_norm(x, model.final_ln.scale, model.final_ln.bias, fused=cfg.use_fused_ln)


def forward(model: GPTModel, tokens: torch.Tensor, cfg: GPTConfig, *,
            position_ids: Optional[torch.Tensor] = None,
            dropout_seed: Optional[int] = None, train: bool = False) -> torch.Tensor:
    hidden = forward_hidden(model, tokens, cfg, position_ids=position_ids,
                            dropout_seed=dropout_seed, train=train)
    return logits_from_hidden(model, hidden)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-mean token cross-entropy in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if loss_mask is None:
        return nll.mean()
    loss_mask = loss_mask.float()
    return (nll * loss_mask).sum() / torch.clamp(loss_mask.sum(), min=1.0)


def check_trainable(cfg: GPTConfig) -> None:
    """Refuse, loudly, the training features the port does not have yet."""
    if cfg.use_chunked_ce:
        raise NotImplementedError(
            "use_chunked_ce: chunked cross-entropy is not ported yet (a later "
            "slice of the PyTorch port); set Model.use_chunked_ce=False"
        )
    if cfg.attn_impl == "ring":
        raise NotImplementedError(
            "attn_impl=ring: context parallelism comes with the parallel layouts "
            "(a later slice of the PyTorch port); use xla or flash"
        )
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel: the PyTorch port trains on one device; the "
            "parallel layouts are a later slice"
        )


def loss_fn(model: GPTModel, batch: Dict[str, torch.Tensor], cfg: GPTConfig, *,
            dropout_seed: Optional[int] = None, train: bool = True) -> torch.Tensor:
    """batch: tokens [b, s], labels [b, s], loss_mask [b, s] and
    position_ids (optional) -> the masked-mean loss, float32 scalar."""
    check_trainable(cfg)
    hidden = forward_hidden(model, batch["tokens"], cfg,
                            position_ids=batch.get("position_ids"),
                            dropout_seed=dropout_seed, train=train)
    logits = logits_from_hidden(model, hidden)
    return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
