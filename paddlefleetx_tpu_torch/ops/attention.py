"""Attention: the plain PyTorch path and the dispatch to flash attention.

Counterpart of ``paddlefleetx_tpu/ops/attention.py``: one causal
attention entry point, :func:`attention`, that runs :func:`xla_attention`
(the plain path, any device) or the flash kernels
(``ops/flash_attention.py``) as ``impl`` selects, with the JAX package's
conditions.
"""

import warnings
from typing import Optional

import torch
from torch import Tensor

from paddlefleetx_tpu_torch.models.common import checkpoint_name, keep_mask
from paddlefleetx_tpu_torch.ops.flash_attention import flash_attention, flash_supported


def causal_mask_bias(seq_len: int, dtype: torch.dtype, device) -> Tensor:
    """Additive causal bias [1, 1, s, s]: 0 on and below the diagonal,
    -1e9 above."""
    mask = torch.tril(torch.ones((seq_len, seq_len), dtype=torch.bool, device=device))
    bias = torch.where(mask, torch.zeros((), device=device), torch.full((), -1e9, device=device))
    return bias.to(dtype)[None, None]


def xla_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    bias: Optional[Tensor] = None,
    dropout_seed: Optional[int] = None,
    dropout_rate: float = 0.0,
    train: bool = False,
    scale: Optional[float] = None,
) -> Tensor:
    """The plain path.  q, k, v [batch, seq, heads, head_dim]: float32
    scores, the causal bias, softmax, attention-prob dropout, probabilities
    cast to q's type, then p @ v.  ``scale=None`` is 1/sqrt(head_dim) in
    float32."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    if scale is None:
        scale_t = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32,
                                                device=q.device))
    else:
        scale_t = scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale_t
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    elif causal:
        scores = scores + causal_mask_bias(seq_k, scores.dtype, q.device)[:, :, -seq_q:, :]
    probs = torch.softmax(scores, dim=-1)
    if train and dropout_rate > 0.0 and dropout_seed is not None:
        keep = 1.0 - dropout_rate
        probs = probs * keep_mask(dropout_seed, probs.shape, keep, probs.device) / keep
    probs = probs.to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    impl: str = "xla",
    causal: bool = True,
    bias: Optional[Tensor] = None,
    dropout_seed: Optional[int] = None,
    dropout_rate: float = 0.0,
    train: bool = False,
    scale: Optional[float] = None,
    flash_block: int = 0,
    flash_bwd: str = "",
    tag: bool = False,
) -> Tensor:
    """The dispatch: ``impl="flash"`` with no bias, causal and the default
    scale takes the flash kernels.  On the card that holds at every seq:
    the kernels mask partial tiles, and what they do not take (dtype, head
    dim) raises there.  On the CPU the plain versions need a block that
    divides the seq, so a seq the block ladder misses warns once and takes
    the plain path, as the reference does on such a seq.  The flash path
    skips attention-prob dropout, as the reference does.

    ``tag`` names the plain path's output "attn_out" for a
    selective-recompute policy (``models/gpt/model._layer_remat``); the
    flash path's residuals are the outputs of its ``pfx::flash_attn_fwd``
    op."""
    if impl == "flash" and bias is None and causal and scale is None:
        if q.device.type == "cuda" or flash_supported(q.shape[1], flash_block):
            return flash_attention(q, k, v, causal=True, block=flash_block,
                                   bwd_schedule=flash_bwd)
        warnings.warn(
            f"flash attention unsupported for seq={q.shape[1]}; using XLA path",
            stacklevel=2,
        )
    out = xla_attention(
        q, k, v, causal=causal, bias=bias, dropout_seed=dropout_seed,
        dropout_rate=dropout_rate, train=train, scale=scale,
    )
    return checkpoint_name(out, "attn_out") if tag else out


