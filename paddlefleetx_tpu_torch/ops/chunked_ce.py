"""Chunked softmax cross-entropy: the [tokens, vocab] logits never
materialize.

Counterpart of ``paddlefleetx_tpu/ops/chunked_ce.py`` (a lax scan with a
custom VJP, not a Pallas kernel).  The GPT loss tail (logits = hidden @
word.T, then the float32 softmax CE) holds the model's largest
activation: [b * s, vocab] in float32.  Here the vocabulary streams in
chunks: the forward keeps an online log-sum-exp (running max ``m`` and sum
``s``) and the label's logit per token; the backward recomputes each
chunk's softmax from the saved lse, so peak memory is O(tokens x chunk).

The same semantics as ``models/gpt/model.cross_entropy``: each chunk's
logits are ``hidden @ word_c.T`` in the activation type (``word`` cast to
it, as ``logits_from_hidden`` casts), then float32; the loss is the
masked token mean.  In the backward ``dlogits`` drops to the activation
type for its two products, whose sums are float32 (``dh`` is carried in
float32 across the chunks; each chunk's ``dword`` is cast to word's type).
On the card the two products run as float32 matrix products of the
rounded values, the JAX kernel's ``preferred_element_type=float32``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

NEG = -1e30


def _chunk_logits(hidden2d: Tensor, word: Tensor, off: int, chunk: int) -> Tuple[Tensor, Tensor]:
    """(w_c in the activation type, the chunk's float32 logits [N, c]) for
    vocabulary rows off .. off + chunk (the last chunk may be shorter)."""
    w_c = word[off:off + chunk].to(hidden2d.dtype)
    return w_c, (hidden2d @ w_c.t()).float()


def _lse_picked(hidden2d: Tensor, word: Tensor, labels1d: Tensor,
                chunk: int) -> Tuple[Tensor, Tensor]:
    """Per token: log-sum-exp over the vocabulary and the label's logit,
    by an online max and sum over the chunks."""
    n, v = hidden2d.shape[0], word.shape[0]
    dev = hidden2d.device
    m = torch.full((n,), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros((n,), dtype=torch.float32, device=dev)
    picked = torch.zeros((n,), dtype=torch.float32, device=dev)
    for off in range(0, v, chunk):
        _, logits = _chunk_logits(hidden2d, word, off, chunk)
        cm = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - cm) + torch.exp(logits - cm[:, None]).sum(dim=-1)
        local = labels1d - off
        hit = (local >= 0) & (local < logits.shape[1])
        at = torch.gather(logits, 1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
        picked = picked + torch.where(hit, at, torch.zeros_like(at))
        m = cm
    return m + torch.log(torch.clamp(s, min=1e-30)), picked


class ChunkedNLL(torch.autograd.Function):
    """Per-token nll [N] of flattened hidden [N, h] against word [V, h]."""

    @staticmethod
    def forward(ctx, hidden2d, word, labels1d, chunk):
        lse, picked = _lse_picked(hidden2d, word, labels1d, chunk)
        ctx.save_for_backward(hidden2d, word, labels1d, lse)
        ctx.chunk = chunk
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        hidden2d, word, labels1d, lse = ctx.saved_tensors
        chunk, v = ctx.chunk, word.shape[0]
        gf = g.float()
        h32 = hidden2d.float()  # the activation type's values, exactly
        dh = torch.zeros(hidden2d.shape, dtype=torch.float32, device=hidden2d.device)
        dword = torch.empty_like(word)
        for off in range(0, v, chunk):
            w_c, logits = _chunk_logits(hidden2d, word, off, chunk)
            p = torch.exp(logits - lse[:, None])
            local = labels1d - off
            hit = (local >= 0) & (local < logits.shape[1])
            p.scatter_add_(1, local.clamp(0, logits.shape[1] - 1)[:, None],
                           -hit.to(p.dtype)[:, None])
            # dlogits in the activation type for the two products, summed
            # in float32; dh is carried in float32 across the chunks
            dlo = (p * gf[:, None]).to(hidden2d.dtype).float()
            dh += dlo @ w_c.float()
            dword[off:off + chunk] = (dlo.t() @ h32).to(word.dtype)
        return dh.to(hidden2d.dtype), dword, None, None


def chunked_cross_entropy(hidden: Tensor, word: Tensor, labels: Tensor,
                          loss_mask: Optional[Tensor] = None, chunk: int = 4096) -> Tensor:
    """Masked-mean CE of ``hidden @ word.T`` against ``labels`` without the
    [b, s, V] logits: hidden [b, s, h], word [V, h], labels [b, s]."""
    b, s, h = hidden.shape
    chunk = min(int(chunk), word.shape[0])
    nll = ChunkedNLL.apply(hidden.reshape(b * s, h), word, labels.reshape(b * s).long(),
                           chunk).reshape(b, s)
    if loss_mask is None:
        return nll.mean()
    mask = loss_mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
