"""Sampling ops: temperature, top-k / top-p (nucleus) filtering and draws.

Counterpart of ``paddlefleetx_tpu/ops/sampling.py``.  Random draws come
from an explicit ``torch.Generator``; the nucleus samplers also take the
uniform draw itself (``u`` [b, 1]) so tests can feed both packages the
same numbers — threefry and torch's generators never agree.

The top-p stage goes through the top-k prefilter (:func:`sample_top_p_topk`,
64 candidates; ``PFX_TOPP_K`` overrides, 0 disables): exact against the
full sort whenever every row's nucleus fits the candidates, with the full
sort as the fallback when one does not.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

NEG_INF = -1e10


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the top-k logits."""
    if k <= 0:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Mask logits outside the nucleus of cumulative probability ``p``
    (sorted high to low; the crossing token stays; the best is kept)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p
    thresh = torch.where(
        keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF), logits)


def _uniform(probs: torch.Tensor, generator: Optional[torch.Generator],
             u: Optional[torch.Tensor]) -> torch.Tensor:
    if u is not None:
        return u.to(device=probs.device, dtype=torch.float32).reshape(-1, 1)
    return torch.rand((probs.shape[0], 1), generator=generator, device=probs.device)


def sample_top_p(
    probs: torch.Tensor,
    top_p: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Nucleus sample from probabilities [b, v] with per-row ``top_p`` [b]:
    sort once, truncate and renormalize the nucleus, inverse-CDF draw with
    one uniform per row, map back through the sort permutation."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = torch.gather(probs, -1, order)
    cum = torch.cumsum(sorted_p, dim=-1)
    in_nucleus = cum - sorted_p < top_p[:, None]
    in_nucleus[:, 0] = True  # always keep the argmax
    trunc = torch.where(in_nucleus, sorted_p, torch.zeros_like(sorted_p))
    total = trunc.sum(dim=-1, keepdim=True)
    u = _uniform(probs, generator, u) * total
    idx_sorted = (torch.cumsum(trunc, dim=-1) >= u).to(torch.int32).argmax(dim=-1)
    return torch.gather(order, -1, idx_sorted[:, None])[:, 0]


def _parse_prefilter_env() -> int:
    env = os.environ.get("PFX_TOPP_K") or ""
    if not env:
        return -1
    try:
        val = int(env)
    except ValueError:
        raise ValueError(
            f"PFX_TOPP_K={env!r} is not an integer; pass a positive "
            "candidate count (e.g. 64), 0 to disable the fast path, or unset it"
        ) from None
    if val < 0:
        raise ValueError(f"PFX_TOPP_K={val} must be >= 0")
    return val


def sample_top_p_topk(
    probs: torch.Tensor,
    top_p: torch.Tensor,
    k: int = 64,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Nucleus sample with a top-k prefilter: when every row's top-k mass
    covers its ``top_p``, the nucleus lies inside the k candidates, so
    truncate/renormalize those and draw there — the same nucleus, the same
    uniform and the same prefix sums as :func:`sample_top_p`.  Otherwise
    the whole batch takes the full sort.  Under a CUDA graph capture the
    host cannot read which case holds, so both run and the device picks:
    the same ids either way."""
    k = min(int(k), probs.shape[-1])
    top_probs, top_idx = torch.topk(probs, k, dim=-1)
    cum = torch.cumsum(top_probs, dim=-1)
    u = _uniform(probs, generator, u)
    fits = torch.all(cum[:, -1] >= top_p)
    capturing = probs.is_cuda and torch.cuda.is_current_stream_capturing()
    if not capturing and not bool(fits):
        return sample_top_p(probs, top_p, u=u)
    in_nucleus = cum - top_probs < top_p[:, None]
    in_nucleus[:, 0] = True
    trunc = torch.where(in_nucleus, top_probs, torch.zeros_like(top_probs))
    total = trunc.sum(dim=-1, keepdim=True)
    sel = (torch.cumsum(trunc, dim=-1) >= u * total).to(torch.int32).argmax(dim=-1)
    ids = torch.gather(top_idx, -1, sel[:, None])[:, 0]
    if capturing:
        return torch.where(fits, ids, sample_top_p(probs, top_p, u=u))
    return ids


def filtered_logits(
    logits: torch.Tensor,
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """The filter stages only (temperature -> top-k -> top-p)."""
    if temperature != 1.0:
        logits = logits / temperature
    if top_k > 0:
        logits = top_k_filter(logits, top_k)
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    return logits


def sample_logits(
    logits: torch.Tensor,
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    top_p_prefilter_k: int = 64,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """temperature -> top-k -> top-p -> categorical, for logits [b, vocab]
    -> ids [b].  The top-p stage draws through :func:`sample_top_p_topk`.

    Logits [b, K, vocab] (K positions) give ids [b, K]: each position is
    an independent draw of the [b, vocab] form, in position order from
    ``generator``.  The speculative verify rule draws its fresh and
    residual candidates this way with every filter at its identity
    setting: it filters once itself (``filtered_logits``), and filtering
    again would re-truncate the renormalized nucleus."""
    if logits.dim() == 3:
        return torch.stack([
            sample_logits(logits[:, j], temperature=temperature, top_k=top_k, top_p=top_p,
                          top_p_prefilter_k=top_p_prefilter_k, generator=generator)
            for j in range(logits.shape[1])
        ], dim=1)
    if temperature != 1.0:
        logits = logits / temperature
    if top_k > 0:
        logits = top_k_filter(logits, top_k)
    probs = torch.softmax(logits.float(), dim=-1)
    if top_p < 1.0:
        top_ps = torch.full((logits.shape[0],), top_p, device=logits.device)
        env_k = _parse_prefilter_env()
        k = top_p_prefilter_k if env_k < 0 else env_k
        if k <= 0:
            return sample_top_p(probs, top_ps, generator=generator)
        return sample_top_p_topk(probs, top_ps, k=k, generator=generator)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
