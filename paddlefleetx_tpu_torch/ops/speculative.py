"""Speculative decoding: draft proposal and accept/reject verification.

Counterpart of ``paddlefleetx_tpu/ops/speculative.py`` (Leviathan et al.
2023).  A cheap drafter proposes k tokens, the target model verifies them
in ONE t = k + 1 forward (the cached and the paged forward both take
t > 1, and K7/K8/K9 take it on the card), and the accept rule keeps the
output distribution: greedy output is token-identical to the plain loop
(accept the prefix that matches the processed argmax; the first mismatch
is replaced by the target's own token), and sampled output keeps the
target distribution by the residual rule for a point-mass drafter
(accept draft d with probability p(d); on rejection draw from p with d's
mass removed and renormalized).

  - :class:`SpecConfig` / :func:`spec_config_from`: the
    ``Generation.speculative`` section (``draft_k``, ``drafter``,
    ``ngram``), loud on an unknown drafter or an invalid k.
  - :func:`ngram_propose` (tensors, the contiguous loop) and
    :func:`ngram_propose_host` (lists, the continuous engine): the
    self-drafting prompt-lookup drafter: the k tokens that followed the
    last earlier occurrence of the row's trailing n-gram.
  - :func:`speculative_verify`: the accept rule over one verified chunk,
    shared by both decode loops.

Random draws come from an explicit ``torch.Generator``; the accept test
also takes its uniforms as an argument (``u_accept``), so tests can feed
both packages the same numbers.  Threefry and torch's generators never
agree, so the fresh and residual draws cannot match the JAX package draw
for draw: sampled parity is a distribution test.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from paddlefleetx_tpu_torch.ops.sampling import filtered_logits, sample_logits

NEG = -1e10

DRAFTERS = ("ngram",)

# backwards-scan cap of the host drafter: bounds the per-step host cost on
# long rows that never repeat (callers hand it only this tail plus the
# needle and draft slack: the scan never looks further back)
NGRAM_WINDOW = 2048


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation settings.  ``draft_k``: proposal length per iteration
    (each verify forward takes k + 1 tokens and commits 1 to k + 1 of
    them); ``drafter``: the proposal source ("ngram", prompt lookup);
    ``ngram``: the lookup needle's length."""

    draft_k: int = 4
    drafter: str = "ngram"
    ngram: int = 2

    def __post_init__(self):
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if self.drafter not in DRAFTERS:
            raise ValueError(f"bad drafter {self.drafter!r}; valid: {', '.join(DRAFTERS)}")
        if self.ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {self.ngram}")


def spec_config_from(section) -> Optional[SpecConfig]:
    """Parse a ``Generation.speculative`` section: a :class:`SpecConfig`,
    or None when speculation is off (absent section or ``draft_k`` 0).
    Raises ValueError on an unknown drafter or an invalid k or n.
    ``kv_dtype`` in the same section routes to the cache allocation
    (``ops/decode_attention.kv_cache_dtype``), not here."""
    section = dict(section or {})
    draft_k = int(section.get("draft_k", 0) or 0)
    if draft_k == 0:
        return None
    return SpecConfig(
        draft_k=draft_k,
        drafter=str(section.get("drafter", "ngram")),
        ngram=int(section.get("ngram", 2)),
    )


# ---------------------------------------------------------------------------
# Self-drafting n-gram / prompt-lookup proposal
# ---------------------------------------------------------------------------


def ngram_propose(ctx: torch.Tensor, known_len: int, pending: torch.Tensor, k: int,
                  n: int = 2) -> torch.Tensor:
    """The contiguous loop's drafter, on the device.

    ``ctx`` [b, L] holds each row's prompt and committed tokens in slots
    [0, known_len); ``pending`` [b] is the decided next token, not yet in
    ctx.  The needle is the n-gram that ends at the pending token; the
    draft is the k tokens after its LAST earlier occurrence.  A row with
    no match, or whose continuation runs past the known region, repeats
    its pending token.  Returns int64 [b, k]."""
    if k < 1:
        raise ValueError(f"ngram_propose needs k >= 1, got {k}")
    b, L = ctx.shape
    dev = ctx.device
    known_len = int(known_len)
    idx = torch.arange(L, device=dev)
    match = torch.ones((b, L), dtype=torch.bool, device=dev)
    for j in range(n):
        shift = n - 1 - j
        if shift == 0:
            need, shifted = pending, ctx
        else:
            need = ctx[:, min(max(known_len - shift, 0), L - 1)]
            shifted = F.pad(ctx, (shift, 0))[:, :L]
        match = match & (shifted == need[:, None])
    # an end position p must fit the whole needle and leave at least one
    # predictable token: n - 1 <= p <= known_len - 2
    match = match & ((idx >= n - 1) & (idx <= known_len - 2))[None, :]
    has = match.any(dim=1)
    last_p = (L - 1) - match.flip(1).to(torch.int32).argmax(dim=1)
    offs = torch.arange(1, k + 1, device=dev)
    ends = last_p[:, None] + offs[None, :]
    cand = torch.gather(ctx, 1, torch.clamp(ends, 0, L - 1))
    valid = has[:, None] & (ends <= known_len - 1)
    return torch.where(valid, cand, pending[:, None].to(ctx.dtype))


def ngram_propose_host(seq: Sequence[int], k: int, n: int = 2,
                       window: int = NGRAM_WINDOW) -> List[int]:
    """The continuous engine's drafter, on the host: ``seq`` is a row's
    prompt and generated tokens.  Proposes the k tokens after the last
    earlier occurrence of the trailing n-gram (the last one repeated
    where the continuation is short); with no match, repeats the last
    token.  The backwards scan stops ``window`` positions back, so a long
    row that never repeats costs the same every step."""
    if k < 1:
        raise ValueError(f"ngram_propose_host needs k >= 1, got {k}")
    seq = list(seq)
    if not seq:
        return [0] * k
    last = seq[-1]
    if len(seq) > n:
        needle = seq[-n:]
        lo = max(n - 2, len(seq) - 2 - int(window))
        for p in range(len(seq) - 2, lo, -1):
            if seq[p - n + 1: p + 1] == needle:
                out = list(seq[p + 1: p + 1 + k])
                while len(out) < k:
                    out.append(out[-1])
                return out
    return [last] * k


# ---------------------------------------------------------------------------
# Accept/reject verification over one chunk
# ---------------------------------------------------------------------------


class SpecVerify(NamedTuple):
    """Verification of one [b, k+1] chunk = [pending, draft_0 .. draft_k-1].

    ``real`` [b, k+1]: slot j is committed as a real token if the commit
    window reaches it (the chain breaks at the first rejected draft and
    at the first EOS).  ``accepted`` [b]: accepted drafts (the real chain
    past slot 0).  ``eos_hit`` [b, k+1]: real slots holding EOS.  ``ok``
    [b, k]: each draft's accept test (greedy: equals the processed
    argmax; sampled: u < p(draft) under the filtered target).  ``pend``
    [b, k+1]: the next pending token if the window ends at slot j
    (greedy: the processed argmax; sampled: a residual draw where the
    draft was rejected, a fresh draw elsewhere).  ``w`` [b, k+1]: the
    chunk with the plain loop's pad substitution (finished, post-EOS and
    never-alive slots -> pad_token_id)."""

    real: torch.Tensor
    accepted: torch.Tensor
    eos_hit: torch.Tensor
    ok: torch.Tensor
    pend: torch.Tensor
    w: torch.Tensor


def _process(logits, counts, steps, gen, forced_steps):
    """The plain loop's logits-processor chain, single-sourced in
    ``models/gpt/generation.process_step_logits`` (imported here, since
    generation imports this module)."""
    from paddlefleetx_tpu_torch.models.gpt.generation import process_step_logits

    return process_step_logits(logits, steps, counts, forced_steps, gen)


def accept_probs(proc: torch.Tensor, drafts: torch.Tensor, gen):
    """The sampled accept test's distribution: (the filtered logits of
    ``proc`` (temperature -> top-k -> top-p, as the plain loop samples),
    p(draft) under their softmax).  ``proc`` [b, v] with ``drafts`` [b]
    (one slot), or [b, k+1, v] with [b, k] (the vectorized rule: the
    first k positions are read)."""
    filt = filtered_logits(proc, temperature=gen.temperature, top_k=gen.top_k,
                           top_p=gen.top_p)
    probs = torch.softmax(filt, dim=-1)
    if probs.dim() == 3:
        probs = probs[:, :drafts.shape[1]]
    return filt, torch.gather(probs, -1, drafts[..., None])[..., 0]


def _uniforms(shape, generator, u_accept, device):
    if u_accept is not None:
        return u_accept.to(device=device, dtype=torch.float32).reshape(shape)
    return torch.rand(shape, generator=generator, device=device)


def speculative_verify(
    logits_all: torch.Tensor,
    chunk: torch.Tensor,
    base_counts: Optional[torch.Tensor],
    alive0: torch.Tensor,
    step0,
    gen,
    forced_steps: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    u_accept: Optional[torch.Tensor] = None,
) -> SpecVerify:
    """Verify one chunk against the target logits: THE accept rule of the
    contiguous and the paged loop.

    ``logits_all`` [b, k+1, v]: slot j is the target distribution for
    step ``step0 + 1 + j``.  ``chunk`` [b, k+1]: slot 0 the decided
    pending token, slots 1..k the drafts.  ``base_counts`` [b, v] or None
    (None when repetition_penalty is 1.0): tokens emitted through step
    step0 - 1; it is not modified.  ``alive0`` [b]: unfinished at the
    window's start.  ``step0``: an int or [b] (paged rows sit at
    different steps).  ``forced_steps`` [b] overrides the step where
    forced EOS fires (default max_dec_len - 1).

    Greedy verification is an exact match against the processed argmax.
    Sampled verification accepts draft d when ``u < p(d)`` under the
    filtered target distribution, with ``u`` [b, k] from ``u_accept`` or
    drawn from ``generator``; fresh and residual candidates are drawn
    from ``generator``.  Without a repetition penalty every slot is
    processed at once; with one, the k+1 slots run in order, each slot's
    counts holding the chain's tokens so far."""
    greedy = gen.decode_strategy == "greedy_search"
    b, K, _ = logits_all.shape
    k = K - 1
    dev = logits_all.device
    pad, eos = gen.pad_token_id, gen.eos_token_id
    chunk = chunk.long()
    if isinstance(step0, torch.Tensor):
        steps0 = step0.to(device=dev, dtype=torch.int64).expand(b)
    else:
        steps0 = torch.full((b,), int(step0), dtype=torch.int64, device=dev)
    if forced_steps is None:
        forced_steps = torch.full((b,), gen.max_dec_len - 1, dtype=torch.int64, device=dev)
    noeos = chunk != eos
    logits_all = logits_all.float()
    rows = torch.arange(b, device=dev)

    if base_counts is None or gen.repetition_penalty == 1.0:
        # no counts feedback: every slot processed at once
        steps = steps0[:, None] + 1 + torch.arange(K, device=dev)[None, :]
        proc = _process(logits_all, None, steps, gen, forced_steps[:, None])
        if greedy:
            pend = torch.argmax(proc, dim=-1)
            ok = chunk[:, 1:] == pend[:, :k]
        else:
            filt, p_d = accept_probs(proc, chunk[:, 1:], gen)
            ok = _uniforms((b, k), generator, u_accept, dev) < p_d
            fresh = sample_logits(filt, generator=generator)
            resid_logits = filt[:, :k].clone()
            resid_logits[rows[:, None], torch.arange(k, device=dev)[None, :], chunk[:, 1:]] = NEG
            resid = sample_logits(resid_logits, generator=generator)
            pend = torch.cat([torch.where(ok, fresh[:, :k], resid), fresh[:, k:]], dim=1)
    else:
        # the penalty reads the counts of every earlier chunk token (with
        # the plain loop's pad substitution), which depend on the accept
        # chain so far: run the k+1 slots in order
        counts = base_counts.clone()
        real_j = alive0.clone()
        u = None if greedy else _uniforms((b, k), generator, u_accept, dev)
        pends, oks = [], []
        for j in range(K):
            w_j = torch.where(real_j, chunk[:, j], torch.full_like(chunk[:, j], pad))
            counts[rows, w_j] += 1
            proc_j = _process(logits_all[:, j], counts, steps0 + 1 + j, gen, forced_steps)
            ok_j = None
            if greedy:
                pend_j = torch.argmax(proc_j, dim=-1)
                if j < k:
                    ok_j = chunk[:, j + 1] == pend_j
            else:
                fresh_j = None
                if j < k:
                    d_j = chunk[:, j + 1]
                    filt_j, p_d = accept_probs(proc_j, d_j, gen)
                    ok_j = u[:, j] < p_d
                    fresh_j = sample_logits(filt_j, generator=generator)
                    resid_logits = filt_j.clone()
                    resid_logits[rows, d_j] = NEG
                    resid_j = sample_logits(resid_logits, generator=generator)
                    pend_j = torch.where(ok_j, fresh_j, resid_j)
                else:
                    filt_j = filtered_logits(proc_j, temperature=gen.temperature,
                                             top_k=gen.top_k, top_p=gen.top_p)
                    pend_j = sample_logits(filt_j, generator=generator)
            pends.append(pend_j)
            if ok_j is not None:
                oks.append(ok_j)
                real_j = real_j & ok_j & noeos[:, j]
        pend = torch.stack(pends, dim=1)
        ok = torch.stack(oks, dim=1)

    cond = ok & noeos[:, :k]
    chain = torch.cumprod(cond.to(torch.int32), dim=1).bool()
    real = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), chain], dim=1)
    real = real & alive0[:, None]
    accepted = chain.sum(dim=1)
    eos_hit = real & ~noeos
    w = torch.where(real, chunk, torch.full_like(chunk, pad))
    return SpecVerify(real=real, accepted=accepted, eos_hit=eos_hit, ok=ok, pend=pend.long(),
                      w=w)
