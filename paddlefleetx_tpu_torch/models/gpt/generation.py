"""GPT autoregressive generation: KV-cache forward, logits processors and
the greedy/sampling decode loop.

Counterpart of ``paddlefleetx_tpu/models/gpt/generation.py:47-560``.
Differences of idiom, not of result:

  - The KV cache is written IN PLACE (``cache.k[layer, :, :, pos:pos+t] =
    ...``).  JAX donates the cache buffer to get the same effect; here a
    cache passed to :func:`forward_cached` or :func:`generate` is
    mutated, and a caller that keeps one for reuse (``core/serving.py``'s
    pool) hands the same tensors back on the next same-shape request.
    Slots past ``pos + t`` may hold stale keys from an earlier request:
    attention never reads them.
  - The decode loop is a Python loop with ``pos`` a Python int, so the
    attention kernel's ``limit`` needs no device read.  Greedy/sampling
    stops once no row is unfinished, like the JAX ``while_loop``
    (``PFX_DECODE_SCAN=1`` runs all ``max_dec_len`` steps, like
    ``lax.scan``).  The forward after the last emitted token is skipped:
    its logits would feed nothing.
  - Random draws come from an explicit ``torch.Generator``.

The paged half (``generation.py:767-1233`` of the JAX package) exposes
ONE decode step over a batch of independent rows with their own
positions, budgets and block tables into a shared arena
(:class:`PagedPools`), so the continuous-batching engine
(``core/continuous_batching.py``) can admit and retire rows at every
step boundary.  Its arena writes are in place too.

Speculative decoding runs on both halves: ``generate(..., spec=)``
verifies a [pending, draft_0 .. draft_k-1] chunk per iteration in one
t = k + 1 forward and commits the batch's least accepted prefix (the
contiguous cache writes one chunk at a shared position), and
:func:`decode_step_spec` does the same over the paged arena with a true
per-row commit.  Greedy output is token-identical to the plain loops:
every caller samples through the one processor chain,
:func:`process_step_logits`.

Chunked prefill and the prefix cache ride the same multi-token paged
forward: :func:`paged_chunk_prefill` writes a chunk of prompt tokens
straight into a row's blocks (pad slots null-routed by ``n_valid``),
and :func:`gather_kv_blocks` / :func:`scatter_kv_blocks` move whole
blocks between the arena and host RAM for the prefix spill tier.

Beam search (:func:`beam_search`, ``decode_strategy="beam_search"``)
prefills once per prompt, repeats the cache and the last logits
``num_beams``-fold, and reorders the cache rows by parent beam every step
(``index_select``); its cache is always in the model dtype.  Its top-k
breaks ties by the lower index, as ``jax.lax.top_k`` does
(:func:`top_k_lower_index`), so tied logits choose the JAX package's
beams.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.models.gpt.model import (
    DTYPES,
    GPTModel,
    embed,
    layer_norm,
    logits_from_hidden,
)
from paddlefleetx_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attn_mode,
    dense_cache_attention,
    kv_cache_dtype,
    paged_decode_attention,
    quantize_kv,
)
from paddlefleetx_tpu_torch.ops.sampling import filtered_logits, sample_logits
from paddlefleetx_tpu_torch.ops.speculative import (
    SpecConfig,
    ngram_propose,
    speculative_verify,
)


@dataclasses.dataclass
class KVCache:
    """Contiguous decode cache, written in place.  ``k``/``v`` are
    [layers, b, heads, max_len, head_dim] in the model dtype, or int8
    with ``k_scale``/``v_scale`` [layers, b, heads, max_len] float32
    per-(slot, head) scales written beside every update."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_cache(
    cfg: GPTConfig,
    batch: int,
    max_len: int,
    device: torch.device,
    kv_dtype: str = "",
) -> KVCache:
    """A zeroed cache.  ``kv_dtype``: "" resolves PFX_KV_DTYPE; "bf16"
    keeps the model dtype; "int8" allocates the quantized pair plus its
    scale planes."""
    shape = (cfg.num_layers, batch, cfg.num_attention_heads, max_len, cfg.head_dim)
    if kv_cache_dtype(kv_dtype) == "int8":
        sshape = shape[:-1]
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
        )
    dtype = DTYPES[cfg.dtype]
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def _qkv(layer, x: torch.Tensor):
    """LayerNorm 1 and the fused qkv projection: x [b, t, h] -> q, k, v
    [b, t, heads, head_dim] in the model dtype."""
    b, t, h = x.shape
    attn = layer.attn
    _, nh, hd = attn.qkv_bias.shape
    y = layer_norm(x, layer.ln_1.scale, layer.ln_1.bias)
    qkv = y @ attn.qkv_kernel.view(h, 3 * nh * hd) + attn.qkv_bias.view(-1)
    return qkv.view(b, t, 3, nh, hd).unbind(2)


def _finish_layer(layer, x: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
    """Output projection of the attention result [b, t, heads, head_dim],
    residual, LayerNorm 2, tanh-GELU MLP, residual."""
    b, t, h = x.shape
    attn, mlp = layer.attn, layer.mlp
    nh, hd = attn_out.shape[2], attn_out.shape[3]
    out = attn_out.reshape(b, t, nh * hd) @ attn.out_kernel.view(nh * hd, h) + attn.out_bias
    x = x + out
    y = layer_norm(x, layer.ln_2.scale, layer.ln_2.bias)
    y = y @ mlp.fc_in_kernel + mlp.fc_in_bias
    y = F.gelu(y, approximate="tanh")
    y = y @ mlp.fc_out_kernel + mlp.fc_out_bias
    return x + y


def _layer_with_cache(
    layer,
    x: torch.Tensor,
    cache: KVCache,
    li: int,
    pos: int,
    kv_valid_from: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decoder layer over x [b, t, h]: writes this chunk's K/V into
    layer ``li`` of the cache at ``[pos, pos + t)`` (quantized on write
    for an int8 cache) and attends over keys ``[0, pos + t)``."""
    t = x.shape[1]
    q, k, v = _qkv(layer, x)

    kc = k.transpose(1, 2)  # [b, n, t, d]: transpose the chunk, never the cache
    vc = v.transpose(1, 2)
    k_scale = v_scale = None
    if cache.k_scale is not None:
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        cache.k[li, :, :, pos:pos + t] = kq
        cache.v[li, :, :, pos:pos + t] = vq
        cache.k_scale[li, :, :, pos:pos + t] = ks
        cache.v_scale[li, :, :, pos:pos + t] = vs
        k_scale, v_scale = cache.k_scale[li], cache.v_scale[li]
    else:
        cache.k[li, :, :, pos:pos + t] = kc
        cache.v[li, :, :, pos:pos + t] = vc

    if decode_attn_mode() == "dense":
        out = dense_cache_attention(
            q, cache.k[li], cache.v[li], pos, kv_valid_from=kv_valid_from,
            k_scale=k_scale, v_scale=v_scale,
        )
    else:
        out = decode_attention(
            q, cache.k[li], cache.v[li], pos, kv_valid_from=kv_valid_from,
            k_scale=k_scale, v_scale=v_scale,
        )
    return _finish_layer(layer, x, out)


def forward_cached(
    model: GPTModel,
    tokens: torch.Tensor,
    cache: KVCache,
    pos: int,
    position_ids: Optional[torch.Tensor] = None,
    kv_valid_from: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [b, t] at cache positions [pos, pos + t) -> logits [b, t,
    vocab] in the model dtype; the cache is updated in place.

    ``position_ids`` [b, t] overrides the position-embedding indices
    ``pos + arange(t)`` and ``kv_valid_from`` [b] int32 masks cache keys
    before each row's first real token: together they serve left-padded
    prompt buckets."""
    t = tokens.shape[1]
    if position_ids is None:
        position_ids = pos + torch.arange(t, device=tokens.device)
    x = embed(model, tokens, position_ids)
    for li, layer in enumerate(model.layers):
        x = _layer_with_cache(layer, x, cache, li, pos, kv_valid_from)
    x = layer_norm(x, model.final_ln.scale, model.final_ln.bias)
    return logits_from_hidden(model, x)


# ---------------------------------------------------------------------------
# Logits processors
# ---------------------------------------------------------------------------


def apply_repetition_penalty(logits, token_counts, penalty: float):
    """Divide positive / multiply negative logits of tokens already seen."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, penalized, logits)


def apply_min_length(logits, cur_len: int, min_len: int, eos_token_id: int):
    """Suppress EOS (-1e10) while ``cur_len < min_len``."""
    if min_len <= 0 or cur_len >= min_len or not 0 <= eos_token_id < logits.shape[-1]:
        return logits
    logits = logits.clone()
    logits[..., eos_token_id] = -1e10
    return logits


def apply_forced_token(logits, step: int, force_at_step: int, token_id: int):
    """Force ``token_id`` at decode step ``force_at_step`` (-1 = off)."""
    if token_id < 0 or step != force_at_step:
        return logits
    forced = torch.full_like(logits, -1e10)
    forced[..., token_id] = 0.0
    return forced


def apply_hamming_diversity(logits, current_tokens, group_start: int, penalty: float):
    """Penalize tokens already chosen by EARLIER beam groups at this step
    (JAX ``apply_hamming_diversity``, batched): ``logits`` [b, Kg, v];
    ``current_tokens`` [b, K] holds this step's choices of the groups
    processed so far (entries >= ``group_start`` are not yet decided and
    count for nothing)."""
    if penalty == 0.0:
        return logits
    decided = torch.arange(current_tokens.shape[1], device=logits.device) < group_start
    decided = decided[None, :].expand_as(current_tokens)
    idx = torch.where(decided, current_tokens, torch.zeros_like(current_tokens)).long()
    counts = torch.zeros((logits.shape[0], logits.shape[-1]), dtype=logits.dtype,
                         device=logits.device)
    counts.scatter_add_(1, idx, decided.to(logits.dtype))
    return logits - penalty * counts[:, None, :]


# ---------------------------------------------------------------------------
# Generation loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode settings (the JAX ``GenerationConfig``)."""

    max_dec_len: int = 64
    min_dec_len: int = 1
    decode_strategy: str = "sampling"  # sampling | greedy_search | beam_search
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_id: int = 50256
    pad_token_id: int = 0
    # beam search
    num_beams: int = 4
    length_penalty: float = 1.0
    # diverse (group) beam search: the Hamming diversity penalty
    num_beam_groups: int = 1
    diversity_penalty: float = 0.0
    # ForcedBOS/ForcedEOS processors (-1 = disabled)
    forced_bos_token_id: int = -1
    forced_eos_token_id: int = -1

    def __post_init__(self):
        if self.decode_strategy not in ("sampling", "greedy_search", "beam_search"):
            raise ValueError(
                f"bad decode_strategy {self.decode_strategy!r}; "
                "valid: sampling, greedy_search, beam_search"
            )


def decode_loop_mode() -> str:
    """PFX_DECODE_SCAN: "1" runs all ``max_dec_len`` steps ("scan"), "0" or
    unset stops early once every row finished ("while")."""
    env = os.environ.get("PFX_DECODE_SCAN") or "0"
    if env not in ("0", "1"):
        raise ValueError(f"PFX_DECODE_SCAN={env!r}; valid: 0, 1")
    return "scan" if env == "1" else "while"


def _left_pad_prefill(
    prompt_len: int, prompt_lens: Optional[torch.Tensor]
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(pad_len int32 [b], prefill position ids [b, P]) for left-padded
    buckets; (None, None) on the unpadded path."""
    if prompt_lens is None:
        return None, None
    pad_len = (prompt_len - prompt_lens).to(torch.int32)
    ar = torch.arange(prompt_len, device=prompt_lens.device)
    pos_ids = torch.clamp(ar[None, :] - pad_len[:, None], min=0)
    return pad_len, pos_ids


def bucket_len(longest: int, multiple: int) -> int:
    """THE prompt-bucket formula (next multiple of ``multiple``), shared by
    ``pad_prompts``, ``GenerationServer.warmup`` and the serve layer's
    coalesce key so they cannot drift apart."""
    return ((int(longest) + int(multiple) - 1) // int(multiple)) * int(multiple)


def pad_prompts(
    prompts: Sequence[Sequence[int]],
    pad_token_id: int,
    multiple: int = 64,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-pad variable-length prompts to a shared bucketed width.
    Returns (int64 [b, P] ids, int32 [b] prompt lengths)."""
    P = bucket_len(max(len(p) for p in prompts), multiple)
    rows: List[List[int]] = [
        [pad_token_id] * (P - len(p)) + [int(x) for x in p] for p in prompts
    ]
    ids = torch.tensor(rows, dtype=torch.int64, device=device)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    return ids, lens


@torch.inference_mode()
def generate(
    model: GPTModel,
    input_ids: torch.Tensor,
    gen: GenerationConfig,
    *,
    generator: Optional[torch.Generator] = None,
    prompt_lens: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    return_cache: bool = False,
    spec: Optional[SpecConfig] = None,
    return_spec_stats: bool = False,
):
    """input_ids [b, P] -> generated ids int64 [b, max_dec_len] (pad-filled
    after a row emits EOS).

    Without ``prompt_lens`` the prompts are unpadded; with ``prompt_lens``
    [b] rows are LEFT-padded to P (:func:`pad_prompts`): pad keys are
    masked and position ids start at each row's first real token.

    ``cache``: a preallocated ``init_cache(cfg, b, P + max_dec_len)`` to
    write into (it is mutated); ``return_cache`` returns ``(tokens,
    cache)``.

    ``spec`` routes the decode through the speculative loop
    (:func:`_generate_speculative`): k drafts an iteration, verified in
    one t = k + 1 forward; greedy output is token-identical to the plain
    loop.  The cache then needs ``spec.draft_k`` slack slots past
    ``P + max_dec_len`` for the last chunk's rejected tail.
    ``return_spec_stats`` appends ``(proposed, accepted)`` draft counts
    to the returned tuple.

    ``decode_strategy="beam_search"`` runs :func:`beam_search`: no
    ``cache``, ``return_cache`` or ``spec`` (the beam loop reorders its
    own cache)."""
    if return_spec_stats and spec is None:
        raise ValueError("return_spec_stats needs a SpecConfig")
    if spec is not None and decode_loop_mode() == "scan":
        raise ValueError(
            "speculative decoding needs the early-exit decode loop (a variable "
            "number of tokens an iteration); unset PFX_DECODE_SCAN"
        )
    cfg = model.config
    b, prompt_len = input_ids.shape
    max_len = prompt_len + gen.max_dec_len
    cache_len = max_len + (spec.draft_k if spec is not None else 0)
    if max_len > cfg.max_position_embeddings:
        # with prompt_lens the positions are bounded by the real lengths
        real = None if prompt_lens is None else int(prompt_lens.max()) + gen.max_dec_len
        if real is None or real > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt_len {prompt_len} + max_dec_len {gen.max_dec_len} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}"
            )
    if gen.decode_strategy == "beam_search":
        if cache is not None or return_cache:
            raise ValueError(
                "cache reuse/return is not supported for beam_search (the beam loop "
                "reorders the cache by parent each step)"
            )
        if spec is not None:
            raise ValueError(
                "speculative decoding is not supported for beam_search (the beam loop "
                "reorders the cache by parent each step)"
            )
        return beam_search(model, input_ids, gen, prompt_lens=prompt_lens)
    dev = input_ids.device
    pad_len, prefill_pos_ids = _left_pad_prefill(prompt_len, prompt_lens)
    want = (cfg.num_layers, b, cfg.num_attention_heads, cache_len, cfg.head_dim)
    if cache is None:
        cache = init_cache(cfg, b, cache_len, dev)
    elif tuple(cache.k.shape) != want:
        raise ValueError(
            f"provided cache shape {tuple(cache.k.shape)} != required {want} "
            f"(prompt {prompt_len} + max_dec_len {gen.max_dec_len}"
            + (f" + draft_k {spec.draft_k}" if spec is not None else "") + ")"
        )

    if pad_len is None:
        valid = torch.ones((b, prompt_len), dtype=torch.int32, device=dev)
    else:
        valid = (
            torch.arange(prompt_len, device=dev)[None, :] >= pad_len[:, None]
        ).to(torch.int32)
    counts = torch.zeros((b, cfg.vocab_size), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, input_ids, valid)

    logits = forward_cached(
        model, input_ids, cache, 0,
        position_ids=prefill_pos_ids, kv_valid_from=pad_len,
    )
    last = logits[:, -1, :].float()
    if spec is not None:
        tokens, stats = _generate_speculative(
            model, input_ids, gen, spec, generator, prompt_lens, pad_len, cache, counts, last,
        )
        out = (tokens,) + ((cache,) if return_cache else ()) + (
            (stats,) if return_spec_stats else ())
        return out if len(out) > 1 else tokens

    tokens = torch.full((b, gen.max_dec_len), gen.pad_token_id, dtype=torch.int64, device=dev)
    unfinished = torch.ones((b,), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    run_all = decode_loop_mode() == "scan"
    for i in range(gen.max_dec_len):
        lg = apply_min_length(last, i, gen.min_dec_len, gen.eos_token_id)
        lg = apply_repetition_penalty(lg, counts, gen.repetition_penalty)
        lg = apply_forced_token(lg, i, 0, gen.forced_bos_token_id)
        lg = apply_forced_token(lg, i, gen.max_dec_len - 1, gen.forced_eos_token_id)
        if gen.decode_strategy == "greedy_search":
            nxt = torch.argmax(lg, dim=-1)
        else:
            nxt = sample_logits(
                lg, temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
                generator=generator,
            )
        nxt = torch.where(unfinished, nxt, torch.full_like(nxt, gen.pad_token_id))
        unfinished = unfinished & (nxt != gen.eos_token_id)
        counts[rows, nxt] += 1
        tokens[:, i] = nxt
        if i == gen.max_dec_len - 1 or not (run_all or bool(unfinished.any())):
            break
        step_pos_ids = None if prompt_lens is None else (prompt_lens + i)[:, None]
        new_logits = forward_cached(
            model, nxt[:, None], cache, prompt_len + i,
            position_ids=step_pos_ids, kv_valid_from=pad_len,
        )
        last = new_logits[:, -1, :].float()
    return (tokens, cache) if return_cache else tokens


# ---------------------------------------------------------------------------
# Beam search (JAX generation.py:1362-1558): K alive beams per prompt and a
# K-slot finished pool; diverse groups through the Hamming penalty
# ---------------------------------------------------------------------------


def _length_penalty(length: int, alpha: float, device) -> torch.Tensor:
    return torch.tensor(float(length), dtype=torch.float32, device=device).pow(alpha)


def top_k_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices in
    ``jax.lax.top_k``'s order: descending, ties by the lower index (a
    stable sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_search(
    model: GPTModel,
    input_ids: torch.Tensor,
    gen: GenerationConfig,
    prompt_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Beam search: input_ids [b, P] -> int64 [b, max_dec_len].

    K = ``num_beams`` alive beams per prompt plus a K-slot finished pool.
    Each step takes the top 2*Kg candidates of each beam group (Kg = K /
    ``num_beam_groups``) over [b, Kg * vocab] cumulative log-probs, moves
    EOS continuations into the finished pool scored with the length
    penalty (pool [b, K] + [b, 2Kg] -> top K), keeps the best Kg non-EOS
    continuations alive and reorders the cache by parent beam.
    ``diversity_penalty`` applies the Hamming penalty against earlier
    groups' choices at the same step.  No repetition penalty on the beam
    path, as in the JAX package.  At the end the alive beams, scored at
    full length, join the pool and each prompt's best sequence wins
    (the first maximum).  The forward after the last step is skipped: its
    logits would feed nothing."""
    cfg = model.config
    b, prompt_len = input_ids.shape
    K, G = gen.num_beams, gen.num_beam_groups
    if K % G:
        raise ValueError(f"num_beams {K} not divisible by num_beam_groups {G}")
    Kg = K // G
    vocab = cfg.vocab_size
    DEC = gen.max_dec_len
    dev = input_ids.device
    alpha = gen.length_penalty
    NEG = -1e9

    # prefill ONCE per prompt, then repeat the cache and logits K-fold; the
    # cache is in the model dtype whatever PFX_KV_DTYPE says (int8 covers
    # the sampling / greedy paths, not beam)
    pad_len, prefill_pos_ids = _left_pad_prefill(prompt_len, prompt_lens)
    cache = init_cache(cfg, b, prompt_len + DEC, dev, kv_dtype="bf16")
    logits = forward_cached(model, input_ids, cache, 0, position_ids=prefill_pos_ids,
                            kv_valid_from=pad_len)
    cache = KVCache(cache.k.repeat_interleave(K, dim=1), cache.v.repeat_interleave(K, dim=1))
    last = logits[:, -1, :].float().repeat_interleave(K, dim=0)  # [b*K, v]
    pad_flat = pad_len.repeat_interleave(K) if pad_len is not None else None
    lens_flat = prompt_lens.repeat_interleave(K) if prompt_lens is not None else None

    # only each group's first beam is live at step 0 (no duplicates)
    beam = torch.arange(K, device=dev)
    scores = torch.where(beam % Kg == 0, 0.0, NEG).to(torch.float32)[None].repeat(b, 1)
    seqs = torch.full((b, K, DEC), gen.pad_token_id, dtype=torch.int64, device=dev)
    fin_scores = torch.full((b, K), NEG, dtype=torch.float32, device=dev)
    fin_seqs = seqs.clone()
    bidx = torch.arange(b, device=dev)[:, None]
    for i in range(DEC):
        logp = F.log_softmax(last, dim=-1)
        logp = apply_min_length(logp, i, gen.min_dec_len, gen.eos_token_id)
        logp = apply_forced_token(logp, i, 0, gen.forced_bos_token_id)
        logp = apply_forced_token(logp, i, DEC - 1, gen.forced_eos_token_id)
        logp = logp.view(b, K, vocab)

        new_scores = scores.clone()
        chosen_tok = torch.zeros((b, K), dtype=torch.int64, device=dev)
        chosen_parent = torch.zeros((b, K), dtype=torch.int64, device=dev)
        step_tokens = torch.full((b, K), -1, dtype=torch.int64, device=dev)
        for g in range(G):
            sl = slice(g * Kg, (g + 1) * Kg)
            glogp = logp[:, sl]
            if gen.diversity_penalty > 0.0 and g > 0:
                glogp = apply_hamming_diversity(glogp, step_tokens, g * Kg,
                                                gen.diversity_penalty)
            cand = (scores[:, sl, None] + glogp).reshape(b, Kg * vocab)
            top_s, top_i = top_k_lower_index(cand, 2 * Kg)
            tok = top_i % vocab
            parent = top_i // vocab + g * Kg
            is_eos = tok == gen.eos_token_id

            # the finished pool: EOS continuations, length-penalized
            f_cand = torch.where(is_eos, top_s / _length_penalty(i + 1, alpha, dev),
                                 torch.full_like(top_s, NEG))
            f_seqs = seqs[bidx, parent]
            f_seqs[:, :, i] = tok
            all_f_scores = torch.cat([fin_scores, f_cand], dim=1)
            all_f_seqs = torch.cat([fin_seqs, f_seqs], dim=1)
            fin_scores, keep_i = top_k_lower_index(all_f_scores, K)
            fin_seqs = all_f_seqs[bidx, keep_i]

            # alive: the best Kg non-EOS continuations
            alive_s = torch.where(is_eos, torch.full_like(top_s, NEG), top_s)
            a_s, a_i = top_k_lower_index(alive_s, Kg)
            a_tok = tok.gather(1, a_i)
            new_scores[:, sl] = a_s
            chosen_tok[:, sl] = a_tok
            chosen_parent[:, sl] = parent.gather(1, a_i)
            step_tokens[:, sl] = a_tok

        # reorder the sequences and the cache by parent beam, then append
        seqs = seqs[bidx, chosen_parent]
        seqs[:, :, i] = chosen_tok
        scores = new_scores
        if i == DEC - 1:
            break
        flat_parent = (bidx * K + chosen_parent).reshape(-1)
        cache = KVCache(cache.k.index_select(1, flat_parent),
                        cache.v.index_select(1, flat_parent))
        step_pos_ids = (lens_flat + i)[:, None] if lens_flat is not None else None
        new_logits = forward_cached(model, chosen_tok.reshape(b * K, 1), cache,
                                    prompt_len + i, position_ids=step_pos_ids,
                                    kv_valid_from=pad_flat)
        last = new_logits[:, -1, :].float()

    # the still-alive beams join the pool, scored at full length
    alive_final = scores / _length_penalty(DEC, alpha, dev)
    all_scores = torch.cat([fin_scores, alive_final], dim=1)
    all_seqs = torch.cat([fin_seqs, seqs], dim=1)
    best = torch.argmax(all_scores, dim=1)
    return all_seqs[torch.arange(b, device=dev), best]


# ---------------------------------------------------------------------------
# Speculative decode loop (contiguous path): each iteration forwards a
# [pending, draft_0 .. draft_k-1] chunk (t = k + 1) through the same cached
# forward as the plain loop, verifies the drafts against the target's own
# processed logits and commits the batch's least accepted prefix plus the
# pending token: 1 to k + 1 tokens a forward instead of 1.
# ---------------------------------------------------------------------------


def _generate_speculative(model, input_ids, gen, spec, generator, prompt_lens, pad_len, cache,
                          counts, last):
    """The speculative spelling of :func:`generate`'s loop, from the
    prefill's last logits ``last`` [b, v] and the prompt counts on.
    Returns (tokens [b, max_dec_len], (proposed, accepted)).

    Commit rule: every row verifies its own drafts, but the batch commits
    the LEAST accepted length m over unfinished rows (one [b, t] chunk
    is written at one cache position, so rows cannot advance apart).  A
    row's committed tokens are a verified prefix of its own acceptance,
    so greedy output equals the plain loop's; a row that accepted more
    verifies the surplus again next iteration.  A row that hit EOS inside
    its accepted prefix stops constraining m.

    Cache rewind: the chunk writes K/V at [pos, pos + k], only [pos, pos +
    m] are committed, and the next chunk starts at pos + m + 1 and spans
    k + 1 slots, so every stale slot is written again before attention
    reads it (attention never reads past pos + t).  The cache carries
    ``draft_k`` slack slots for the last iteration's overrun, whose
    position ids clamp to the embedding table (never committed)."""
    cfg = model.config
    b, prompt_len = input_ids.shape
    dev = input_ids.device
    k = spec.draft_k
    K = k + 1
    DEC = gen.max_dec_len
    pad = gen.pad_token_id
    use_counts = gen.repetition_penalty != 1.0
    # pending_0: the plain loop's step-0 token, through the same processors
    p0 = process_step_logits(
        last, torch.zeros((b,), dtype=torch.int64, device=dev), counts,
        torch.full((b,), DEC - 1, dtype=torch.int64, device=dev), gen,
    )
    if gen.decode_strategy == "greedy_search":
        pending = torch.argmax(p0, dim=-1)
    else:
        pending = sample_logits(
            p0, temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
            generator=generator,
        )
    # the drafter's context: the prompt, then the committed tokens (with
    # k + 1 write slack past max_dec_len)
    ctx = torch.full((b, prompt_len + DEC + K), pad, dtype=torch.int64, device=dev)
    ctx[:, :prompt_len] = input_ids
    tokens = ctx[:, prompt_len:]
    base = (prompt_lens.long() if prompt_lens is not None
            else torch.full((b,), prompt_len, dtype=torch.int64, device=dev))
    slots = torch.arange(K, device=dev)
    unfinished = torch.ones((b,), dtype=torch.bool, device=dev)
    emitted = proposed = accepted = 0
    while emitted < DEC:
        n_alive = int(unfinished.sum())
        if n_alive == 0:
            break
        draft = ngram_propose(ctx, prompt_len + emitted, pending, k, n=spec.ngram)
        chunk = torch.cat([pending[:, None], draft], dim=1)
        pos_ids = torch.clamp(base[:, None] + emitted + slots[None, :],
                              0, cfg.max_position_embeddings - 1)
        logits_all = forward_cached(model, chunk, cache, prompt_len + emitted,
                                    position_ids=pos_ids, kv_valid_from=pad_len)
        sv = speculative_verify(
            logits_all.float(), chunk, counts if use_counts else None, unfinished, emitted,
            gen, generator=generator,
        )
        # rows finished before the window, or by it (EOS inside their
        # accepted prefix), stop constraining the commit
        constraint = torch.where(~unfinished | sv.eos_hit.any(dim=1),
                                 torch.full_like(sv.accepted, k), sv.accepted)
        m = min(int(constraint.min()), DEC - 1 - emitted)
        jmask = slots <= m
        tokens[:, emitted:emitted + K] = torch.where(jmask[None, :], sv.w,
                                                     torch.full_like(sv.w, pad))
        counts.scatter_add_(1, sv.w, jmask[None, :].expand(b, K).to(torch.int32))
        unfinished = unfinished & ~(sv.eos_hit & jmask[None, :]).any(dim=1)
        # the next pending token: the already-accepted surplus draft where
        # the row out-accepted the batch, else the verify candidate
        # (correction, residual draw or bonus token)
        nxt = torch.where(sv.accepted > m, chunk[:, min(m + 1, k)], sv.pend[:, m])
        pending = torch.where(unfinished, nxt, torch.full_like(nxt, pad))
        emitted += m + 1
        proposed += k * n_alive
        accepted += m * n_alive
    return tokens[:, :DEC].clone(), (proposed, accepted)


# ---------------------------------------------------------------------------
# Paged KV arena: one decode step over independent rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedPools:
    """The paged KV arena, written in place: ``k``/``v`` [layers,
    num_blocks, heads, block, head_dim] in the model dtype, or int8 with
    ``k_scale``/``v_scale`` [layers, num_blocks, heads, block] float32
    scale tiles beside each block.  Block 0 is the NULL block: never
    allocated to a sequence; inactive rows route their writes there."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_paged_pools(
    cfg: GPTConfig,
    num_blocks: int,
    block: int,
    device: torch.device,
    kv_dtype: str = "",
) -> PagedPools:
    """A zeroed arena.  ``kv_dtype`` as in :func:`init_cache`."""
    shape = (cfg.num_layers, num_blocks, cfg.num_attention_heads, block, cfg.head_dim)
    if kv_cache_dtype(kv_dtype) == "int8":
        sshape = shape[:-1]
        return PagedPools(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
        )
    dtype = DTYPES[cfg.dtype]
    return PagedPools(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


@dataclasses.dataclass
class PagedRows:
    """Per-row decode state threaded through :func:`decode_step` (device
    tensors, [B] unless noted).  ``positions`` is each row's NEXT write
    slot (real prompt length + tokens generated); ``gen_steps`` counts
    generated tokens; ``max_news`` is the per-row decode budget;
    ``forced_steps`` the step where ``forced_eos_token_id`` fires (the
    contiguous path's bucketed run end); ``logits`` [B, vocab] float32
    are the pending next-token logits and ``counts`` [B, vocab] int32
    back the repetition penalty.

    ``reject`` (speculative steps only, else None) [B]: the draft the
    last verify REJECTED at exactly the carried logits' position, or -1.
    Sampled decode masks it out of the filtered distribution before the
    next draw: the residual rule carried across the step boundary.
    Greedy ignores it (the argmax already differs from a rejected
    draft)."""

    logits: torch.Tensor
    counts: torch.Tensor
    positions: torch.Tensor
    gen_steps: torch.Tensor
    max_news: torch.Tensor
    active: torch.Tensor
    forced_steps: torch.Tensor
    reject: Optional[torch.Tensor] = None


def _paged_layer_step(
    layer,
    x: torch.Tensor,
    pools: PagedPools,
    li: int,
    blk: torch.Tensor,
    off: torch.Tensor,
    tables: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """One decoder layer over x [b, t, h]: write each chunk token's K/V
    at pool slot (blk[i, j], off[i, j]) of layer ``li`` (in place;
    quantized on write for int8 pools), then block-table attention with
    per-query causal bounds.  Rows own disjoint blocks, so the only
    index collisions are inactive rows' null-block writes."""
    q, k, v = _qkv(layer, x)
    n = q.shape[2]
    idx_b = blk[:, :, None]  # [b, t, 1]
    idx_n = torch.arange(n, device=x.device)[None, None, :]  # [1, 1, n]
    idx_o = off[:, :, None]
    k_scale = v_scale = None
    if pools.k_scale is not None:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        pools.k[li, idx_b, idx_n, idx_o] = kq
        pools.v[li, idx_b, idx_n, idx_o] = vq
        pools.k_scale[li, idx_b, idx_n, idx_o] = ks
        pools.v_scale[li, idx_b, idx_n, idx_o] = vs
        k_scale, v_scale = pools.k_scale[li], pools.v_scale[li]
    else:
        pools.k[li, idx_b, idx_n, idx_o] = k.to(pools.k.dtype)
        pools.v[li, idx_b, idx_n, idx_o] = v.to(pools.v.dtype)
    out = paged_decode_attention(
        q, pools.k[li], pools.v[li], tables, positions, k_scale=k_scale, v_scale=v_scale,
    )
    return _finish_layer(layer, x, out)


def paged_forward_step(
    model: GPTModel,
    tokens: torch.Tensor,
    pools: PagedPools,
    tables: torch.Tensor,
    positions: torch.Tensor,
    active: torch.Tensor,
    n_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [B] or [B, t] at per-row slots positions .. positions+t-1 ->
    logits [B, t, vocab] float32; the pools are written in place.

    ``tables`` [B, M] and ``positions`` [B] are int32 (on the card they
    feed the kernel as they are).  Inactive rows still run (fixed shape)
    but write to the null block, and their logits are garbage the caller
    ignores; a slot past a row's table gathers the last entry's clamp,
    as in the JAX function.

    ``n_valid`` [B] (chunked prefill) routes each row's chunk slots at or
    past its real token count to the null block: a padded tail chunk's
    pad positions can wrap onto REAL slots of the row's last block after
    the table-width clamp, so pad K/V must never land in a row's blocks.
    The null block then takes several writes of one step; no real query
    ever reads it."""
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    t = tokens.shape[1]
    cfg = model.config
    dev = tokens.device
    pos_t = positions.long()[:, None] + torch.arange(t, device=dev)[None, :]  # [B, t]
    pos_emb = torch.clamp(
        torch.where(active[:, None], pos_t, torch.zeros_like(pos_t)),
        0, cfg.max_position_embeddings - 1,
    )
    x = embed(model, tokens, pos_emb)
    bs = pools.k.shape[3]
    blk_log = torch.clamp(pos_t // bs, 0, tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, blk_log)
    blk = torch.where(active[:, None], blk, torch.zeros_like(blk))  # inactive -> null block
    if n_valid is not None:  # pad chunk slots -> null block
        pad = torch.arange(t, device=dev)[None, :] >= n_valid.long()[:, None]
        blk = torch.where(pad, torch.zeros_like(blk), blk)
    off = pos_t % bs
    for li, layer in enumerate(model.layers):
        x = _paged_layer_step(layer, x, pools, li, blk, off, tables, positions)
    x = layer_norm(x, model.final_ln.scale, model.final_ln.bias)
    return logits_from_hidden(model, x).float()


def paged_prefill(
    model: GPTModel,
    prompt: torch.Tensor,
    prompt_len: int,
    pools: PagedPools,
    table_row: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill ONE row's prompt into its pool blocks (prefill-on-admit).

    ``prompt`` [1, P] is RIGHT-padded to the bucket (real tokens at
    [0, prompt_len)): paged rows are unpadded in their logical cache.
    The prompt runs through the contiguous :func:`forward_cached` into a
    temporary cache in the model dtype (its K/V quantize once, on the
    repack, for an int8 arena), which is then repacked block-wise into
    the arena at ``table_row`` (PB block ids, PB * block >= P).  Pad
    slots' K/V land in the row's own blocks past ``prompt_len`` and are
    overwritten by decode steps before any attention bound reaches them.

    Returns (the last real token's logits [vocab] float32, the prompt's
    token counts [vocab] int32 for the repetition penalty)."""
    cfg = model.config
    P = int(prompt.shape[1])
    PB = len(table_row)
    bs = int(pools.k.shape[3])
    L = PB * bs
    if L < P:
        raise ValueError(f"table_row covers {PB}x{bs}={L} slots < prompt bucket {P}")
    dev = prompt.device
    layers, n, d = cfg.num_layers, cfg.num_attention_heads, cfg.head_dim
    cache = init_cache(cfg, 1, L, dev, kv_dtype="bf16")
    pos_ids = torch.arange(P, device=dev)[None, :]
    logits = forward_cached(model, prompt, cache, 0, position_ids=pos_ids)
    last = logits[0, prompt_len - 1].float()

    def pack(c):  # [layers, 1, n, L, d] -> [layers, PB, n, bs, d]
        return c[:, 0].reshape(layers, n, PB, bs, d).transpose(1, 2)

    idx = torch.tensor(list(table_row), dtype=torch.long, device=dev)
    if pools.k_scale is not None:
        kq, ksl = quantize_kv(pack(cache.k))
        vq, vsl = quantize_kv(pack(cache.v))
        pools.k[:, idx] = kq
        pools.v[:, idx] = vq
        pools.k_scale[:, idx] = ksl
        pools.v_scale[:, idx] = vsl
    else:
        pools.k[:, idx] = pack(cache.k).to(pools.k.dtype)
        pools.v[:, idx] = pack(cache.v).to(pools.v.dtype)
    counts = torch.zeros((cfg.vocab_size,), dtype=torch.int32, device=dev)
    counts.index_add_(0, prompt[0], (torch.arange(P, device=dev) < prompt_len).to(torch.int32))
    return last, counts


def paged_chunk_prefill(
    model: GPTModel,
    tokens: torch.Tensor,
    pools: PagedPools,
    table: torch.Tensor,
    position: torch.Tensor,
    n_valid: torch.Tensor,
    last_idx: int,
) -> torch.Tensor:
    """Prefill ONE row's next chunk of prompt tokens straight into the
    arena: ``tokens`` [1, t] land at slots position .. position+t-1 of
    the row's blocks ``table`` [1, M] (int32; ``position`` and
    ``n_valid`` int32 [1]), attending over everything already in them,
    so a cached prefix (shared blocks) and the earlier chunks are simply
    THERE and only the unmatched suffix runs through the model.  The
    multi-token path of :func:`paged_forward_step` (the verify chunk's):
    the paged attention kernel at t = chunk width.  Slots at or past
    ``n_valid`` are pads and write to the null block.  Returns the
    logits of chunk slot ``last_idx`` [vocab] float32 (the last REAL
    prompt token's on the final chunk)."""
    logits = paged_forward_step(
        model, tokens, pools, table, position,
        torch.ones((1,), dtype=torch.bool, device=tokens.device), n_valid=n_valid,
    )
    return logits[0, last_idx]


def prefix_token_counts(prompt_ids, vocab_size: int) -> np.ndarray:
    """Host-side repetition-penalty seed counts of a prompt: the integer
    bincount :func:`paged_prefill` computes on the device, for admissions
    that skip the monolithic prefill (prefix hits, chunked prompts)."""
    return np.bincount(
        np.asarray(list(prompt_ids), np.int64), minlength=int(vocab_size)
    ).astype(np.int32)


_POOL_NAMES = ("k", "v", "k_scale", "v_scale")


def gather_kv_blocks(pools: PagedPools, table) -> Dict[str, torch.Tensor]:
    """Copy arena blocks ``table`` to host: ``{"k", "v"[, "k_scale",
    "v_scale"]}`` CPU tensors, k/v [layers, len(table), heads, block,
    dim] in the ARENA dtype (int8 blocks with their scale planes, so a
    readmit restores the quantized values bit-exactly).  Each copy waits
    on the current stream only, never on the whole device."""
    idx = torch.as_tensor(list(table), dtype=torch.long, device=pools.k.device)
    return {name: getattr(pools, name)[:, idx].cpu()
            for name in _POOL_NAMES if getattr(pools, name) is not None}


def scatter_kv_blocks(pools: PagedPools, table, blocks) -> None:
    """Write host blocks (from :func:`gather_kv_blocks`) into the arena at
    ``table``, in place.  Refuses a set of arrays, a dtype or a per-block
    shape the arena does not have, loudly: scattering mistyped bytes would
    corrupt a live arena."""
    want = {n for n in _POOL_NAMES if getattr(pools, n) is not None}
    if set(blocks) != want:
        raise ValueError(f"block arrays {sorted(blocks)} != arena arrays {sorted(want)}")
    checked = {}
    for name in sorted(want):
        pool, arr = getattr(pools, name), blocks[name]
        if not isinstance(arr, torch.Tensor) or arr.dtype != pool.dtype:
            raise ValueError(f"block {name} dtype {getattr(arr, 'dtype', type(arr))} != "
                             f"arena {pool.dtype}")
        if tuple(arr.shape) != (pool.shape[0], len(table)) + tuple(pool.shape[2:]):
            raise ValueError(f"block {name} shape {tuple(arr.shape)} does not cover "
                             f"{len(table)} blocks of arena {tuple(pool.shape)}")
        checked[name] = arr
    idx = torch.as_tensor(list(table), dtype=torch.long, device=pools.k.device)
    for name, arr in checked.items():
        getattr(pools, name)[:, idx] = arr.to(pools.k.device)


def process_step_logits(logits, steps, counts, forced_steps, gen: GenerationConfig):
    """THE per-step logits-processor chain (min-length -> repetition
    penalty -> forced BOS/EOS), at any shape: ``logits`` [..., vocab]
    with ``steps`` / ``forced_steps`` broadcasting over the leading dims
    (per row on the paged step, per slot on the speculative verify
    chunk).  The same processors as :func:`generate`.  One function on
    purpose: :func:`decode_step`, :func:`decode_step_spec`, the
    speculative prefill seed and ``ops/speculative.speculative_verify``
    must stay bitwise equal, or greedy speculation drifts from the plain
    loops.  ``counts`` None skips the repetition penalty (callers pass
    None only when it is 1.0)."""
    vocab = logits.shape[-1]
    cols = torch.arange(vocab, device=logits.device)
    if gen.min_dec_len > 0:
        eos = (steps < gen.min_dec_len)[..., None] & (cols == gen.eos_token_id)
        logits = torch.where(eos, torch.full_like(logits, -1e10), logits)
    if counts is not None:
        logits = apply_repetition_penalty(logits, counts, gen.repetition_penalty)
    for token_id, at in ((gen.forced_bos_token_id, 0), (gen.forced_eos_token_id, forced_steps)):
        if token_id >= 0:
            forced = torch.where(cols == token_id, 0.0, -1e10).to(logits.dtype)
            logits = torch.where((steps == at)[..., None], forced, logits)
    return logits


def decode_step(
    model: GPTModel,
    pools: PagedPools,
    tables: torch.Tensor,
    rows: PagedRows,
    gen: GenerationConfig,
    generator: Optional[torch.Generator] = None,
    inplace: bool = False,
) -> Tuple[torch.Tensor, PagedRows]:
    """ONE iteration-level decode step over the running batch.

    Samples each active row's next token from its pending logits through
    :func:`process_step_logits`, writes the token's K/V at the row's
    current slot and returns (sampled tokens [B], the rows' next state,
    whose ``logits`` are the refreshed pending logits).  Greedy rows are
    token-identical to the contiguous path.  ``rows.counts`` is updated
    in place.

    ``inplace``: the next state goes into ``rows``' own tensors (logits,
    positions, gen_steps, active) and ``rows`` is returned, so a caller
    that keeps those tensors (the continuous engine's static buffers, which
    a CUDA graph captures) reads every step from the same memory.  The
    values are the functional form's, bit for bit."""
    B = rows.logits.shape[0]
    i = rows.gen_steps
    logits = process_step_logits(rows.logits, i, rows.counts, rows.forced_steps, gen)
    if gen.decode_strategy == "greedy_search":
        nxt = torch.argmax(logits, dim=-1)
    else:
        nxt = sample_logits(
            logits, temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
            generator=generator,
        )
    nxt = torch.where(rows.active, nxt, torch.full_like(nxt, gen.pad_token_id))
    act = rows.active.to(torch.int32)
    rows.counts[torch.arange(B, device=nxt.device), nxt] += act
    finished = rows.active & ((nxt == gen.eos_token_id) | (i + 1 >= rows.max_news))
    new_logits = paged_forward_step(model, nxt, pools, tables, rows.positions, rows.active)
    if inplace:
        rows.logits.copy_(new_logits[:, 0])
        rows.positions += act
        rows.gen_steps += act
        rows.active &= ~finished
        return nxt, rows
    return nxt, PagedRows(
        logits=new_logits[:, 0],
        counts=rows.counts,
        positions=rows.positions + act,
        gen_steps=i + act,
        max_news=rows.max_news,
        active=rows.active & ~finished,
        forced_steps=rows.forced_steps,
    )


def decode_step_spec(
    model: GPTModel,
    pools: PagedPools,
    tables: torch.Tensor,
    rows: PagedRows,
    drafts: torch.Tensor,
    gen: GenerationConfig,
    generator: Optional[torch.Generator] = None,
    inplace: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, PagedRows]:
    """ONE speculative iteration over the running batch: the paged
    spelling of :func:`_generate_speculative`'s body with a TRUE per-row
    commit (each row owns its positions, so accepted lengths never hold
    each other back).  ``drafts`` [B, k] are the host's proposals.

    Per row: sample the pending token t0 from ``rows.logits`` through
    :func:`decode_step`'s processor chain (greedy rows are bitwise the
    plain step), forward the [t0, draft_0 .. draft_k-1] chunk in ONE
    t = k + 1 forward (K/V written at positions .. positions + k), verify
    the drafts with ``speculative_verify`` and commit t0 and the accepted
    prefix, cut by the row's budget.  The rejected tail's K/V stays in
    the pools past the row's new position and is written again by the
    next chunk before any query's causal bound reaches it: positions
    advance by the committed count only (the per-row rewind).  Block
    tables are untouched: rows reserved their budget plus ``draft_k``
    slack slots at admission.

    Returns (window [B, k+1] committed tokens, pad past each row's count;
    ncommit [B] in [0, k+1], 0 only for inactive rows; the rows' next
    state, whose ``logits`` are the raw target logits at each row's last
    committed position and ``reject`` the residual mask of the next
    sample).  ``rows.counts`` is updated in place, and with ``inplace``
    the rest of the next state too, as in :func:`decode_step` (``reject``
    into ``rows.reject``)."""
    B, vocab = rows.logits.shape
    dev = rows.logits.device
    k = int(drafts.shape[1])
    K = k + 1
    i = rows.gen_steps.long()
    pad = gen.pad_token_id
    use_counts = gen.repetition_penalty != 1.0
    logits = process_step_logits(rows.logits, i, rows.counts, rows.forced_steps, gen)
    if gen.decode_strategy == "greedy_search":
        t0 = torch.argmax(logits, dim=-1)
    else:
        filt = filtered_logits(logits, temperature=gen.temperature, top_k=gen.top_k,
                               top_p=gen.top_p)
        if rows.reject is not None:
            # the residual rule across the step boundary: mask the draft the
            # last verify rejected at THIS position, after the filters, so
            # the renormalized nucleus is the exact residual
            cols = torch.arange(vocab, device=dev)[None, :]
            hit = (rows.reject >= 0)[:, None] & (cols == rows.reject.long()[:, None])
            filt = torch.where(hit, torch.full_like(filt, -1e10), filt)
        t0 = sample_logits(filt, generator=generator)
    nxt0 = torch.where(rows.active, t0, torch.full_like(t0, pad))
    chunk = torch.cat([nxt0[:, None], drafts.long()], dim=1)

    logits_all = paged_forward_step(model, chunk, pools, tables, rows.positions, rows.active)
    sv = speculative_verify(
        logits_all, chunk, rows.counts if use_counts else None, rows.active, i, gen,
        forced_steps=rows.forced_steps, generator=generator,
    )

    # per-row commit: the accepted prefix cut by the decode budget
    slots = torch.arange(K, device=dev)[None, :]
    valid = sv.real & ((i[:, None] + slots) < rows.max_news[:, None])
    ncommit = valid.sum(dim=1)
    window = torch.where(valid, sv.w, torch.full_like(sv.w, pad))
    rows.counts.scatter_add_(1, window, (slots < ncommit[:, None]).to(torch.int32))
    eos_fin = (sv.eos_hit & valid).any(dim=1)
    finished = rows.active & (eos_fin | ((i + ncommit) >= rows.max_news))

    # the raw logits at each row's last committed position
    sel = torch.clamp(ncommit - 1, 0, k)
    new_logits = logits_all[torch.arange(B, device=dev), sel]
    new_logits = torch.where(rows.active[:, None], new_logits, rows.logits)

    # residual mask: a rejected draft at exactly the carried slot
    a = sv.accepted
    a_cl = torch.clamp(a, 0, k - 1)[:, None]
    ok_at_a = torch.gather(sv.ok, 1, a_cl)[:, 0]
    real_at_a = torch.gather(sv.real, 1, a[:, None])[:, 0]
    mism = (a < k) & real_at_a & ~ok_at_a
    rej_draft = torch.gather(drafts.long(), 1, a_cl)[:, 0]
    active_after = rows.active & ~finished
    reject = torch.where(mism & (ncommit == a + 1) & active_after, rej_draft,
                         torch.full_like(rej_draft, -1)).to(torch.int32)
    ncommit32 = ncommit.to(rows.positions.dtype)
    if inplace:
        rows.logits.copy_(new_logits)
        rows.positions += ncommit32
        rows.gen_steps += ncommit32
        rows.active.copy_(active_after)
        rows.reject.copy_(reject)
        return window, ncommit, rows
    return window, ncommit, PagedRows(
        logits=new_logits,
        counts=rows.counts,
        positions=rows.positions + ncommit32,
        gen_steps=rows.gen_steps + ncommit32,
        max_news=rows.max_news,
        active=active_after,
        forced_steps=rows.forced_steps,
        reject=reject,
    )
