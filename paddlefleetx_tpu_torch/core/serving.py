"""Generation serving: a resident model and bucketed decode.

Counterpart of ``paddlefleetx_tpu/core/serving.py``.  Requests are padded
to power-of-two batch buckets and ``pad_to_multiple`` prompt buckets, and
the decode length to 32-token buckets (:func:`plan_decode`), as the JAX
server does to bound its compiled artifacts; here the buckets key a
small LRU pool of KV caches that are reused in place between requests of
the same shape instead of reallocated.  ``Generation.speculative.draft_k``
> 0 decodes through the speculative loop (``generate(..., spec=)``), with
``draft_k`` slack slots in every cache and the draft counts in ``stats``.
``stats`` is a ``StatsView``: its counters are the registry's
``pfx_serving_*`` / ``pfx_spec_*`` series, so ``/metrics`` and ``/healthz``
read one snapshot.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch

from paddlefleetx_tpu_torch.models.gpt.generation import (
    GenerationConfig,
    bucket_len,
    generate,
    init_cache,
    pad_prompts,
)
from paddlefleetx_tpu_torch.ops.decode_attention import kv_cache_dtype
from paddlefleetx_tpu_torch.ops.speculative import spec_config_from
from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.telemetry import StatsView, get_registry


def plan_decode(padded_len: int, max_toks: int, *, context: int):
    """THE decode-length clamp for an explicit client ``max_tokens``:
    (trim, run) where ``trim`` is the request's output cap (context room
    respected, floored at 1) and ``run`` the 32-bucketed decode length.
    Raises ValueError when the padded prompt leaves no decode room."""
    limit = int(context) - int(padded_len)
    if limit < 1:
        raise ValueError(
            f"prompt bucket {padded_len} leaves no decode room in context {context}"
        )
    trim = max(1, min(int(max_toks), limit))
    run = min(-(-trim // 32) * 32, limit)
    return trim, run


class GenerationServer:
    """Holds the model on its device and serves token-id prompts.

    Only the scheduler thread calls :meth:`generate_ids` once traffic
    starts (it mutates the cache pool, the generator and ``stats``)."""

    def __init__(self, cfg, module, model, device: torch.device):
        gen_cfg = cfg.get("Generation", {}) or {}
        if gen_cfg.get("tokenizer_dir"):
            raise NotImplementedError(
                "Generation.tokenizer_dir: tokenizer loading is not ported yet; "
                "send prompt_ids / prompts_ids"
            )
        self.cfg = cfg
        self.module = module
        self.model = model
        self.device = device
        self.bucket = int(gen_cfg.get("pad_to_multiple", 64))
        self.gen = GenerationConfig(
            max_dec_len=int(gen_cfg.get("max_dec_len", 64)),
            min_dec_len=int(gen_cfg.get("min_dec_len", 1)),
            decode_strategy=gen_cfg.get("decode_strategy", "sampling"),
            temperature=float(gen_cfg.get("temperature", 1.0)),
            top_k=int(gen_cfg.get("top_k", 0)),
            top_p=float(gen_cfg.get("top_p", 1.0)),
            repetition_penalty=float(gen_cfg.get("repetition_penalty", 1.0)),
            eos_token_id=int(gen_cfg.get("eos_token_id", 50256)),
            pad_token_id=int(gen_cfg.get("pad_token_id", 0)),
            forced_bos_token_id=int(gen_cfg.get("forced_bos_token_id", -1)),
            forced_eos_token_id=int(gen_cfg.get("forced_eos_token_id", -1)),
        )
        # Generation.speculative: {draft_k, drafter, ngram, kv_dtype}; the one
        # parse site, read by both schedulers (the paged engine inherits it)
        spec_section = dict(gen_cfg.get("speculative", {}) or {})
        self.spec = spec_config_from(spec_section)
        self.kv_dtype = kv_cache_dtype(str(spec_section.get("kv_dtype", "") or ""))
        seed = int(cfg.get("Global", {}).get("seed", 0))
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._cache_pool: "OrderedDict" = OrderedDict()
        self._cache_pool_size = int(gen_cfg.get("cache_pool_size", 4))
        # the numeric keys are exported onto the registry under the JAX
        # server's names; last_error, warmup_s and the accept rate stay
        # instance-local
        self.stats = StatsView(
            {
                "requests": "pfx_serving_requests_total",
                "tokens_out": "pfx_serving_tokens_out_total",
                "time_s": "pfx_serving_gen_seconds_total",
                "gen_errors": "pfx_serving_gen_errors_total",
                "last_latency_s": "pfx_serving_last_latency_seconds",
                "spec_proposed": "pfx_spec_proposed_total",
                "spec_accepted": "pfx_spec_accepted_total",
            },
            init={"time_s": 0.0, "last_latency_s": 0.0, "last_error": "",
                  "spec_accept_rate": 0.0},
        )

    @property
    def context(self) -> int:
        return int(self.module.config.max_position_embeddings)

    def generate_ids(
        self, prompts: Sequence[Sequence[int]], max_dec_len: Optional[int] = None
    ) -> List[List[int]]:
        """Continuations (cut at EOS) for a batch of token-id prompts."""
        if not prompts or any(len(p) == 0 for p in prompts):
            raise ValueError("prompts must be a non-empty list of non-empty id lists")
        gen = self.gen
        n_req = len(prompts)
        target = 1
        while target < n_req:
            target *= 2
        batch = list(prompts) + [prompts[-1]] * (target - n_req)
        ids, lens = pad_prompts(batch, gen.pad_token_id, self.bucket, self.device)
        P = ids.shape[1]
        if self.context - P < 1:
            raise ValueError(
                f"prompt bucket {P} leaves no decode room in context {self.context}"
            )
        if max_dec_len is None:
            trim = run_len = min(gen.max_dec_len, self.context - P)
        else:
            trim, run_len = plan_decode(P, max_dec_len, context=self.context)
        if run_len != gen.max_dec_len:
            gen = dataclasses.replace(gen, max_dec_len=run_len)
        t0 = time.time()
        key = (gen, target, P)
        cache = self._cache_pool.pop(key, None)
        if cache is None:
            # speculation needs draft_k slack slots for the verify chunk's
            # rejected tail
            slack = self.spec.draft_k if self.spec is not None else 0
            cache = init_cache(
                self.module.config, target, P + run_len + slack, self.device,
                kv_dtype=self.kv_dtype,
            )
        spec_stats = None
        try:
            out = generate(
                self.model, ids, gen, generator=self.generator,
                prompt_lens=lens, cache=cache, spec=self.spec,
                return_spec_stats=self.spec is not None,
            )
            if self.spec is not None:
                out, spec_stats = out
            out = out[:n_req].cpu().tolist()
        except Exception as exc:
            # a failed decode leaves the cache half written: drop it
            self.stats["gen_errors"] += 1
            self.stats["last_error"] = f"{type(exc).__name__}: {exc}"
            raise
        self._cache_pool[key] = cache
        while len(self._cache_pool) > self._cache_pool_size:
            self._cache_pool.popitem(last=False)  # evict the least recently used
        dt = time.time() - t0
        outs: List[List[int]] = []
        for row in out:
            row = row[:trim]
            if gen.eos_token_id in row:
                row = row[: row.index(gen.eos_token_id)]
            outs.append(row)
        self.stats["requests"] += 1
        self.stats["tokens_out"] += sum(len(o) for o in outs)
        self.stats["time_s"] += dt
        self.stats["last_latency_s"] = round(dt, 4)
        if spec_stats is not None:
            self.stats["spec_proposed"] += int(spec_stats[0])
            self.stats["spec_accepted"] += int(spec_stats[1])
            self.stats["spec_accept_rate"] = (
                self.stats["spec_accepted"] / self.stats["spec_proposed"]
                if self.stats["spec_proposed"] else 0.0)
        return outs

    def warmup(
        self, prompt_lens: Sequence[int] = (8,), batch_sizes: Sequence[int] = (1,)
    ) -> Dict[str, float]:
        """Run one request per (prompt-length bucket, batch bucket) before
        traffic: builds the CUDA kernels and allocates the bucket's cache.
        Every bucket is validated first; a failing bucket raises naming
        what did and did not warm.  Records seconds in
        ``stats["warmup_s"]``."""
        lens = [int(n) for n in prompt_lens]
        batches = [int(b) for b in batch_sizes]
        if not lens or not batches:
            raise ValueError("warmup needs >= 1 prompt-length and batch bucket")
        for n in lens:
            padded = bucket_len(n, self.bucket)
            if n < 1 or padded >= self.context:
                raise ValueError(
                    f"warmup bucket {n} invalid: padded prompt {padded} leaves "
                    f"no decode room in context {self.context}"
                )
        if any(b < 1 for b in batches):
            raise ValueError(f"warmup batch sizes must be >= 1, got {batches}")
        per: Dict[str, float] = {}
        for n in lens:
            for b in batches:
                key = f"{n}" if b == 1 else f"{n}x{b}"
                t0 = time.time()
                try:
                    self.generate_ids([[1] * n] * b, max_dec_len=self.gen.max_dec_len)
                except Exception as exc:
                    raise RuntimeError(
                        f"warmup failed at bucket {key} (warmed so far: "
                        f"{sorted(per) or 'none'}): {type(exc).__name__}: {exc}"
                    ) from exc
                per[key] = round(time.time() - t0, 3)
                logger.info(
                    f"serving warmup: prompt bucket {n} batch {b} "
                    f"(pad multiple {self.bucket}) ran in {per[key]:.2f}s"
                )
        self.stats["warmup_s"] = dict(per)
        get_registry().counter("pfx_serving_warmup_seconds_total").inc(sum(per.values()))
        return per
