"""PyTorch port: speculative decoding against the JAX package on the CPU.

Covers ``paddlefleetx_tpu_torch/ops/speculative.py`` (the n-gram drafters,
the config parse, the accept rule), the multi-position form of
``ops/sampling.sample_logits``, the speculative loops of
``models/gpt/generation.py`` (``generate(..., spec=)``,
``decode_step_spec``), the engine's draft path
(``core/continuous_batching.py``) and ``--draft-k`` of the serve CLI.

The model is the TINY serving config of tests/test_kv_tier.py (vocab 96,
2 layers, hidden 32, 4 heads, float32, dropout off); weights come from the
JAX initializer, perturbed so biases and LayerNorms are not at their
ones/zeros, and cross to the port through the bridge.

Tolerances: drafters, config parses, greedy verify outputs, greedy tokens
and accept counts are exact.  Sampled verify: the filtered logits and the
accept probabilities p(d) within 1e-6 (float32, the same operations on
both sides); with the same accept uniforms the accept decisions are equal.
One paged step's carried logits within 2e-5 (float32, the two sides sum in
different orders).  Threefry and torch's generator never agree, so the
fresh and residual draws are held by distribution tests whose sample
counts and bounds are stated where they run.
"""

import copy
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from paddlefleetx_tpu.core import continuous_batching as jax_cb
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops import sampling as jax_sampling
from paddlefleetx_tpu.ops import speculative as jax_spec
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core import continuous_batching as pt_cb
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as pt_gen
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.ops import decode_attention as da
from paddlefleetx_tpu_torch.ops import sampling as pt_sampling
from paddlefleetx_tpu_torch.ops import speculative as pt_spec
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_kv_tier.py TINY, dropout off
TINY = {
    "Global": {"global_batch_size": 8, "seed": 7},
    "Engine": {"mix_precision": {"enable": False}, "save_load": {"save_steps": 0}},
    "Model": {
        "module": "GPTModule", "vocab_size": 96, "hidden_size": 32, "num_layers": 2,
        "num_attention_heads": 4, "max_position_embeddings": 128, "dtype": "float32",
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    },
    "Distributed": {},
    "Optimizer": {"name": "FusedAdamW", "lr": {"name": "Constant", "learning_rate": 1e-3}},
    "Generation": {"max_dec_len": 8, "decode_strategy": "greedy_search",
                   "pad_to_multiple": 8, "eos_token_id": 95, "pad_token_id": 0},
}
PORT_SECTIONS = ("Global", "Engine", "Model", "Generation")
PROMPTS = [[5, 17, 33, 2, 8], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50],
           [3, 9, 27], [70, 71, 72, 73, 74, 75, 76, 77, 78]]
MAX_NEW = 12
EOS = 95
# the processors the plain loops apply per step, all at once
PROCESSORS = dict(repetition_penalty=1.3, min_dec_len=3, forced_bos_token_id=5,
                  forced_eos_token_id=EOS)


def _tree():
    """The JAX initializer's parameters, perturbed (numpy leaves)."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k != "module"}
    jparams = jax_model.init(JaxGPTConfig(**model_kw), jax.random.key(0))
    rng = np.random.default_rng(3)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), jparams
    )


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port model) on the same weights."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k != "module"}
    tree = _tree()
    cfg = {k: v for k, v in model_kw.items() if "dropout" not in k}
    return (JaxGPTConfig(**model_kw), jax.tree.map(jnp.asarray, tree),
            params_from_jax(GPTConfig(**cfg), tree))


def _pair(generation):
    """(JAX GenerationServer, port GenerationServer) on the same weights,
    with ``generation`` over TINY's Generation section."""
    tiny = copy.deepcopy(TINY)
    tiny["Generation"].update(generation)
    tree = _tree()
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(tiny)),
                              num_devices=jax.device_count())
    jserver = JaxServer(cfg, init_dist_env(cfg), build_module(cfg),
                        params=jax.tree.map(jnp.asarray, tree))
    pcfg = process_configs(AttrDict.from_nested(
        {k: v for k, v in tiny.items() if k in PORT_SECTIONS}))
    module = GPTModule(pcfg)
    return jserver, GenerationServer(pcfg, module, params_from_jax(module.config, tree),
                                     torch.device("cpu"))


@pytest.fixture(scope="module")
def servers():
    return _pair({})


@pytest.fixture(scope="module")
def sequential(servers):
    """Each prompt served alone on the port's plain coalescing path."""
    return [servers[1].generate_ids([p], max_dec_len=MAX_NEW)[0] for p in PROMPTS]


def _pt_gen(gen):
    return pt_gen.GenerationConfig(**{
        f.name: getattr(gen, f.name) for f in dataclasses.fields(pt_gen.GenerationConfig)
    })


# ---------------------------------------------------------------------------
# drafters and the config parse
# ---------------------------------------------------------------------------


def _seqs():
    rng = np.random.default_rng(21)
    cycle = rng.integers(1, 20, size=5).tolist()
    return {
        "repeats": [1, 2, 3, 4, 1, 2, 3],
        "short_continuation": [7, 8, 7, 8],
        "miss": [5, 6, 7],
        "empty": [],
        "one": [9],
        "cycle": (cycle * 6)[:-2],
        "random_small_vocab": rng.integers(0, 4, size=60).tolist(),
        "random_no_repeat": rng.permutation(90).tolist(),
    }


@pytest.mark.parametrize("name", sorted(_seqs()))
def test_ngram_propose_host_matches_jax(name):
    seq = _seqs()[name]
    for k in (1, 3, 5):
        for n in (1, 2, 3):
            for window in (jax_spec.NGRAM_WINDOW, 4):  # 4: the scan cap bites
                want = jax_spec.ngram_propose_host(seq, k, n=n, window=window)
                assert pt_spec.ngram_propose_host(seq, k, n=n, window=window) == want
    assert pt_spec.NGRAM_WINDOW == jax_spec.NGRAM_WINDOW
    with pytest.raises(ValueError, match="k >= 1"):
        pt_spec.ngram_propose_host(seq, 0)


@pytest.mark.parametrize("known", [0, 1, 2, 6, 17, 30])
def test_ngram_propose_matches_jax(known):
    """The tensor drafter on seeded rows: repeats, a constant row, misses,
    continuations past the known region, every needle length."""
    rng = np.random.default_rng(known)
    L = 32
    ctx = rng.integers(0, 6, size=(5, L)).astype(np.int32)
    ctx[1] = 9
    ctx[2, :8] = [1, 2, 3, 4, 1, 2, 3, 4]
    ctx[:, known:] = 0  # unknown slots hold pads, as in the loop's buffer
    pending = np.array([3, 9, 1, 42, 2], np.int32)
    for k in (1, 2, 4):
        for n in (1, 2, 3):
            want = np.asarray(jax_spec.ngram_propose(jnp.asarray(ctx), jnp.int32(known),
                                                     jnp.asarray(pending), k, n=n))
            got = pt_spec.ngram_propose(torch.from_numpy(ctx).long(), known,
                                        torch.from_numpy(pending).long(), k, n=n)
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="k >= 1"):
        pt_spec.ngram_propose(torch.zeros((1, 4), dtype=torch.long), 2,
                              torch.zeros((1,), dtype=torch.long), 0)


@pytest.mark.parametrize("section", [
    None, {}, {"draft_k": 0}, {"draft_k": 3}, {"draft_k": 3, "ngram": 1},
    {"draft_k": 2, "drafter": "ngram", "kv_dtype": "int8"}, {"draft_k": -1},
    {"draft_k": 2, "drafter": "medusa"}, {"draft_k": 2, "ngram": 0},
])
def test_spec_config_parse_matches_jax(section):
    try:
        want = jax_spec.spec_config_from(section)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pt_spec.spec_config_from(section)
        assert str(err.value) == str(e)
        return
    got = pt_spec.spec_config_from(section)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# sample_logits' multi-position form
# ---------------------------------------------------------------------------


def test_sample_logits_multi_position_form():
    """[b, K, v] -> [b, K], one draw per position in position order from the
    generator; the [b, v] form is unchanged (the same draws as before)."""
    one_hot = torch.full((4, 2, 32), -1e9)
    one_hot[torch.arange(4), 0, torch.tensor([1, 2, 3, 4])] = 0.0
    one_hot[torch.arange(4), 1, torch.tensor([5, 6, 7, 8])] = 0.0
    for kw in ({}, {"top_k": 4}, {"top_p": 0.9}, {"temperature": 0.5}):
        got = pt_sampling.sample_logits(one_hot, generator=torch.Generator().manual_seed(0),
                                        **kw)
        assert got.shape == (4, 2)
        assert got[:, 0].tolist() == [1, 2, 3, 4] and got[:, 1].tolist() == [5, 6, 7, 8], kw
    soft = torch.randn(4, 3, 32, generator=torch.Generator().manual_seed(1))
    multi = pt_sampling.sample_logits(soft, top_p=0.9, generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(2)
    per = [pt_sampling.sample_logits(soft[:, j], top_p=0.9, generator=g) for j in range(3)]
    assert torch.equal(multi, torch.stack(per, dim=1))
    # the [b, v] form: a bare categorical is torch.multinomial of the softmax
    flat = soft[:, 0]
    got = pt_sampling.sample_logits(flat, generator=torch.Generator().manual_seed(3))
    want = torch.multinomial(torch.softmax(flat, -1), 1,
                             generator=torch.Generator().manual_seed(3))[:, 0]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the accept rule: speculative_verify
# ---------------------------------------------------------------------------

VERIFY_CASES = {
    "plain": {},
    "repetition_penalty": dict(repetition_penalty=1.3),
    "min_dec_len": dict(min_dec_len=4),
    "forced_bos_eos": dict(forced_bos_token_id=5, forced_eos_token_id=EOS),
    "all_processors": PROCESSORS,
}


def _verify_inputs(case, b=6, k=4, vocab=96, seed=0):
    """Seeded target logits, base counts and steps, and chunks whose drafts
    follow the target's own (JAX-processed) argmax up to a row-specific
    cut, with an EOS placed inside two rows' accepted prefixes."""
    rng = np.random.default_rng(seed)
    K = k + 1
    gen = jax_gen.GenerationConfig(max_dec_len=12, decode_strategy="greedy_search",
                                   eos_token_id=EOS, pad_token_id=0, **VERIFY_CASES[case])
    logits = (rng.normal(size=(b, K, vocab)) * 3).astype(np.float32)
    logits[2, 1, EOS] = 50.0  # EOS is the target's token at slot 1 of row 2
    logits[4, 0, EOS] = 50.0
    counts = rng.integers(0, 2, size=(b, vocab)).astype(np.int32)
    steps0 = np.array([0, 1, 2, 3, 5, 9], np.int32)[:b]
    alive = np.array([True, True, True, False, True, True])[:b]
    forced = np.full((b,), 9, np.int32)
    chunk = rng.integers(1, 90, size=(b, K)).astype(np.int32)
    use_counts = gen.repetition_penalty != 1.0
    for _ in range(K):  # the greedy chain settles in k + 1 rounds
        sv = jax_spec.speculative_verify(
            None, jnp.asarray(logits), jnp.asarray(chunk),
            jnp.asarray(counts) if use_counts else None, jnp.asarray(alive),
            jnp.asarray(steps0), gen, forced_steps=jnp.asarray(forced))
        chunk[:, 1:] = np.asarray(sv.pend)[:, :k]
    cuts = [k, 2, 3, 1, 1, 0][:b]  # rows 2 and 4 keep their EOS in the prefix
    for r, c in enumerate(cuts):
        if c < k:
            chunk[r, c + 1] = (chunk[r, c + 1] + 1) % 90 + 1  # a mismatch past the cut
    return gen, logits, chunk, counts, alive, steps0, forced


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_greedy_verify_matches_jax(case):
    gen, logits, chunk, counts, alive, steps0, forced = _verify_inputs(case)
    use_counts = gen.repetition_penalty != 1.0
    want = jax_spec.speculative_verify(
        None, jnp.asarray(logits), jnp.asarray(chunk),
        jnp.asarray(counts) if use_counts else None, jnp.asarray(alive),
        jnp.asarray(steps0), gen, forced_steps=jnp.asarray(forced))
    base = torch.from_numpy(counts)
    got = pt_spec.speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(chunk),
        base if use_counts else None, torch.from_numpy(alive),
        torch.from_numpy(steps0), _pt_gen(gen), forced_steps=torch.from_numpy(forced))
    for field in pt_spec.SpecVerify._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert torch.equal(base, torch.from_numpy(counts))  # base counts untouched
    assert 0 < int(got.accepted.sum()) < chunk.shape[0] * (chunk.shape[1] - 1)
    assert bool(got.eos_hit.any())


def _jax_accept_uniforms(key, b, k, sequential):
    """The accept uniforms the JAX rule draws from ``key``."""
    if not sequential:
        k_acc = jax.random.split(key, 3)[0]
        return np.array(jax.random.uniform(k_acc, (b, k)))
    slot_keys = jax.random.split(key, k + 1)
    return np.stack([np.asarray(jax.random.uniform(jax.random.split(slot_keys[j], 3)[0], (b,)))
                     for j in range(k)], axis=1)


@pytest.mark.parametrize("case", ["plain", "all_processors"])
def test_sampled_verify_matches_jax(case):
    """Sampled rule, vectorized (no penalty) and sequential (penalty): the
    filtered target logits and p(d) within 1e-6 of JAX's; fed JAX's own
    accept uniforms, the accept decisions and the committed chain are
    equal."""
    gen, logits, chunk, counts, alive, steps0, forced = _verify_inputs(case, seed=1)
    gen = dataclasses.replace(gen, decode_strategy="sampling", temperature=0.8, top_k=40,
                              top_p=0.9)
    sequential = gen.repetition_penalty != 1.0
    b, K, _ = logits.shape
    k = K - 1
    key = jax.random.key(11)
    want = jax_spec.speculative_verify(
        key, jnp.asarray(logits), jnp.asarray(chunk),
        jnp.asarray(counts) if sequential else None, jnp.asarray(alive),
        jnp.asarray(steps0), gen, forced_steps=jnp.asarray(forced))
    u = _jax_accept_uniforms(key, b, k, sequential)
    pgen = _pt_gen(gen)
    got = pt_spec.speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(chunk),
        torch.from_numpy(counts) if sequential else None, torch.from_numpy(alive),
        torch.from_numpy(steps0), pgen, forced_steps=torch.from_numpy(forced),
        generator=torch.Generator().manual_seed(0), u_accept=torch.from_numpy(u))
    for field in ("ok", "real", "accepted", "eos_hit", "w"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    # the target distribution of each draft slot, on the chain's counts
    jc, pc = jnp.asarray(counts), torch.from_numpy(counts.copy())
    real = np.asarray(want.real)
    for j in range(k):
        w_j = np.where(real[:, j], chunk[:, j], gen.pad_token_id)
        steps = steps0 + 1 + j
        if sequential:
            jc = jc.at[jnp.arange(b), jnp.asarray(w_j)].add(1)
            pc[torch.arange(b), torch.from_numpy(w_j).long()] += 1
        jproc = jax_gen.process_step_logits(jnp.asarray(logits[:, j]), jnp.asarray(steps),
                                            jc if sequential else None,
                                            jnp.asarray(forced), gen)
        jfilt = jax_sampling.filtered_logits(jproc, temperature=gen.temperature,
                                             top_k=gen.top_k, top_p=gen.top_p)
        jp = np.take_along_axis(np.asarray(jax.nn.softmax(jfilt, axis=-1)),
                                chunk[:, j + 1, None], axis=-1)[:, 0]
        pproc = pt_gen.process_step_logits(torch.from_numpy(logits[:, j]),
                                           torch.from_numpy(steps),
                                           pc if sequential else None,
                                           torch.from_numpy(forced), pgen)
        pfilt, pp = pt_spec.accept_probs(pproc, torch.from_numpy(chunk[:, j + 1]).long(), pgen)
        finite = np.asarray(jfilt) > -1e9
        np.testing.assert_array_equal(pfilt.numpy() > -1e9, finite)
        np.testing.assert_allclose(pfilt.numpy()[finite], np.asarray(jfilt)[finite],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(pp.numpy(), jp, atol=1e-6, rtol=0)
    pend = got.pend.numpy()
    assert pend.shape == (b, K) and pend.min() >= 0 and pend.max() < logits.shape[-1]


def test_sampled_verify_keeps_the_target_distribution():
    """The residual rule on one chunk, 20000 rows with the same logits and
    drafts (vocab 8, k = 2, temperature 0.9, top-p 0.8): the token after
    the pending one (the accepted draft, or the residual draw) follows the
    filtered target at slot 0, and, among rows that accepted it, the next
    one the target at slot 1.  Bound: total variation <= 0.02, about 3x
    the expected distance of 20000 draws from 8 categories (~0.007)."""
    V, N, k = 8, 20000, 2
    rng = np.random.default_rng(5)
    logits = torch.from_numpy((rng.normal(size=(1, k + 1, V)) * 1.5).astype(np.float32))
    gen = pt_gen.GenerationConfig(max_dec_len=8, min_dec_len=0, decode_strategy="sampling",
                                  temperature=0.9, top_p=0.8, eos_token_id=V + 1)
    target = torch.softmax(pt_sampling.filtered_logits(logits[0] / 1.0, temperature=0.9,
                                                       top_p=0.8), -1).numpy()
    drafts = [int(np.argsort(target[0])[-2]), int(np.argmax(target[1]))]  # a likely pair
    chunk = torch.tensor([[3] + drafts] * N)
    sv = pt_spec.speculative_verify(
        logits.expand(N, -1, -1), chunk, None, torch.ones(N, dtype=torch.bool), 2, gen,
        generator=torch.Generator().manual_seed(6))
    first = torch.where(sv.ok[:, 0], chunk[:, 1], sv.pend[:, 0]).numpy()
    tv0 = 0.5 * np.abs(np.bincount(first, minlength=V) / N - target[0]).sum()
    acc = sv.ok[:, 0].numpy()
    second = torch.where(sv.ok[:, 1], chunk[:, 2], sv.pend[:, 1]).numpy()[acc]
    tv1 = 0.5 * np.abs(np.bincount(second, minlength=V) / len(second) - target[1]).sum()
    assert 0.1 < acc.mean() < 0.9  # both the accept and the residual branch ran
    assert tv0 <= 0.02 and tv1 <= 0.02 + 0.02 * (1 - acc.mean()), (tv0, tv1)


# ---------------------------------------------------------------------------
# the contiguous loop: generate(..., spec=)
# ---------------------------------------------------------------------------

CONTIGUOUS_CASES = {
    "random_unpadded": dict(k=4),
    "repetitive_unpadded": dict(k=4, prompts="repetitive"),
    "left_padded": dict(k=3, padded=True),
    "eos_in_chunk": dict(k=4, padded=True, eos="emitted"),
    "forced_eos": dict(k=4, gen=dict(forced_eos_token_id=EOS)),
    "processors": dict(k=3, padded=True, gen=PROCESSORS),
    "int8_kv": dict(k=3, padded=True, kv="int8"),
    "draft_k_16": dict(k=16, padded=True),
}


def _contiguous_prompts(case):
    if case.get("padded"):
        return jax_gen.pad_prompts(PROMPTS, 0, multiple=8)
    if case.get("prompts") == "repetitive":
        return jnp.asarray(np.tile([11, 23, 7, 41], (3, 2)), jnp.int32), None
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.integers(1, 90, size=(3, 8)), jnp.int32), None


def _generate_both(models, gen, ids, lens, k, kv="bf16"):
    """(port plain, port spec, JAX spec, port stats, JAX stats)."""
    jcfg, jparams, model = models
    b, P = ids.shape
    jcache = jax_gen.init_cache(jcfg, b, P + gen.max_dec_len + k, kv_dtype=kv)
    want, (jprop, jacc) = jax_gen.generate(
        jparams, ids, jcfg, gen, key=jax.random.key(1), prompt_lens=lens, cache=jcache,
        spec=jax_spec.SpecConfig(draft_k=k), return_spec_stats=True)
    pgen = _pt_gen(gen)
    t_ids = torch.from_numpy(np.array(ids)).long()
    t_lens = None if lens is None else torch.from_numpy(np.array(lens))
    cpu = torch.device("cpu")
    plain = pt_gen.generate(model, t_ids, pgen, prompt_lens=t_lens,
                            cache=pt_gen.init_cache(model.config, b, P + gen.max_dec_len, cpu,
                                                    kv_dtype=kv))
    cache = pt_gen.init_cache(model.config, b, P + gen.max_dec_len + k, cpu, kv_dtype=kv)
    got, stats = pt_gen.generate(model, t_ids, pgen, prompt_lens=t_lens, cache=cache,
                                 spec=pt_spec.SpecConfig(draft_k=k), return_spec_stats=True)
    return plain.numpy(), got.numpy(), np.asarray(want), stats, (int(jprop), int(jacc))


@pytest.mark.parametrize("name", sorted(CONTIGUOUS_CASES))
def test_contiguous_greedy_spec_matches_plain_and_jax(models, name):
    case = CONTIGUOUS_CASES[name]
    gen = jax_gen.GenerationConfig(max_dec_len=MAX_NEW, decode_strategy="greedy_search",
                                   eos_token_id=EOS, pad_token_id=0, **case.get("gen", {}))
    ids, lens = _contiguous_prompts(case)
    if case.get("eos") == "emitted":
        # EOS := the token row 1 emits at step 1 (after min_dec_len), so the
        # row finishes inside a verified chunk
        plain, *_ = _generate_both(models, gen, ids, lens, case["k"])
        gen = dataclasses.replace(gen, eos_token_id=int(plain[1, 1]))
    plain, got, want, stats, jstats = _generate_both(models, gen, ids, lens, case["k"],
                                                     case.get("kv", "bf16"))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert stats == jstats and stats[0] > 0 and 0 <= stats[1] <= stats[0]
    if case.get("eos") == "emitted":
        assert (got == gen.eos_token_id).any() and (got[:, -1] == 0).any()
    if name == "repetitive_unpadded":
        assert stats[1] > 0  # multi-token commits ran


def test_contiguous_full_rejection_matches_plain_and_jax(models, monkeypatch):
    """Every draft wrong (the drafter forced to a token the target never
    picks): one committed token per verify, zero accepted drafts, the
    tokens still identical."""
    gen = jax_gen.GenerationConfig(max_dec_len=10, decode_strategy="greedy_search",
                                   eos_token_id=EOS, pad_token_id=0)
    ids, lens = jax_gen.pad_prompts(PROMPTS, 0, multiple=8)
    plain, *_ = _generate_both(models, gen, ids, lens, 3)
    never = next(t for t in range(1, 90) if t not in plain)
    monkeypatch.setattr(jax_gen, "ngram_propose", lambda ctx, known, pending, k, n=2:
                        jnp.full((ctx.shape[0], k), never, jnp.int32))
    monkeypatch.setattr(pt_gen, "ngram_propose", lambda ctx, known, pending, k, n=2:
                        torch.full((ctx.shape[0], k), never, dtype=torch.long))
    plain, got, want, stats, jstats = _generate_both(models, gen, ids, lens, 3)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert stats == jstats == (3 * 10 * len(PROMPTS), 0)


def test_contiguous_spec_is_refused_in_scan_mode(models, monkeypatch):
    _, _, model = models
    monkeypatch.setenv("PFX_DECODE_SCAN", "1")
    gen = pt_gen.GenerationConfig(max_dec_len=4, decode_strategy="greedy_search")
    with pytest.raises(ValueError, match="PFX_DECODE_SCAN"):
        pt_gen.generate(model, torch.ones((1, 4), dtype=torch.long), gen,
                        spec=pt_spec.SpecConfig(draft_k=2))
    monkeypatch.delenv("PFX_DECODE_SCAN")
    with pytest.raises(ValueError, match="draft_k 2"):  # the cache lacks the slack
        pt_gen.generate(model, torch.ones((1, 4), dtype=torch.long), gen,
                        cache=pt_gen.init_cache(model.config, 1, 8, torch.device("cpu")),
                        spec=pt_spec.SpecConfig(draft_k=2))


def _tiny_vocab_model():
    cfg = dict(vocab_size=16, hidden_size=16, num_layers=1, num_attention_heads=2,
               max_position_embeddings=32, dtype="float32")
    jcfg = JaxGPTConfig(**cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tree = jax.tree.map(np.asarray, jax_model.init(jcfg, jax.random.key(0)))
    return params_from_jax(GPTConfig(**cfg), tree)


def _marginals(tokens, vocab=16):
    t = np.asarray(tokens)
    return np.stack([np.bincount(t[:, j], minlength=vocab) / t.shape[0]
                     for j in range(t.shape[1])])


def test_contiguous_sampled_spec_keeps_the_distribution():
    """1024 identical rows decode 4 tokens (temperature 0.9, top-p 0.8,
    vocab 16) with and without speculation (k = 2): per position, the
    total variation between the two stays within 2x that of two plain
    runs on other seeds, plus 0.06 (the JAX package's bound)."""
    model = _tiny_vocab_model()
    gen = pt_gen.GenerationConfig(max_dec_len=4, decode_strategy="sampling", temperature=0.9,
                                  top_p=0.8, eos_token_id=15, pad_token_id=0)
    ids = torch.tensor([[3, 7, 2, 9]] * 1024)

    def run(seed, spec=None):
        return pt_gen.generate(model, ids, gen, spec=spec,
                               generator=torch.Generator().manual_seed(seed))

    base, ctrl = _marginals(run(1)), _marginals(run(2))
    spec = _marginals(run(3, pt_spec.SpecConfig(draft_k=2)))
    tv_ctrl = 0.5 * np.abs(base - ctrl).sum(axis=1)
    tv_spec = 0.5 * np.abs(base - spec).sum(axis=1)
    assert (tv_spec <= 2.0 * tv_ctrl + 0.06).all(), (tv_spec, tv_ctrl)


# ---------------------------------------------------------------------------
# the paged engine: decode_step_spec and the draft path
# ---------------------------------------------------------------------------


def _drive(eng):
    """Rows 0 and 1 admitted together, row 2 mid-decode, row 1 evicted
    mid-decode, row 3 admitted into the freed slot; then drain.  Returns
    {row: tokens} for rows 0, 2, 3."""
    slots = {0: eng.admit(PROMPTS[0], MAX_NEW), 1: eng.admit(PROMPTS[1], MAX_NEW)}
    eng.step()
    slots[2] = eng.admit(PROMPTS[2], MAX_NEW)
    eng.release(slots.pop(1))
    slots[3] = eng.admit(PROMPTS[3], MAX_NEW)
    for _ in range(8 * MAX_NEW):
        eng.step()
        if not eng.active.any():
            break
    out = {r: list(eng.slots[s].tokens) for r, s in slots.items()}
    for s in slots.values():
        eng.release(s)
    assert eng.cache.stats()["kv_blocks_used"] == 0
    return out


@pytest.mark.parametrize("kv_dtype,k", [("bf16", 3), ("int8", 3), ("bf16", 16)])
def test_engine_spec_matches_jax_engine(servers, sequential, kv_dtype, k):
    """Greedy speculative rows, admitted mid-decode and with an eviction,
    decode the tokens of the port's plain coalescing path and of the JAX
    engine with the same draft_k, with equal accept counts."""
    jserver, pserver = servers
    kw = dict(max_batch=4, block=8, kv_dtype=kv_dtype)
    jeng = jax_cb.PagedDecodeEngine(jserver, spec=jax_spec.SpecConfig(draft_k=k), **kw)
    want = _drive(jeng)
    eng = pt_cb.PagedDecodeEngine(pserver, spec=pt_spec.SpecConfig(draft_k=k), **kw)
    before = da.COUNTS["paged_plain"]
    got = _drive(eng)
    assert got == want
    if kv_dtype == "bf16":  # the model dtype, float32 here
        assert got == {r: sequential[r] for r in got}
    assert eng.stats["spec_proposed"] == jeng.stats["spec_proposed"] > 0
    assert eng.stats["spec_accepted"] == jeng.stats["spec_accepted"]
    assert eng.stats["spec_accept_rate"] == pytest.approx(
        eng.stats["spec_accepted"] / eng.stats["spec_proposed"])
    assert da.COUNTS["paged_plain"] > before
    assert eng.max_row_blocks == jeng.max_row_blocks


def test_engine_full_rejection_matches_jax(servers, sequential, monkeypatch):
    jserver, pserver = servers
    never = next(t for t in range(1, 90) if all(t not in row for row in sequential))
    monkeypatch.setattr(jax_cb, "ngram_propose_host", lambda seq, k, n=2: [never] * k)
    monkeypatch.setattr(pt_cb, "ngram_propose_host", lambda seq, k, n=2: [never] * k)
    kw = dict(max_batch=4, block=8)
    jeng = jax_cb.PagedDecodeEngine(jserver, spec=jax_spec.SpecConfig(draft_k=3), **kw)
    eng = pt_cb.PagedDecodeEngine(pserver, spec=pt_spec.SpecConfig(draft_k=3), **kw)
    got = _drive(eng)
    assert got == _drive(jeng) == {r: sequential[r] for r in got}
    assert eng.stats["spec_accepted"] == jeng.stats["spec_accepted"] == 0
    assert eng.stats["spec_proposed"] == jeng.stats["spec_proposed"] > 0


def test_engine_eos_inside_a_chunk_matches_jax(sequential, monkeypatch):
    """EOS := the token row 1 emits at step 1, and an oracle drafter that
    proposes each row's plain continuation, so row 1's EOS is an accepted
    draft inside its first verify chunk: both engines finish it there,
    with the plain tokens and equal accept counts."""
    eos = sequential[1][1]
    jserver, pserver = _pair({"eos_token_id": eos})
    plain = {tuple(p): pserver.generate_ids([p], max_dec_len=MAX_NEW)[0] for p in PROMPTS}
    assert len(plain[tuple(PROMPTS[1])]) == 1  # row 1 ends on EOS at step 1

    def oracle(seq, k, n=2):
        p = next(p for p in PROMPTS if list(seq[:len(p)]) == p)
        done = plain[tuple(p)] + ([eos] if len(plain[tuple(p)]) < MAX_NEW else [])
        out = done[len(seq) - len(p):][:k]
        return out + [out[-1] if out else 1] * (k - len(out))

    monkeypatch.setattr(jax_cb, "ngram_propose_host", oracle)
    monkeypatch.setattr(pt_cb, "ngram_propose_host", oracle)
    kw = dict(max_batch=4, block=8)
    outs, engines = [], []
    for eng in (jax_cb.PagedDecodeEngine(jserver, spec=jax_spec.SpecConfig(draft_k=3), **kw),
                pt_cb.PagedDecodeEngine(pserver, spec=pt_spec.SpecConfig(draft_k=3), **kw)):
        slots = [eng.admit(p, MAX_NEW) for p in PROMPTS]
        eng.step()
        assert eng.slots[slots[1]].tokens == plain[tuple(PROMPTS[1])]  # done in one step
        assert not eng.active[slots[1]]
        while eng.active.any():
            eng.step()
        outs.append([list(eng.slots[s].tokens) for s in slots])
        engines.append(eng)
    assert outs[1] == outs[0] == [plain[tuple(p)] for p in PROMPTS]
    assert engines[1].stats["spec_accepted"] == engines[0].stats["spec_accepted"] > 0
    assert engines[1].stats["spec_proposed"] == engines[0].stats["spec_proposed"]


def test_engine_row_at_exact_capacity(servers, monkeypatch):
    """A row whose budget plus draft_k slack ends exactly on a block edge,
    beside another row in a tight arena: its last verify chunk runs into
    the slack and nowhere else, and both rows decode as the plain engine
    and the JAX engine do."""
    jserver, pserver = servers
    k, block, max_new = 3, 8, 8
    prompts = [PROMPTS[0], PROMPTS[2]]  # 5 + 8 + 3 = 16 and 3 + 8 + 3 = 14 slots
    plain = pt_cb.PagedDecodeEngine(pserver, spec=None, max_batch=2, block=block)
    eng = pt_cb.PagedDecodeEngine(pserver, spec=pt_spec.SpecConfig(draft_k=k), max_batch=2,
                                  block=block, num_blocks=5)
    assert eng.row_capacity_tokens(len(prompts[0]), max_new) == 2 * block
    jeng = jax_cb.PagedDecodeEngine(jserver, spec=jax_spec.SpecConfig(draft_k=k), max_batch=2,
                                    block=block, num_blocks=5)
    outs = []
    for e in (plain, eng, jeng):
        slots = [e.admit(p, max_new) for p in prompts]
        while e.active.any():
            e.step()
        outs.append([list(e.slots[s].tokens) for s in slots])
        if e is eng:
            assert [len(e.slots[s].table) for s in slots] == [2, 2]
            assert e.cache.stats()["kv_blocks_free"] == 0  # the arena is full
    assert outs[1] == outs[0] == outs[2]
    assert all(len(o) == max_new for o in outs[1])


def test_one_paged_step_matches_jax(servers, sequential):
    """One decode_step_spec on the same arena state and drafts (row 0's all
    right, row 1's wrong at the second, row 2 one token from its budget,
    row 3 inactive): window, ncommit, positions, steps, activity, reject
    and counts equal; the carried logits within 2e-5."""
    jserver, pserver = servers
    jeng = jax_cb.PagedDecodeEngine(jserver, max_batch=4, block=8, spec=None)
    B = jeng.capacity  # a multiple of the JAX mesh's data-parallel world
    eng = pt_cb.PagedDecodeEngine(pserver, max_batch=B, block=8, spec=None)
    for e in (jeng, eng):
        for p, n in zip(PROMPTS[:3], (MAX_NEW, MAX_NEW, 2)):
            e.admit(p, n)
        e.step()
    # after one step each row has committed sequential[i][0] and its
    # pending logits pick sequential[i][1]: the right drafts follow that
    drafts = np.ones((B, 3), np.int32)
    for i in range(3):
        right = sequential[i][2:5]
        drafts[i, :len(right)] = right
    drafts[1, 1] = drafts[1, 1] % 90 + 1
    M = eng.table_width_bucket()
    tables = np.zeros((B, M), np.int32)
    for i, r in enumerate(eng.slots):
        if r is not None:
            tables[i, :len(r.table)] = r.table
            assert r.table == jeng.slots[i].table
    gen = jax_gen.GenerationConfig(max_dec_len=0, decode_strategy="greedy_search",
                                   eos_token_id=EOS, pad_token_id=0)
    jrows = jax_gen.PagedRows(jeng._logits, jeng._counts, jnp.asarray(jeng.positions),
                              jnp.asarray(jeng.gen_steps), jnp.asarray(jeng.max_news),
                              jnp.asarray(jeng.active), jnp.asarray(jeng.forced_steps),
                              jnp.full((B,), -1, jnp.int32))
    jwin, jn, _, jrows2 = jax_gen.decode_step_spec(
        jserver.params, jeng.pools, jnp.asarray(tables), jrows, jnp.asarray(drafts), jeng.mcfg,
        gen)
    np.testing.assert_allclose(eng._logits.numpy(), np.asarray(jeng._logits), atol=2e-5)
    rows = pt_gen.PagedRows(
        logits=torch.from_numpy(np.asarray(jeng._logits).copy()), counts=eng._counts.clone(),
        positions=torch.from_numpy(eng.positions.copy()),
        gen_steps=torch.from_numpy(eng.gen_steps.copy()),
        max_news=torch.from_numpy(eng.max_news.copy()),
        active=torch.from_numpy(eng.active.copy()),
        forced_steps=torch.from_numpy(eng.forced_steps.copy()),
        reject=torch.full((B,), -1, dtype=torch.int32))
    with torch.inference_mode():
        win, n, rows2 = pt_gen.decode_step_spec(
            eng.model, eng.pools, torch.from_numpy(tables), rows, torch.from_numpy(drafts),
            _pt_gen(gen))
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    for field in ("positions", "gen_steps", "active", "reject", "counts"):
        np.testing.assert_array_equal(getattr(rows2, field).numpy(),
                                      np.asarray(getattr(jrows2, field)), err_msg=field)
    np.testing.assert_allclose(rows2.logits.numpy(), np.asarray(jrows2.logits), atol=2e-5,
                               rtol=0)
    assert n.tolist() == [4, 2, 1] + [0] * (B - 3)


def test_engine_processors_pinned(monkeypatch):
    """Greedy speculation under repetition penalty, min_dec_len and forced
    BOS/EOS, on both paths: the same tokens as the plain loops and as the
    JAX package, and the same accept counts as the JAX engine."""
    jserver, pserver = _pair(PROCESSORS)
    plain = [pserver.generate_ids([p], max_dec_len=MAX_NEW)[0] for p in PROMPTS]
    assert all(row[0] == PROCESSORS["forced_bos_token_id"] for row in plain)
    spec_server = _pair({**PROCESSORS, "speculative": {"draft_k": 3}})[1]
    assert spec_server.spec.draft_k == 3
    assert [spec_server.generate_ids([p], max_dec_len=MAX_NEW)[0] for p in PROMPTS] == plain
    assert spec_server.stats["spec_proposed"] > 0
    kw = dict(max_batch=4, block=8)
    jeng = jax_cb.PagedDecodeEngine(jserver, spec=jax_spec.SpecConfig(draft_k=3), **kw)
    eng = pt_cb.PagedDecodeEngine(spec_server, **kw)  # spec="auto": the server's
    assert eng.spec == pt_spec.SpecConfig(draft_k=3)
    plain_eng = pt_cb.PagedDecodeEngine(pserver, **kw)
    outs = []
    for e in (plain_eng, eng, jeng):
        slots = [e.admit(p, MAX_NEW) for p in PROMPTS]
        while e.active.any():
            e.step()
        outs.append([list(e.slots[s].tokens) for s in slots])
    assert outs[1] == outs[0] == outs[2] == plain
    assert eng.stats["spec_accepted"] == jeng.stats["spec_accepted"]
    assert eng.stats["spec_proposed"] == jeng.stats["spec_proposed"] > 0


def test_engine_sampled_spec_keeps_the_distribution():
    """512 rows of one prompt decode 3 tokens through the paged engine
    (temperature 0.9, top-p 0.8, vocab 16) with and without speculation
    (k = 2; the residual mask crosses step boundaries in ``reject``): per
    position, the total variation to the plain engine stays within 2x
    that of two plain runs on other seeds, plus 0.06."""
    tiny = copy.deepcopy(TINY)
    tiny["Model"].update(vocab_size=16, hidden_size=16, num_layers=1, num_attention_heads=2,
                         max_position_embeddings=32)
    tiny["Generation"].update(decode_strategy="sampling", temperature=0.9, top_p=0.8,
                              eos_token_id=15, max_dec_len=3)
    pcfg = process_configs(AttrDict.from_nested(
        {k: v for k, v in tiny.items() if k in PORT_SECTIONS}))
    module = GPTModule(pcfg)
    server = GenerationServer(pcfg, module, _tiny_vocab_model(), torch.device("cpu"))
    B = 512

    def run(seed, spec):
        server.generator.manual_seed(seed)
        eng = pt_cb.PagedDecodeEngine(server, spec=spec, max_batch=B, block=8)
        slots = [eng.admit([3, 7, 2, 9], 3) for _ in range(B)]
        while eng.active.any():
            eng.step()
        toks = [eng.slots[s].tokens + [0] * (3 - len(eng.slots[s].tokens)) for s in slots]
        return _marginals(toks), eng

    base, _ = run(1, None)
    ctrl, _ = run(2, None)
    spec, eng = run(3, pt_spec.SpecConfig(draft_k=2))
    assert eng.stats["spec_proposed"] > 0
    tv_ctrl = 0.5 * np.abs(base - ctrl).sum(axis=1)
    tv_spec = 0.5 * np.abs(base - spec).sum(axis=1)
    assert (tv_spec <= 2.0 * tv_ctrl + 0.06).all(), (tv_spec, tv_ctrl)


def test_host_drafts_read_a_bounded_tail(servers, monkeypatch):
    """The engine hands the drafter at most NGRAM_WINDOW + n + k + 2 tokens a
    row (prompt tail + tokens), the same tail the JAX engine hands it."""
    _, pserver = servers
    need = 6 + 2 + 2 + 2
    seen = []

    def drafter(seq, k, n=2):
        r = eng.slots[slot]
        seen.append((list(seq), (r.prompt_ids + r.tokens)[-need:]))
        return [1] * k

    monkeypatch.setattr(pt_cb, "NGRAM_WINDOW", 6)
    monkeypatch.setattr(pt_cb, "ngram_propose_host", drafter)
    eng = pt_cb.PagedDecodeEngine(pserver, spec=pt_spec.SpecConfig(draft_k=2), max_batch=2,
                                  block=8)
    slot = eng.admit(PROMPTS[1], MAX_NEW)
    for _ in range(3):
        eng.step()
    assert len(seen) == 3 and all(got == want for got, want in seen)
    assert len(seen[-1][0]) == need < len(PROMPTS[1]) + len(eng.slots[slot].tokens)


# ---------------------------------------------------------------------------
# the wrappers' multi-query counts and the shared split-K scratch
# ---------------------------------------------------------------------------


def test_multi_query_launches_are_counted_apart(monkeypatch):
    # synthetic launches: counted in a copy, so no later test in this
    # process reads them as real ones
    monkeypatch.setattr(da, "COUNTS", dict(da.COUNTS))
    before = dict(da.COUNTS)
    for name, t, route in (("flash_decode", 5, "sm90"), ("flash_decode", 1, "sm90"),
                           ("flash_decode_q8", 17, "sm90"), ("paged_decode", 16, "sm90"),
                           ("paged_decode_q8", 4, "cuda_core"), ("paged_decode", 17,
                                                                 "cuda_core")):
        da._count(name, t, route)
    delta = {key: da.COUNTS[key] - before[key] for key in da.COUNTS}
    assert delta["flash_decode"] == 2 and delta["flash_decode_multi"] == 1
    assert delta["flash_decode_sm90_multi"] == 1 and delta["flash_decode_q8_multi"] == 0
    assert delta["paged_decode"] == 2 and delta["paged_decode_multi"] == 1
    assert delta["paged_decode_sm90_multi"] == 1 and delta["paged_decode_sm90"] == 1
    assert delta["paged_decode_q8_multi"] == 1 and delta["paged_decode_q8_sm90_multi"] == 0
    # the route rule stays a function of dtype and shape only: a verify
    # chunk past t = 16 takes the sm90 route's chunk kernel
    assert da.paged_kernel_route(torch.bfloat16, 64, 17, 16) == "sm90"
    assert da.paged_kernel_route(torch.bfloat16, 64, 16, 16) == "sm90"
    assert da.paged_kernel_route(torch.float32, 64, 17, 16) == "cuda_core"
    assert da.kernel_route(torch.bfloat16, 64) == "sm90" and da.SPLIT_MAX_ROWS == 16


def test_split_scratch_grows_and_stays_shared(monkeypatch):
    """The verify chunk (t = k + 1) needs more split-K partials than the
    t = 1 step: the scratch of a device grows to the largest request, a
    smaller one reuses it, and the counters (left zeroed by every launch)
    are kept while they are large enough.  Growing replaces a buffer and
    never resizes it, so a holder of the old pair (a captured CUDA graph)
    keeps its memory."""
    monkeypatch.setattr(da, "_SCRATCH", {})
    dev = torch.device("cpu")
    p1, c1 = da._split_scratch(dev, 100, 8)
    p2, c2 = da._split_scratch(dev, 400, 8)
    assert p2.numel() == 400 and c2 is c1 and p1.numel() == 100
    p3, c3 = da._split_scratch(dev, 50, 4)
    assert p3 is p2 and c3 is c1
    p4, c4 = da._split_scratch(dev, 50, 16)
    assert p4 is p2 and c4.numel() == 16 and int(c4.abs().sum()) == 0
    assert da.split_scratch(dev)[0] is p4 and da.split_scratch(dev)[1] is c4
    p5, c5 = da.reserve_split_scratch(dev, 1000, 4)  # the engine's reservation
    assert p5.numel() == 1000 and c5 is c4 and p4.numel() == 400


# ---------------------------------------------------------------------------
# the serve CLI: --draft-k on both schedulers
# ---------------------------------------------------------------------------


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


@pytest.mark.parametrize("scheduler", ["coalesce", "continuous"])
def test_cli_draft_k_round_trip(tmp_path, scheduler):
    """``tools.serve --draft-k 2 --device cpu``: the same completions as a
    plain in-process server built from the same config, the draft counts
    in /healthz's serving block, the verify chunk on the plain versions,
    and a clean SIGTERM drain."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({k: TINY[k] for k in PORT_SECTIONS}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", str(cfg_path),
         "--port", str(port), "--device", "cpu", "--scheduler", scheduler, "--cb-batch", "2",
         "--max-coalesce", "2", "--draft-k", "2"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        health = None
        while time.time() < deadline and health is None:
            try:
                health = _http(port, "/healthz")
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"server died: {proc.stdout.read()[-2000:]}")
                time.sleep(0.3)
        assert health and health["ok"], health
        cfg = process_configs(AttrDict.from_nested(
            {k: copy.deepcopy(TINY[k]) for k in PORT_SECTIONS}))
        module = GPTModule(cfg)
        ref = GenerationServer(cfg, module, module.init_model(cfg.Global.seed, "cpu"),
                               torch.device("cpu"))
        assert ref.spec is None
        for p in PROMPTS:
            got = _http(port, "/generate", {"prompt_ids": p, "max_tokens": MAX_NEW})
            assert got["completion_ids"] == ref.generate_ids([p], max_dec_len=MAX_NEW)[0]
        health = _http(port, "/healthz")
        serving, kernels = health["serving"], health["kernels"]
        assert serving["spec_proposed"] > 0 and 0 <= serving["spec_accepted"]
        assert serving["spec_accept_rate"] == pytest.approx(
            serving["spec_accepted"] / serving["spec_proposed"])
        plain = "paged_plain" if scheduler == "continuous" else "plain"
        assert kernels[plain] > 0 and kernels["flash_decode"] == 0, kernels
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        out = proc.stdout.read()
        assert f"scheduler {scheduler}" in out and "drained cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
