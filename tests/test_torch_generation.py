"""PyTorch port: weight bridge, cached forward, greedy generation and the
sampling ops against the JAX package on the CPU.

Weights come from the JAX initializer and cross through the bridge; the
model is the TINY serving config of tests/test_kv_tier.py (vocab 96,
2 layers, hidden 32, 4 heads, float32).  Tolerances: bridge round trip
exact, cached-forward logits 1e-5 (float32, summation order differs),
greedy tokens identical, filtered logits exact, nucleus draws identical
when both sides get the same uniform.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops import sampling as jax_sampling
from paddlefleetx_tpu_torch.models.gpt import generation as pt_gen
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax, params_to_jax
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.ops import sampling as pt_sampling

# tests/test_kv_tier.py TINY["Model"]
TINY = dict(vocab_size=96, hidden_size=32, num_layers=2, num_attention_heads=4,
            max_position_embeddings=128, dtype="float32")
EOS = 95


@pytest.fixture(scope="module")
def models():
    jcfg = JaxGPTConfig(**TINY, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jparams = jax_model.init(jcfg, jax.random.key(0))
    # biases and LayerNorm affine start at zeros/ones: give them values so
    # a mis-bridged leaf cannot hide
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
        jparams,
    )
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, params_from_jax(GPTConfig(**TINY), tree)


def test_bridge_round_trip_exact(models):
    _, jparams, model = models
    back = params_to_jax(model)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b) == 16
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))
    # LayerNorm affine stays float32, as the JAX forward applies it
    assert model.layers[0].ln_1.scale.dtype == torch.float32


def test_bridge_rejects_bad_shapes(models):
    _, jparams, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"]["attn"]["qkv_kernel"] = tree["layers"]["attn"]["qkv_kernel"][:1]
    with pytest.raises(ValueError):
        params_from_jax(GPTConfig(**TINY), tree)


def _prompts():
    rng = np.random.default_rng(11)
    lens = [5, 11, 8]
    return [rng.integers(1, 90, size=n).tolist() for n in lens]


def test_forward_cached_logits_match(models):
    jcfg, jparams, model = models
    ids, lens = jax_gen.pad_prompts(_prompts(), 0, multiple=8)
    P = ids.shape[1]
    pad_len, pos_ids = jax_gen._left_pad_prefill(P, lens)
    jcache = jax_gen.init_cache(jcfg, 3, P + 4)
    jl, jcache = jax_gen.forward_cached(jparams, ids, jcache, jnp.int32(0), jcfg,
                                       position_ids=pos_ids, kv_valid_from=pad_len)
    nxt = jnp.argmax(jl[:, -1], -1)[:, None]
    jl2, jcache = jax_gen.forward_cached(jparams, nxt, jcache, jnp.int32(P), jcfg,
                                    position_ids=lens[:, None], kv_valid_from=pad_len)

    t_ids, t_lens = pt_gen.pad_prompts(_prompts(), 0, multiple=8)
    t_pad, t_pos = pt_gen._left_pad_prefill(P, t_lens)
    cache = pt_gen.init_cache(model.config, 3, P + 4, torch.device("cpu"))
    with torch.inference_mode():
        tl = pt_gen.forward_cached(model, t_ids, cache, 0, position_ids=t_pos,
                                   kv_valid_from=t_pad)
        tl2 = pt_gen.forward_cached(model, torch.from_numpy(np.array(nxt)).long(), cache,
                                    P, position_ids=t_lens[:, None].long(),
                                    kv_valid_from=t_pad)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.k[:, :, :, :P + 1].numpy(),
                               np.asarray(jcache.k)[:, :, :, :P + 1], rtol=1e-5, atol=1e-5)


GREEDY = jax_gen.GenerationConfig(max_dec_len=10, decode_strategy="greedy_search",
                                  eos_token_id=EOS, pad_token_id=0)
GREEDY_CASES = {
    "unpadded": dict(padded=False, gen={}),
    "left_padded_buckets": dict(padded=True, gen={}),
    "min_len_rep_penalty": dict(padded=True, gen=dict(min_dec_len=4, repetition_penalty=1.3,
                                                      forced_eos_token_id=7)),
    "int8_kv": dict(padded=True, gen={}, kv="int8"),
}


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_generate_token_identical(models, case):
    jcfg, jparams, model = models
    spec = GREEDY_CASES[case]
    gen = dataclasses.replace(GREEDY, **spec["gen"])
    kv = spec.get("kv", "bf16")
    if spec["padded"]:
        ids, lens = jax_gen.pad_prompts(_prompts(), 0, multiple=8)
    else:
        ids, lens = jnp.asarray(np.array([p[:5] for p in _prompts()])), None
    b, P = ids.shape
    jcache = jax_gen.init_cache(jcfg, b, P + gen.max_dec_len, kv_dtype=kv)
    ref = np.asarray(jax_gen.generate(jparams, ids, jcfg, gen, prompt_lens=lens,
                                      cache=jcache))

    pgen = pt_gen.GenerationConfig(**{
        f.name: getattr(gen, f.name) for f in dataclasses.fields(pt_gen.GenerationConfig)
    })
    cache = pt_gen.init_cache(model.config, b, P + gen.max_dec_len, torch.device("cpu"),
                              kv_dtype=kv)
    got = pt_gen.generate(
        model, torch.from_numpy(np.array(ids)).long(), pgen,
        prompt_lens=None if lens is None else torch.from_numpy(np.array(lens)),
        cache=cache,
    )
    np.testing.assert_array_equal(got.numpy(), ref)
    if kv == "int8":
        assert cache.k.dtype == torch.int8 and cache.k_scale.abs().sum() > 0


def test_scan_mode_matches_early_exit(models, monkeypatch):
    _, _, model = models
    gen = pt_gen.GenerationConfig(max_dec_len=12, decode_strategy="greedy_search",
                                  eos_token_id=EOS)
    ids, lens = pt_gen.pad_prompts(_prompts(), 0, multiple=8)
    early = pt_gen.generate(model, ids, gen, prompt_lens=lens)
    monkeypatch.setenv("PFX_DECODE_SCAN", "1")
    assert pt_gen.decode_loop_mode() == "scan"
    full = pt_gen.generate(model, ids, gen, prompt_lens=lens)
    np.testing.assert_array_equal(early.numpy(), full.numpy())


BEAM = dict(max_dec_len=10, decode_strategy="beam_search", eos_token_id=EOS, pad_token_id=0)
BEAM_CASES = {
    "beams1": dict(padded=True, gen=dict(num_beams=1)),
    "beams4": dict(padded=True, gen=dict(num_beams=4)),
    "beams4_unpadded": dict(padded=False, gen=dict(num_beams=4)),
    "groups2_diversity": dict(padded=True, gen=dict(num_beams=4, num_beam_groups=2,
                                                    diversity_penalty=0.5)),
    "length_penalty_0.6": dict(padded=True, gen=dict(num_beams=4, length_penalty=0.6)),
    "length_penalty_1.0": dict(padded=True, gen=dict(num_beams=3, length_penalty=1.0)),
    "min_len_forced": dict(padded=True, gen=dict(num_beams=4, min_dec_len=4,
                                                 forced_bos_token_id=7,
                                                 forced_eos_token_id=EOS)),
    "tied_logits": dict(padded=True, gen=dict(num_beams=4), tie=True),
}


def _beam_pair(models, spec):
    """(JAX beam tokens, port beam tokens) on the same weights and prompts."""
    jcfg, jparams, model = models
    if spec.get("tie"):
        # tokens 9..30 share one embedding row, so their logits tie exactly at
        # every step (the LM head is tied): the beams must pick the lower index
        tree = jax.tree.map(np.asarray, jparams)
        word = tree["embeddings"]["word"].copy()
        word[10:31] = word[9]
        tree["embeddings"]["word"] = word
        jparams = jax.tree.map(jnp.asarray, tree)
        model = params_from_jax(model.config, tree)
    gen = jax_gen.GenerationConfig(**BEAM, **spec["gen"])
    if spec["padded"]:
        ids, lens = jax_gen.pad_prompts(_prompts(), 0, multiple=8)
    else:
        ids, lens = jnp.asarray(np.array([p[:5] for p in _prompts()])), None
    ref = np.asarray(jax_gen.generate(jparams, ids, jcfg, gen, prompt_lens=lens))
    pgen = pt_gen.GenerationConfig(**BEAM, **spec["gen"])
    got = pt_gen.generate(
        model, torch.from_numpy(np.array(ids)).long(), pgen,
        prompt_lens=None if lens is None else torch.from_numpy(np.array(lens)))
    return ref, got.numpy()


def test_beam_search_is_refused(models):
    """Beam search is served (tokens identical to JAX ``beam_search``);
    what it refuses is what the JAX ``generate`` refuses: a caller's cache
    and speculation (the beam loop reorders its own cache by parent)."""
    ref, got = _beam_pair(models, BEAM_CASES["beams4"])
    np.testing.assert_array_equal(got, ref)
    _, _, model = models
    gen = pt_gen.GenerationConfig(**BEAM)
    ids = torch.tensor([[3, 4, 5]])
    cache = pt_gen.init_cache(model.config, 1, 3 + gen.max_dec_len, torch.device("cpu"))
    for kw in ({"cache": cache}, {"return_cache": True},
               {"spec": pt_gen.SpecConfig(draft_k=2)}):
        with pytest.raises(ValueError, match="beam_search"):
            pt_gen.generate(model, ids, gen, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        pt_gen.generate(model, ids, pt_gen.GenerationConfig(**BEAM, num_beam_groups=3))


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_search_matches_jax(models, case):
    ref, got = _beam_pair(models, BEAM_CASES[case])
    np.testing.assert_array_equal(got, ref)
    if case == "tied_logits":
        assert np.isin(got, np.arange(9, 31)).any()  # the tie was in play


def test_top_k_breaks_ties_by_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -1e9, -1e9]])
    vals, idx = pt_gen.top_k_lower_index(x, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4, 3, 0]]


def test_hamming_diversity_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 2, 96)).astype(np.float32)
    cur = np.array([[5, 7, -1, -1], [5, 5, -1, -1]], np.int32)
    got = pt_gen.apply_hamming_diversity(torch.from_numpy(logits), torch.from_numpy(cur).long(),
                                         2, 0.5)
    for b in range(2):
        want = jax_gen.apply_hamming_diversity(jnp.asarray(logits[b]), jnp.asarray(cur[b]), 2, 0.5)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 0.8), (0.7, 10, 0.9),
                                                     (1.3, 5, 1.0)])
def test_filtered_logits_exact(temperature, top_k, top_p):
    logits = np.random.default_rng(4).normal(size=(4, 96)).astype(np.float32) * 2
    ref = jax_sampling.filtered_logits(jnp.asarray(logits), temperature=temperature,
                                       top_k=top_k, top_p=top_p)
    got = pt_sampling.filtered_logits(torch.from_numpy(logits), temperature=temperature,
                                      top_k=top_k, top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_p,k", [(0.6, 64), (0.97, 4)])  # fast path; overflow -> full sort
def test_sample_top_p_topk_same_uniform(top_p, k):
    rng = np.random.default_rng(5)
    probs = rng.dirichlet(np.full(300, 0.1), size=6).astype(np.float32)
    key = jax.random.key(9)
    u = np.array(jax.random.uniform(key, (6, 1)))
    tp = np.full((6,), top_p, np.float32)
    ref = jax_sampling.sample_top_p_topk(key, jnp.asarray(probs), jnp.asarray(tp), k=k)
    got = pt_sampling.sample_top_p_topk(torch.from_numpy(probs), torch.from_numpy(tp), k=k,
                                        u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    full = pt_sampling.sample_top_p(torch.from_numpy(probs), torch.from_numpy(tp),
                                    u=torch.from_numpy(u))
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref))


def test_sampling_generate_is_seeded(models):
    _, _, model = models
    gen = pt_gen.GenerationConfig(max_dec_len=6, decode_strategy="sampling", top_p=0.9,
                                  top_k=20, temperature=0.8, eos_token_id=-1)
    ids, lens = pt_gen.pad_prompts(_prompts(), 0, multiple=8)
    outs = [pt_gen.generate(model, ids, gen, prompt_lens=lens,
                            generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    assert outs[0].shape == (3, 6) and int(outs[0].max()) < 96
