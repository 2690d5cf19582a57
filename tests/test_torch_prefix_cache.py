"""PyTorch port: chunked prefill, the shared-prefix KV cache and its host
spill tier on the continuous-batching path, against the JAX package on
the CPU.

  - the host bookkeeping (refcounted ``BlockAllocator``, ``PrefixIndex``,
    ``PrefixSpillStore``, ``PagedCacheManager``) driven by the operation
    sequences of tests/test_prefix_cache.py and tests/test_kv_tier.py
    through both packages' modules: the same block ids, match results,
    stats and errors;
  - the engine against the JAX engine on the prefix and chunk cases of
    tests/test_continuous_batching.py and the spill round trip of
    tests/test_kv_tier.py: greedy tokens, block tables and the prefix,
    spill and chunk accounting identical, logits within 1e-4 (float32,
    the two sides sum in different orders);
  - ``n_valid`` null-routing with NaN in the null block, and the serve
    CLI with the three flags over HTTP.

The model is the TINY serving config of tests/test_torch_continuous_batching.py
(vocab 96, 2 layers, hidden 32, 4 heads, float32, block 8), on the same
perturbed JAX weights crossed through the bridge.
"""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from paddlefleetx_tpu.core import paged_cache as jax_pc
from paddlefleetx_tpu.core.continuous_batching import PagedDecodeEngine as JaxEngine
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops import speculative as jax_spec
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core import paged_cache as pt_pc
from paddlefleetx_tpu_torch.core.continuous_batching import (
    ContinuousScheduler,
    PagedDecodeEngine,
)
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as pt_gen
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.ops import decode_attention
from paddlefleetx_tpu_torch.ops import speculative as pt_spec
from paddlefleetx_tpu_torch.tools.serve import build_scheduler
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
BLK = 8
MAX_NEW = 6

# tests/test_continuous_batching.py's prompts: a 36-token shared prefix
# (four full blocks of 8 and 4 tokens), two prompts on it, an unrelated one
_prng = np.random.default_rng(7)
PFX_SHARED = _prng.integers(1, 95, 36).tolist()
LONG_A = PFX_SHARED + _prng.integers(1, 95, 4).tolist()  # 40 tokens
LONG_B = PFX_SHARED + _prng.integers(1, 95, 6).tolist()  # 42, diverges at 36
LONG_C = _prng.integers(1, 95, 64).tolist()              # unrelated, 4 chunks of 16
EXT_C = LONG_C + _prng.integers(1, 95, 8).tolist()       # 72, extends LONG_C
MID = LONG_A[:20] + [(t % 93) + 1 for t in LONG_A[20:26]]  # diverges inside block 2
SHORT = [5, 17, 33, 2, 8]
# tests/test_kv_tier.py's one-block families: under a one-block index
# budget B's publication evicts A (spill), and A's return readmits it
PFX_A = list(range(1, 9))
PFX_B = list(range(10, 18))
A1 = PFX_A + [40, 41, 42]
A2 = PFX_A + [50, 51]
B1 = PFX_B + [60, 61, 62]


def _port_cfg():
    return process_configs(AttrDict.from_nested(
        {k: v for k, v in copy.deepcopy(TINY).items() if k in PORT_SECTIONS}
    ))


@pytest.fixture(scope="module")
def servers():
    """(JAX GenerationServer, port GenerationServer) on the same weights."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k != "module"}
    jparams = jax_model.init(JaxGPTConfig(**model_kw), jax.random.key(0))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), jparams
    )
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(TINY)),
                              num_devices=jax.device_count())
    jserver = JaxServer(cfg, init_dist_env(cfg), build_module(cfg),
                        params=jax.tree.map(jnp.asarray, tree))
    pcfg = _port_cfg()
    module = GPTModule(pcfg)
    model = params_from_jax(module.config, tree)
    return jserver, GenerationServer(pcfg, module, model, torch.device("cpu"))


_REFS = {}


def _ref(pserver, prompt):
    """The port's coalescing path, one prompt alone (float32: the greedy
    tokens every cached, chunked or readmitted path must give)."""
    key = tuple(prompt)
    if key not in _REFS:
        _REFS[key] = pserver.generate_ids([prompt], max_dec_len=MAX_NEW)[0]
    return _REFS[key]


# ---------------------------------------------------------------------------
# host bookkeeping: the operation sequences of tests/test_prefix_cache.py
# and tests/test_kv_tier.py through either package's module
# ---------------------------------------------------------------------------


def _seq(n, start=0):
    return list(range(start, start + n))


def _raises(out, fn, exc):
    """Record the error a call raises (type name and message)."""
    try:
        fn()
    except exc as e:
        out.append((type(e).__name__, str(e)))
        return
    raise AssertionError(f"{fn} did not raise {exc}")


def _index(mod, num_blocks=32, budget=16):
    a = mod.BlockAllocator(num_blocks)
    return a, mod.PrefixIndex(a, BLK, budget)


def sc_share_then_free(mod):
    a = mod.BlockAllocator(6)
    (b,) = a.alloc(1)
    a.share([b])
    out = [b, a.refcount(b)]
    a.free([b])
    out += [a.refcount(b), a.used_count(), a.alloc(4)]
    a.free([b])
    out += [a.refcount(b), a.alloc(1), sorted(a._free)]
    assert out[1] == 2 and out[2] == 1 and b not in out[4]
    return out


def sc_overfree(mod):
    a = mod.BlockAllocator(4)
    (b,) = a.alloc(1)
    a.share([b])
    a.free([b])
    a.free([b])
    out = []
    _raises(out, lambda: a.free([b]), ValueError)
    assert "double free" in out[0][1]
    return out


def sc_share_bad(mod):
    a = mod.BlockAllocator(6)
    got = a.alloc(2)
    out = [got]
    _raises(out, lambda: a.share([got[0], 4]), ValueError)
    out.append(a.refcount(got[0]))
    _raises(out, lambda: a.share([0]), ValueError)
    _raises(out, lambda: a.share([99]), ValueError)
    _raises(out, lambda: a.refcount(99), ValueError)
    assert out[2] == 1
    return out


def sc_used_count_physical(mod):
    a = mod.BlockAllocator(8)
    got = a.alloc(3)
    for _ in range(4):
        a.share(got)
    out = [got, a.refcount(got[0]), a.used_count(), a.free_count()]
    assert out[2] == 3
    return out


def sc_publish_and_match(mod):
    a, idx = _index(mod)
    table = a.alloc(3)
    prompt = _seq(20)
    out = [table, idx.publish(prompt, table), idx.cached_blocks(),
           [a.refcount(b) for b in table]]
    a.free(table)
    out += [a.used_count(), idx.match(prompt + [99, 98]), dict(idx.stats)]
    idx.record_lookup(out[-2][2])
    out.append(dict(idx.stats))
    assert out[-1]["hits"] == 1 and out[-1]["hit_tokens"] == 20
    return out


def sc_match_leaves_one(mod):
    a, idx = _index(mod)
    table = a.alloc(2)
    idx.publish(_seq(16), table)
    out = [table, idx.match(_seq(16))]
    assert out[1][2] == 15
    return out


def sc_cow_inside_full_block(mod):
    a, idx = _index(mod)
    table = a.alloc(2)
    idx.publish(_seq(16), table)
    out = [table, idx.match(_seq(11) + [77, 78, 79, 80, 81, 82])]
    assert out[1][1] == (table[1], 3)
    return out


def sc_cow_first_block(mod):
    a, idx = _index(mod)
    table = a.alloc(1)
    idx.publish(_seq(8), table)
    return [table, idx.match([0, 1, 2, 99, 98, 97])]


def sc_miss(mod):
    a, idx = _index(mod)
    idx.publish(_seq(8), a.alloc(1))
    out = [idx.match([50, 51, 52, 53])]
    idx.record_lookup(out[0][2])
    out.append(dict(idx.stats))
    assert out[1]["misses"] == 1
    return out


def sc_republish_dedupes(mod):
    a, idx = _index(mod)
    t1 = a.alloc(3)
    idx.publish(_seq(20), t1)
    t2 = a.alloc(3)
    out = [t1, t2, idx.publish(_seq(20), t2), idx.cached_blocks(),
           [a.refcount(b) for b in t2]]
    assert out[2] == 0
    return out


def sc_lru_leaf_first(mod):
    a, idx = _index(mod, budget=3)
    chain = a.alloc(3)
    idx.publish(_seq(24), chain)
    a.free(chain)
    other = a.alloc(1)
    idx.publish(_seq(8, start=100), other)
    a.free(other)
    out = [chain, other, idx.cached_blocks(), dict(idx.stats), idx.match(_seq(24)),
           idx.digest()]
    assert out[3]["evictions"] == 1 and out[4][2] >= 16
    return out


def sc_evict_never_live(mod):
    a, idx = _index(mod, num_blocks=6, budget=4)
    table = a.alloc(2)
    idx.publish(_seq(16), table)
    a.share(table)
    a.free(table)
    out = [table, idx.evict_for(need_free=5), idx.cached_blocks(), a.used_count(),
           a.free_count()]
    a.free(table)
    out.append(a.free_count())
    assert out[3] == 2 and out[5] == 5
    return out


def sc_insert_block_and_has_path(mod):
    """The readmit's structural insert: takes over the caller's reference,
    loud on a bad length, a missing parent or a duplicate."""
    a, idx = _index(mod)
    idx.publish(_seq(8), a.alloc(1))
    (b,) = a.alloc(1)
    idx.insert_block(_seq(16), b)
    out = [b, a.refcount(b), idx.has_path(_seq(16)), idx.has_path(_seq(24)),
           idx.has_path(_seq(5)), idx.match(_seq(20)), idx.cached_blocks()]
    _raises(out, lambda: idx.insert_block(_seq(12), a.alloc(1)[0]), ValueError)
    _raises(out, lambda: idx.insert_block(_seq(24, start=50), a.alloc(1)[0]), ValueError)
    _raises(out, lambda: idx.insert_block(_seq(16), a.alloc(1)[0]), ValueError)
    assert out[1] == 1 and out[2] and not out[3]
    return out


def sc_clear(mod):
    a, idx = _index(mod)
    idx.publish(_seq(20), a.alloc(3))
    ev0 = idx.stats["evictions"]
    out = [idx.clear(), idx.cached_blocks(), idx.stats["evictions"] - ev0,
           idx.match(_seq(20))]
    assert out[0] == 3 and out[2] == 0
    return out


def sc_disabled(mod):
    a, idx = _index(mod, budget=0)
    return [idx.enabled, idx.publish(_seq(20), a.alloc(3)), idx.cached_blocks()]


def sc_manager_shared(mod):
    m = mod.PagedCacheManager(10, block=16, prefix_blocks=8)
    t1 = m.admit(1, 40)
    m.prefix.publish(list(range(40)), t1)
    m.release(1)
    out = [t1, m.stats()]
    shared, cow, hit = m.prefix.match(list(range(36)) + [99, 98])
    t2 = m.admit(2, 40, shared=shared)
    out += [(shared, cow, hit), t2, m.stats(), m.available_blocks()]
    m.release(2)
    out.append(m.stats())
    assert out[4]["kv_blocks_used"] == 4
    return out


def sc_manager_evicts(mod):
    m = mod.PagedCacheManager(5, block=16, prefix_blocks=4)
    t1 = m.admit(1, 64)
    m.prefix.publish(list(range(64)), t1)
    m.release(1)
    out = [t1, m.allocator.free_count(), m.available_blocks(), m.can_admit(48)]
    out += [m.admit(2, 48, shared=[]), dict(m.prefix.stats), m.stats()]
    assert out[2] == 4 and out[5]["evictions"] >= 3
    return out


def sc_manager_atomic(mod):
    m = mod.PagedCacheManager(4, block=16, prefix_blocks=3)
    t1 = m.admit(1, 48)
    m.prefix.publish(list(range(40)), t1)
    out = [t1]
    _raises(out, lambda: m.admit(2, 64, shared=[t1[0]]), mod.BlockPoolExhausted)
    out += [m.allocator.refcount(t1[0]), m.prefix.cached_blocks()]
    m.release(1)
    out.append(m.stats())
    assert out[2] == 1 and out[-1]["kv_blocks_used"] == 0
    return out


def _arrs(rng):
    return {"k": rng.standard_normal((2, 1, 4, BLK, 64)).astype(np.float32),
            "v": rng.standard_normal((2, 1, 4, BLK, 64)).astype(np.float32)}


def sc_spill_budget_lru_crc(mod):
    rng = np.random.default_rng(0)
    one = sum(a.nbytes for a in _arrs(rng).values())
    store = mod.PrefixSpillStore(budget_bytes=2 * one)
    a0, a1, a2 = _arrs(rng), _arrs(rng), _arrs(rng)
    out = [store.put((1,), a0), store.put((2,), a1), store.bytes_used(), len(store),
           store.get((1,))["k"].tobytes() == a0["k"].tobytes(), store.put((3,), a2),
           store.get((2,)) is None, store.get((1,)) is not None, dict(store.stats)]
    store.pop((1,))
    out += [len(store), dict(store.stats)]
    # a torn entry (an altered array) is dropped, never handed back
    entry = store._entries[(3,)]
    entry["arrays"]["k"] = entry["arrays"]["k"].copy()
    entry["arrays"]["k"][0, 0, 0, 0, 0] += 1.0
    out += [store.get((3,)) is None, dict(store.stats), len(store), store.bytes_used()]
    assert out[-3]["discards"] == 2 and out[-1] == 0
    return out


def sc_spill_disabled_oversize_clear(mod):
    rng = np.random.default_rng(1)
    out = []
    _raises(out, lambda: mod.PrefixSpillStore(budget_bytes=-1), ValueError)
    off = mod.PrefixSpillStore(budget_bytes=0)
    out += [off.enabled, off.put((1,), _arrs(rng))]
    tiny = mod.PrefixSpillStore(budget_bytes=16)
    out += [tiny.put((1,), _arrs(rng)), dict(tiny.stats), len(tiny)]
    store = mod.PrefixSpillStore(budget_bytes=1 << 30)
    store.put((1,), _arrs(rng))
    store.put((2,), _arrs(rng))
    out += [store.clear(), len(store), store.bytes_used(), dict(store.stats),
            store.get((1,)) is None]
    return out


def sc_path_hashes(mod):
    toks = _seq(24, start=3)
    return [mod.prefix_path_hash(toks), mod.prefix_digest_hashes(toks, BLK),
            mod.prefix_digest_hashes(toks[:7], BLK)]


HOST_CASES = [sc_share_then_free, sc_overfree, sc_share_bad, sc_used_count_physical,
              sc_publish_and_match, sc_match_leaves_one, sc_cow_inside_full_block,
              sc_cow_first_block, sc_miss, sc_republish_dedupes, sc_lru_leaf_first,
              sc_evict_never_live, sc_insert_block_and_has_path, sc_clear, sc_disabled, sc_manager_shared,
              sc_manager_evicts, sc_manager_atomic, sc_spill_budget_lru_crc,
              sc_spill_disabled_oversize_clear, sc_path_hashes]


@pytest.mark.parametrize("case", HOST_CASES, ids=lambda f: f.__name__[3:])
def test_host_bookkeeping_matches_jax(case):
    assert case(pt_pc) == case(jax_pc)


def test_spill_store_round_trips_bf16_tensors():
    """The engine spills CPU tensors (numpy has no bfloat16): bit-exact
    round trip, the CRC over their raw bytes catches a changed bit."""
    g = torch.Generator().manual_seed(0)
    blocks = {n: torch.randn((2, 1, 4, BLK, 16), generator=g).to(torch.bfloat16)
              for n in ("k", "v")}
    store = pt_pc.PrefixSpillStore(budget_bytes=1 << 20)
    assert store.put((1, 2), blocks)
    assert store.bytes_used() == 2 * blocks["k"].nbytes
    got = store.get((1, 2))
    assert all(torch.equal(got[n], blocks[n]) for n in blocks)
    torn = got["v"].clone()
    torn.view(torch.int16).view(-1)[5] ^= 1
    store._entries[(1, 2)]["arrays"]["v"] = torn
    assert store.get((1, 2)) is None and store.stats["discards"] == 1


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


def _logits(eng, slot):
    x = eng._logits[slot]
    return x.numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drain(eng, max_steps=96):
    for _ in range(max_steps):
        eng.step()
        if not eng.active.any() and all(r is None or r.prefill_done for r in eng.slots):
            return
    raise AssertionError("engine never drained")


def _acct(eng):
    st = eng.stats
    return {"prefills": st["prefills"], "prefill_tokens": st["prefill_tokens"],
            "prefill_chunks": st["prefill_chunks"],
            "prefix": dict(eng.cache.prefix.stats), "spill": dict(eng.cache.spill.stats),
            "cache": eng.cache.stats()}


def _serve(eng, prompt, obs, logits):
    """Admit, drain, record the row (hit, table, tokens), release."""
    slot = eng.admit(prompt, MAX_NEW)
    row = eng.slots[slot]
    if row.prefill_done:
        logits.append(_logits(eng, slot))
    _drain(eng)
    obs.append((row.prefix_hit, list(row.table), list(row.tokens)))
    eng.release(slot)
    obs.append(_acct(eng))
    return row.tokens


def case_hit_prefills_only_suffix(eng, obs, logits):
    _serve(eng, LONG_A, obs, logits)
    obs.append(eng.cache.prefix.cached_blocks())
    _serve(eng, LONG_B, obs, logits)
    _serve(eng, LONG_A, obs, logits)  # a full-prompt hit: plen - 1


def case_cow_keeps_cached_block(eng, obs, logits):
    _serve(eng, LONG_A, obs, logits)
    s1 = eng.admit(LONG_B, MAX_NEW)  # diverges inside the partial tail block
    s2 = eng.admit(MID, MAX_NEW)     # diverges inside a full block
    logits += [_logits(eng, s1), _logits(eng, s2)]
    # the cached originals the two rows copied, before they decode
    srcs = [eng.cache.prefix.match(p)[1][0] for p in (LONG_B, MID)]
    before = [np.asarray(eng.pools.k[:, b]).copy() for b in srcs]
    obs.append((eng.slots[s1].prefix_hit, eng.slots[s2].prefix_hit,
                list(eng.slots[s1].table), list(eng.slots[s2].table), srcs))
    _drain(eng)
    after = [np.asarray(eng.pools.k[:, b]).copy() for b in srcs]
    assert all(x.tobytes() == y.tobytes() for x, y in zip(before, after))
    obs.append((list(eng.slots[s1].tokens), list(eng.slots[s2].tokens)))
    eng.release(s1)
    eng.release(s2)
    obs.append(_acct(eng))
    _serve(eng, LONG_A, obs, logits)  # the cached blocks are unmodified


def case_shared_blocks_counted_once(eng, obs, logits):
    _serve(eng, LONG_A, obs, logits)
    s1 = eng.admit(LONG_A, MAX_NEW)
    s2 = eng.admit(LONG_A, MAX_NEW)
    used = eng.cache.stats()["kv_blocks_used"]
    obs.append((used, eng.cache.prefix.cached_blocks(), list(eng.slots[s1].table),
                list(eng.slots[s2].table)))
    # physical: the cached blocks once, plus each row's private blocks (its
    # COW copy and its decode room) past the 4 full blocks it shares
    assert used == eng.cache.prefix.cached_blocks() + 2 * (len(eng.slots[s1].table) - 4)
    _drain(eng)
    obs.append((list(eng.slots[s1].tokens), list(eng.slots[s2].tokens)))
    eng.release(s1)
    eng.release(s2)
    obs.append(_acct(eng))


def case_chunked_interleaves_with_decode(eng, obs, logits):
    s0 = eng.admit(SHORT, MAX_NEW)
    logits.append(_logits(eng, s0))
    eng.step()
    pos = int(eng.positions[s0])
    sc = eng.admit(LONG_C, MAX_NEW)  # mid-prefill on return
    obs.append((eng.slots[sc].prefill_done, bool(eng.active[sc]), eng.slots[sc].chunk,
                eng.stats["prefill_chunks"]))
    eng.step()  # one chunk of C and one decode step of row 0
    assert int(eng.positions[s0]) == pos + 1
    obs.append((int(eng.positions[sc]), eng.stats["prefill_chunks"]))
    _drain(eng)
    obs.append((list(eng.slots[s0].tokens), list(eng.slots[sc].tokens)))
    eng.release(s0)
    eng.release(sc)
    obs.append(_acct(eng))


def case_chunk_and_hit_suffix_only(eng, obs, logits):
    _serve(eng, LONG_C, obs, logits)
    _serve(eng, EXT_C, obs, logits)


def case_arena_reset_empties_cache(eng, obs, logits):
    _serve(eng, LONG_A, obs, logits)
    obs.append((eng.reset(), eng.cache.prefix.cached_blocks(), eng.cache.stats()))
    _serve(eng, LONG_A, obs, logits)  # an honest miss


def case_pressure_evicts_cache_not_live_blocks(eng, obs, logits):
    _serve(eng, LONG_A, obs, logits)
    sb = eng.admit(LONG_A, MAX_NEW)  # holds references on the shared blocks
    eng.step()
    big = [int(x) for x in np.random.default_rng(11).integers(1, 95, 52)]
    sc = eng.admit(big, MAX_NEW)  # 8 blocks: only after evicting the unshared cached block
    assert eng.cache.prefix.stats["evictions"] >= 1
    obs.append((list(eng.slots[sb].table), list(eng.slots[sc].table), _acct(eng)))
    _drain(eng)
    obs.append((list(eng.slots[sb].tokens), list(eng.slots[sc].tokens)))
    eng.release(sb)
    eng.release(sc)
    obs.append(_acct(eng))


def case_spec_with_rows_mid_prefill(eng, obs, logits):
    """Speculative steps (draft_k 3) while a chunked prompt streams in and
    a prefix hit's suffix runs: the verify chunk skips the mid-prefill
    rows, whose drafts and commits start once their last chunk lands."""
    s0 = eng.admit(LONG_A, MAX_NEW)
    eng.step()
    sc = eng.admit(LONG_C, MAX_NEW)
    obs.append((bool(eng.active[sc]), int(eng.positions[s0])))
    eng.step()
    obs.append((bool(eng.active[sc]), int(eng.positions[sc]), int(eng.positions[s0])))
    _drain(eng)
    obs.append((list(eng.slots[s0].tokens), list(eng.slots[sc].tokens),
                eng.stats["spec_proposed"], eng.stats["spec_accepted"]))
    eng.release(s0)
    eng.release(sc)
    _serve(eng, LONG_B, obs, logits)


def case_spill_readmit(eng, obs, logits):
    for p in (A1, B1, A2):
        _serve(eng, p, obs, logits)
    obs.append((len(eng.cache.spill), eng.cache.spill.bytes_used() > 0))


ENGINE_CASES = {
    "hit_prefills_only_suffix": (case_hit_prefills_only_suffix,
                                 dict(prefix_cache_blocks=32)),
    "cow_keeps_cached_block": (case_cow_keeps_cached_block, dict(prefix_cache_blocks=32)),
    "shared_blocks_counted_once": (case_shared_blocks_counted_once,
                                   dict(prefix_cache_blocks=32)),
    "chunked_interleaves_with_decode": (case_chunked_interleaves_with_decode,
                                        dict(prefill_chunk=16)),
    "chunk_and_hit_suffix_only": (case_chunk_and_hit_suffix_only,
                                  dict(prefix_cache_blocks=32, prefill_chunk=16)),
    "arena_reset_empties_cache": (case_arena_reset_empties_cache,
                                  dict(prefix_cache_blocks=32)),
    "pressure_evicts_cache_not_live_blocks": (case_pressure_evicts_cache_not_live_blocks,
                                              dict(num_blocks=15, prefix_cache_blocks=15)),
    "spill_readmit": (case_spill_readmit, dict(prefix_cache_blocks=1,
                                               prefix_spill_bytes=64 << 20)),
    "spec_with_rows_mid_prefill": (case_spec_with_rows_mid_prefill,
                                   dict(prefix_cache_blocks=32, prefill_chunk=16, spec=3)),
}


def _run_case(engine_cls, server, name, kv_dtype):
    case, kw = ENGINE_CASES[name]
    if "spec" in kw:  # each package's own SpecConfig
        mod = jax_spec if engine_cls is JaxEngine else pt_spec
        kw = {**kw, "spec": mod.SpecConfig(draft_k=kw["spec"])}
    # 8 rows: the JAX engine rounds its capacity up to the test mesh's 8 devices
    eng = engine_cls(server, max_batch=8, block=BLK, kv_dtype=kv_dtype, **kw)
    obs, logits = [], []
    case(eng, obs, logits)
    return eng, obs, logits


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_matches_jax_engine(servers, name, kv_dtype):
    """Greedy tokens, block tables, prefix hits and the prefix, spill,
    chunk and shape accounting of the port's engine equal the JAX
    engine's; logits within 1e-4; with float32 pools the tokens also
    equal the coalescing path's."""
    jserver, pserver = servers
    _, want, want_logits = _run_case(JaxEngine, jserver, name, kv_dtype)
    before = decode_attention.COUNTS["paged_plain"]
    eng, got, got_logits = _run_case(PagedDecodeEngine, pserver, name, kv_dtype)
    assert got == want
    assert len(got_logits) == len(want_logits) > 0
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert decode_attention.COUNTS["paged_plain"] > before
    assert eng.cache.stats()["kv_blocks_used"] == eng.cache.prefix.cached_blocks()


def test_engine_reuse_accounting(servers):
    """What the reuse shows, on the port alone: a hit prefills only the
    suffix (a full-prompt hit one token), chunking counts only computed
    tokens, a spill comes back as a readmit, and every answer equals the
    coalescing path's."""
    _, pserver = servers
    eng, obs, _ = _run_case(PagedDecodeEngine, pserver, "hit_prefills_only_suffix", "")
    (hit_a, _, tok_a), acct_a, cached, (hit_b, _, tok_b), acct_b, (hit_a2, _, tok_a2), acct_a2 = obs
    assert cached == 5 and hit_a == 0 and hit_b == 36 and hit_a2 == len(LONG_A) - 1
    assert acct_b["prefill_tokens"] - acct_a["prefill_tokens"] == len(LONG_B) - 36
    assert acct_a2["prefill_tokens"] - acct_b["prefill_tokens"] == 1
    assert acct_a2["prefix"]["hits"] == 2 and acct_a2["prefix"]["hit_tokens"] == 36 + 39
    assert tok_a == tok_a2 == _ref(pserver, LONG_A) and tok_b == _ref(pserver, LONG_B)

    eng, obs, _ = _run_case(PagedDecodeEngine, pserver, "chunked_interleaves_with_decode", "")
    # LONG_C's 4 chunks: the first in admit, the other 3 each in a step
    # beside the short row's decode step
    assert eng.stats["interleaved_chunks"] == 3 and obs[-1]["prefill_chunks"] == 5
    assert list(obs[2]) == [_ref(pserver, SHORT), _ref(pserver, LONG_C)]

    eng, obs, _ = _run_case(PagedDecodeEngine, pserver, "chunk_and_hit_suffix_only", "")
    (_, _, tok_c), acct_c, (hit_e, _, tok_e), acct_e = obs
    assert acct_c["prefill_chunks"] == 4 and acct_c["prefill_tokens"] == len(LONG_C)
    assert hit_e == 64 and acct_e["prefill_tokens"] - acct_c["prefill_tokens"] == 8
    assert tok_c == _ref(pserver, LONG_C) and tok_e == _ref(pserver, EXT_C)

    eng, obs, _ = _run_case(PagedDecodeEngine, pserver, "spill_readmit", "")
    acct = obs[5]
    assert acct["spill"]["spills"] >= 1 and acct["spill"]["readmits"] == 1
    assert obs[4][0] == BLK and acct["prefill_tokens"] - obs[3]["prefill_tokens"] == 2
    assert [obs[i][2] for i in (0, 2, 4)] == [_ref(pserver, p) for p in (A1, B1, A2)]


def test_spill_crc_discard_recomputes(servers):
    """A host copy altered after the spill is discarded at the readmit
    (counted), and the request recomputes its whole prompt with the same
    tokens."""
    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=4, block=BLK, prefix_cache_blocks=1,
                            prefix_spill_bytes=64 << 20)
    obs, logits = [], []
    _serve(eng, A1, obs, logits)
    _serve(eng, B1, obs, logits)
    (key, entry), = eng.cache.spill._entries.items()
    assert key == tuple(PFX_A) and isinstance(entry["arrays"]["k"], torch.Tensor)
    torn = entry["arrays"]["k"].clone()
    torn.view(-1)[0] += 1.0
    entry["arrays"]["k"] = torn
    t0, d0 = eng.stats["prefill_tokens"], eng.cache.spill.stats["discards"]
    assert _serve(eng, A2, obs, logits) == _ref(pserver, A2)
    assert eng.cache.spill.stats["discards"] == d0 + 1
    assert eng.cache.spill.stats["readmits"] == 0
    assert eng.stats["prefill_tokens"] - t0 == len(A2) and obs[-2][0] == 0


def test_spill_readmit_restores_the_blocks_bitwise(servers):
    """The readmitted block holds the evicted block's K/V bit for bit
    (int8 pools: the payload and both scale planes)."""
    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=4, block=BLK, kv_dtype="int8",
                            prefix_cache_blocks=1, prefix_spill_bytes=64 << 20)
    obs, logits = [], []
    _serve(eng, A1, obs, logits)
    (blk,) = eng.cache.prefix.match(A2)[0]
    saved = pt_gen.gather_kv_blocks(eng.pools, [blk])
    assert set(saved) == {"k", "v", "k_scale", "v_scale"}
    _serve(eng, B1, obs, logits)
    slot = eng.admit(A2, MAX_NEW)
    new_blk = eng.slots[slot].table[0]
    assert eng.slots[slot].prefix_hit == BLK and eng.cache.spill.stats["readmits"] == 1
    back = pt_gen.gather_kv_blocks(eng.pools, [new_blk])
    assert all(torch.equal(back[n], saved[n]) for n in saved)
    with pytest.raises(ValueError, match="dtype"):
        pt_gen.scatter_kv_blocks(eng.pools, [new_blk],
                                 {**saved, "k": saved["k"].to(torch.float32)})
    with pytest.raises(ValueError, match="shape"):
        pt_gen.scatter_kv_blocks(eng.pools, [new_blk, 1], saved)
    with pytest.raises(ValueError, match="arrays"):
        pt_gen.scatter_kv_blocks(eng.pools, [new_blk], {"k": saved["k"], "v": saved["v"]})
    _drain(eng)
    eng.release(slot)


# ---------------------------------------------------------------------------
# n_valid: a padded tail chunk's pad slots go to the null block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunk_pads_never_touch_the_rows_blocks(servers, kv_dtype):
    """A 16-wide chunk of 4 real tokens at slot 8 of a two-block row: its
    pads at slots 16-23 would wrap (the table clamp) onto the row's real
    slots 8-11.  With ``n_valid`` they go to the null block: the row's
    blocks and the last real token's logits equal the JAX function's, and
    NaN in the null block changes neither (bitwise)."""
    jserver, pserver = servers
    cfg = pserver.module.config
    nb, table, pos, take = 6, [3, 5], 8, 4
    rng = np.random.default_rng(5)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :take] = rng.integers(1, 95, take)
    prior = rng.standard_normal((cfg.num_layers, nb, cfg.num_attention_heads, BLK,
                                 cfg.head_dim)).astype(np.float32)

    def port_run(null_fill):
        pools = pt_gen.init_paged_pools(cfg, nb, BLK, torch.device("cpu"), kv_dtype=kv_dtype)
        if kv_dtype == "int8":
            pools.k[:], pools.k_scale[:] = decode_attention.quantize_kv(torch.from_numpy(prior))
            pools.v[:], pools.v_scale[:] = decode_attention.quantize_kv(torch.from_numpy(prior))
            pools.k_scale[:, 0] = null_fill
            pools.v_scale[:, 0] = null_fill
        else:
            pools.k[:] = torch.from_numpy(prior)
            pools.v[:] = torch.from_numpy(prior)
            pools.k[:, 0] = null_fill
            pools.v[:, 0] = null_fill
        with torch.inference_mode():
            last = pt_gen.paged_chunk_prefill(
                pserver.model, torch.from_numpy(toks).long(), pools,
                torch.tensor([table], dtype=torch.int32), torch.tensor([pos], dtype=torch.int32),
                torch.tensor([take], dtype=torch.int32), take - 1)
        return last, pools

    last, pools = port_run(0.0)
    last_nan, pools_nan = port_run(float("nan"))
    assert torch.equal(last, last_nan) and bool(torch.isfinite(last).all())
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(pools, name) is not None:
            assert torch.equal(getattr(pools, name)[:, table], getattr(pools_nan, name)[:, table])

    jpools = jax_gen.init_paged_pools(jserver.module.config, nb, BLK, kv_dtype=kv_dtype)
    if kv_dtype == "int8":
        kq, ks = jax_gen.quantize_kv(jnp.asarray(prior))
        jpools = jax_gen.PagedPools(kq, kq, ks, ks)
    else:
        jpools = jax_gen.PagedPools(jnp.asarray(prior), jnp.asarray(prior))
    jpools, jlast = jax_gen.paged_chunk_prefill(
        jserver.params, jnp.asarray(toks), jpools, jnp.asarray(table, jnp.int32),
        jnp.int32(pos), jnp.int32(take), jnp.int32(take - 1), jserver.module.config)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4, rtol=0)
    tol = 1 if kv_dtype == "int8" else 1e-5  # int8: one quantization step at a tie
    for name in ("k", "v"):
        got = getattr(pools, name)[:, table].float().numpy()
        want = np.asarray(getattr(jpools, name)[:, np.asarray(table)]).astype(np.float32)
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the row's own slots past its real tokens keep what they held; without
    # n_valid the pads land there (and wrap onto the real slots 8-11)
    fresh, _ = port_run(0.0)
    kept = pools.k[:, 5, :, take:].clone()
    assert torch.equal(kept, fresh_k := port_run(0.0)[1].k[:, 5, :, take:])
    bare = port_run(0.0)[1]
    with torch.inference_mode():
        pt_gen.paged_forward_step(
            pserver.model, torch.from_numpy(toks).long(), bare,
            torch.tensor([table], dtype=torch.int32), torch.tensor([pos], dtype=torch.int32),
            torch.ones((1,), dtype=torch.bool))
    assert not torch.equal(bare.k[:, 5, :, take:], fresh_k)


def test_engine_with_nan_in_the_null_block(servers):
    """NaN in the whole null block before traffic: a chunked prompt and a
    prefix hit's suffix (both with pad slots) next to a decoding row give
    the coalescing path's tokens: no real query reads the null block."""
    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=4, block=BLK, prefix_cache_blocks=32,
                            prefill_chunk=16)
    for pool in (eng.pools.k, eng.pools.v):
        pool[:, 0] = float("nan")
    s0 = eng.admit(SHORT, MAX_NEW)
    s1 = eng.admit(LONG_B[:27], MAX_NEW)  # 27 tokens: a 16 chunk and an 11-of-16 one
    _drain(eng)
    got = [list(eng.slots[s].tokens) for s in (s0, s1)]
    eng.release(s0)
    eng.release(s1)
    s2 = eng.admit(LONG_B[:27] + [7, 9, 11], MAX_NEW)  # hit 27, a 3-of-16 suffix chunk
    assert eng.slots[s2].prefix_hit == 27
    _drain(eng)
    got.append(list(eng.slots[s2].tokens))
    assert got == [_ref(pserver, p) for p in (SHORT, LONG_B[:27], LONG_B[:27] + [7, 9, 11])]


# ---------------------------------------------------------------------------
# the engine's validation and the scheduler
# ---------------------------------------------------------------------------


def test_engine_validates_reuse_knobs_as_jax(servers):
    jserver, pserver = servers
    for kw in ({"prefill_chunk": 12}, {"prefill_chunk": 4}, {"prefix_cache_blocks": -1},
               {"prefix_spill_bytes": 1}):
        with pytest.raises(ValueError) as want:
            JaxEngine(jserver, block=BLK, **kw)
        with pytest.raises(ValueError) as got:
            PagedDecodeEngine(pserver, block=BLK, **kw)
        assert str(got.value) == str(want.value)


def test_scheduler_reports_reuse_and_admits_over_reclaimable_blocks(servers):
    """The scheduler counts cached blocks only the index holds as room
    (an arena full of cached prefixes still admits), and serving_stats
    carries the prefix, spill and chunk counters."""
    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=2, block=BLK, num_blocks=8,
                            prefix_cache_blocks=8, prefill_chunk=16)
    sched = ContinuousScheduler(eng, max_depth=8)
    fut = sched.submit([LONG_A[:20]], 4, deadline_s=60)
    while not fut.done():
        sched._iterate()
    assert eng.cache.allocator.free_count() < 5 <= eng.cache.available_blocks()
    fut2 = sched.submit([LONG_C[:30]], 4, deadline_s=60)
    sched._iterate()
    assert any(r is not None for r in eng.slots)  # admitted over the cached blocks
    while not fut2.done():
        sched._iterate()
    assert fut.result()[0] == pserver.generate_ids([LONG_A[:20]], max_dec_len=4)[0]
    assert fut2.result()[0] == pserver.generate_ids([LONG_C[:30]], max_dec_len=4)[0]
    st = sched.serving_stats()
    assert st["prefix"]["evictions"] >= 1 and st["prefix"]["misses"] == 2
    assert st["prefill_chunks"] == 4 and st["prefill_tokens"] == 50
    assert set(st["spill"]) == {"spills", "readmits", "discards"}
    assert st["prefix_cached_blocks"] == eng.cache.prefix.cached_blocks()
    with pytest.raises(ValueError, match="continuous"):
        build_scheduler(pserver, "coalesce", queue_depth=4, max_coalesce=4, prefill_chunk=16)
    sched2 = build_scheduler(pserver, "continuous", queue_depth=4, max_coalesce=4, cb_batch=2,
                             prefill_chunk=16, prefix_cache_blocks=4, prefix_spill_bytes=1024)
    assert (sched2.engine.prefill_chunk, sched2.engine.cache.prefix.budget,
            sched2.engine.cache.spill.budget) == (16, 4, 1024)


# ---------------------------------------------------------------------------
# the serve CLI with the three flags, over HTTP
# ---------------------------------------------------------------------------


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
        return json.load(r)


def test_cli_prefix_chunk_and_spill_over_http(tmp_path):
    """``--scheduler continuous --prefill-chunk 16 --prefix-cache-blocks 1
    --prefix-spill-bytes``: A, B, A served one after another hit, spill
    and readmit; /healthz shows it, and every answer equals an
    in-process coalescing server's on the same seed."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({k: TINY[k] for k in PORT_SECTIONS}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", PFX_KV_BLOCK=str(BLK))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", str(cfg_path),
         "--port", str(port), "--device", "cpu", "--scheduler", "continuous",
         "--cb-batch", "2", "--prefill-chunk", "16", "--prefix-cache-blocks", "1",
         "--prefix-spill-bytes", str(64 << 20)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    out_lines = []
    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        deadline = time.time() + 120
        health = None
        while time.time() < deadline and health is None:
            try:
                health = _healthz(port)
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"server died: {''.join(out_lines)[-2000:]}")
                time.sleep(0.3)
        assert health and health["ok"], health
        serving0 = health["serving"]
        cfg = _port_cfg()
        module = GPTModule(cfg)
        ref = GenerationServer(cfg, module, module.init_model(cfg.Global.seed, "cpu"),
                               torch.device("cpu"))
        for p in (A1, B1, A2):
            got = _post(port, {"prompt_ids": p, "max_tokens": MAX_NEW})["completion_ids"]
            assert got == ref.generate_ids([p], max_dec_len=MAX_NEW)[0]
        serving = _healthz(port)["serving"]
        assert serving["prefix"]["hits"] - serving0["prefix"]["hits"] == 1
        assert serving["spill"]["spills"] >= 1 and serving["spill"]["readmits"] == 1
        assert serving["prefill_chunks"] - serving0["prefill_chunks"] == 3
        assert serving["prefill_tokens"] - serving0["prefill_tokens"] == \
            len(A1) + len(B1) + len(A2) - BLK
        assert serving["prefix_cached_blocks"] == 1 and serving["prefix_spill_entries"] >= 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        reader.join(timeout=10)
        assert "drained cleanly" in "".join(out_lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
