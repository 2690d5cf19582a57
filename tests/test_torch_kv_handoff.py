"""PyTorch port: the PFXH1 KV-handoff codec, the engine's export and
adoption, the scheduler's handoff admission and prefix migration, against
the JAX package on the CPU.

  - the codec writes the JAX codec's bytes (float32, int8) and round-trips
    float32, bfloat16 and int8 with scales bit for bit; it refuses a bad
    magic, a truncation at every section boundary, trailing bytes and a
    malformed meta field by name, as the JAX codec does;
  - a JAX prefill adopted by the port, and a port prefill adopted by JAX,
    decode greedy tokens identical to the JAX engine's own ``admit``, with
    native (float32) and int8 KV; the two packages' exported arrays agree
    at 2e-5 (int8 values and scales exactly);
  - the port's export/adopt equals its own ``admit``; an incompatible
    payload is refused with the arena untouched; ``submit_handoff`` runs
    end to end; a prefix-hit export computes only its suffix (the JAX
    engine's ``prefill_tokens``); ``export_hot_prefixes`` /
    ``adopt_prefixes`` move the JAX engine's prefixes and block counts;
  - a bfloat16 arena's payload (the ``<V2`` wire type) adopts bit for bit
    into a bfloat16 arena and is refused by a float32 one.

The model is the TINY serving config of tests/test_kv_tier.py (vocab 96, 2
layers, hidden 32, float32); weights come from the JAX initializer,
perturbed, and cross to the port through the bridge.
"""

import copy
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.core import paged_cache as jax_pc
from paddlefleetx_tpu.core.continuous_batching import PagedDecodeEngine as JaxEngine
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
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
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.models.gpt.generation import gather_kv_blocks
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

BLK = 8
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
MAX_NEW = 6
ATOL = 2e-5


def _port_cfg(model=None):
    cfg = {k: v for k, v in copy.deepcopy(TINY).items() if k in PORT_SECTIONS}
    cfg["Model"].update(model or {})
    return process_configs(AttrDict.from_nested(cfg))


@pytest.fixture(scope="module")
def servers():
    """(JAX GenerationServer, port GenerationServer) on the same weights."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k != "module"}
    jparams = jax_model.init(JaxGPTConfig(**model_kw), jax.random.key(0))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), jparams)
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(TINY)),
                              num_devices=jax.device_count())
    jserver = JaxServer(cfg, init_dist_env(cfg), build_module(cfg),
                        params=jax.tree.map(jnp.asarray, tree))
    pcfg = _port_cfg()
    module = GPTModule(pcfg)
    return jserver, GenerationServer(pcfg, module, params_from_jax(module.config, tree),
                                     torch.device("cpu"))


def _engines(servers, **kw):
    kw = {"max_batch": 4, "block": BLK, **kw}
    return JaxEngine(servers[0], **kw), PagedDecodeEngine(servers[1], **kw)


def _drain(eng, max_steps=64):
    """Step until no row is active; return each slot's tokens."""
    for _ in range(max_steps):
        eng.step()
        if not eng.active.any():
            return {i: list(r.tokens) for i, r in enumerate(eng.slots) if r is not None}
    raise AssertionError("engine never drained")


def _admit_tokens(eng, prompt):
    slot = eng.admit(prompt, MAX_NEW)
    while not eng.slots[slot].prefill_done:
        eng.step()
    toks = _drain(eng)[slot]
    eng.release(slot)
    return toks


def _adopt_tokens(eng, meta, arrays):
    slot = eng.adopt(meta, arrays)
    toks = _drain(eng)[slot]
    eng.release(slot)
    return toks


def _np(arrays):
    """Payload arrays as numpy (port exports hold CPU tensors)."""
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _codec_arrays(rng, kind):
    if kind == "float32":
        return {"k": rng.standard_normal((2, 3, 4, 8, 16)).astype(np.float32),
                "v": rng.standard_normal((2, 3, 4, 8, 16)).astype(np.float32)}
    if kind == "int8":
        return {"k": rng.integers(-127, 128, (2, 3, 4, 8, 16)).astype(np.int8),
                "v": rng.integers(-127, 128, (2, 3, 4, 8, 16)).astype(np.int8),
                "k_scale": rng.random((2, 3, 4, 8)).astype(np.float32),
                "v_scale": rng.random((2, 3, 4, 8)).astype(np.float32)}
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 8, 16)).astype(np.float32))
    return {"k": x.bfloat16(), "v": (-x).bfloat16()}


@pytest.mark.parametrize("kind", ["float32", "bf16", "int8"])
def test_codec_round_trip_is_bit_exact(kind):
    rng = np.random.default_rng(0)
    arrays = _codec_arrays(rng, kind)
    arrays["logits"] = rng.standard_normal((96,)).astype(np.float32)
    arrays["counts"] = rng.integers(0, 5, (96,)).astype(np.int32)
    meta = {"prompt_ids": [1, 2, 3], "prompt_len": 3, "max_new": 6, "block": 8,
            "kv_dtype": "int8" if kind == "int8" else "bf16", "pool_sig": [2, 4, 8, 16]}
    payload = pt_pc.pack_handoff(meta, arrays)
    meta2, got = pt_pc.unpack_handoff(payload)
    assert meta2 == meta and list(got) == list(arrays)
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):  # bfloat16: the <V2 wire type, read back as bits
            assert got[name].dtype.str == "|V2" and got[name].shape == tuple(a.shape)
            assert torch.equal(pt_pc.handoff_tensor(got[name], torch.bfloat16), a)
        else:
            assert got[name].dtype == a.dtype and got[name].tobytes() == a.tobytes()
    # the JAX codec reads the port's payload to the same bytes (a bfloat16
    # array as the same 2-byte void words)
    jmeta, jgot = jax_pc.unpack_handoff(payload)
    assert jmeta == meta
    for name in arrays:
        assert jgot[name].tobytes() == got[name].tobytes()


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_codec_bytes_equal_the_jax_codec(kind):
    rng = np.random.default_rng(1)
    arrays = _codec_arrays(rng, kind)
    arrays["logits"] = rng.standard_normal((96,)).astype(np.float32)
    meta = {"prompt_ids": [4, 5], "prompt_len": 2, "max_new": 3, "block": 8,
            "kv_dtype": kind.replace("float32", "bf16"), "pool_sig": [2, 4, 8, 16]}
    want = jax_pc.pack_handoff(meta, arrays)
    assert pt_pc.pack_handoff(meta, arrays) == want
    # CPU tensors pack to the same bytes as their numpy arrays
    assert pt_pc.pack_handoff(meta, {k: torch.from_numpy(v) for k, v in arrays.items()}) == want


def test_codec_refuses_what_the_jax_codec_refuses():
    """A bad magic, a cut at every section boundary (inside the magic, the
    length word, the header, between and inside arrays), trailing bytes:
    both codecs raise ValueError, the port's naming the same fault."""
    arrays = {"k": np.arange(12, dtype=np.float32).reshape(3, 4),
              "v": np.arange(6, dtype=np.int8)}
    payload = pt_pc.pack_handoff({"block": 8}, arrays)
    (hlen,) = struct.unpack("<I", payload[5:9])
    body = 9 + hlen
    cuts = {3: "magic", 5: "header length", 7: "header length", 9: "header", body - 1: "header",
            body: "array 'k'", body + 20: "array 'k'", body + 48: "array 'v'",
            len(payload) - 1: "array 'v'"}
    for cut, what in cuts.items():
        for codec in (pt_pc, jax_pc):
            with pytest.raises(ValueError) as err:
                codec.unpack_handoff(payload[:cut])
        msg = str(err.value)
        assert ("truncated" in msg or "magic" in msg) and (
            what.split()[-1].strip("'") in msg or what in ("magic", "header", "header length")), \
            (cut, msg)
    for bad, want in ((b"NOPE1" + payload[5:], "magic"), (payload + b"xx", "trailing")):
        for codec in (pt_pc, jax_pc):
            with pytest.raises(ValueError, match=want):
                codec.unpack_handoff(bad)
    # a header that is not JSON, and a void width other than bfloat16's
    torn = payload[:9] + b"{" * hlen + payload[body:]
    with pytest.raises(ValueError, match="corrupt KV-handoff header"):
        pt_pc.unpack_handoff(torn)
    odd = pt_pc.pack_handoff({}, {"k": np.zeros(2, dtype="V4")})
    with pytest.raises(ValueError, match="void dtype"):
        pt_pc.unpack_handoff(odd)


@pytest.mark.parametrize("meta,named", [
    ({"block": "x", "kv_dtype": "bf16", "pool_sig": [2, 4, 8, 8]}, "block size 'x'"),
    ({"block": 16, "kv_dtype": "bf16", "pool_sig": [2, 4, 8, 8]}, "block size 16"),
    ({"block": 8, "kv_dtype": "int8", "pool_sig": [2, 4, 8, 8]}, "kv dtype 'int8'"),
    ({"block": 8, "kv_dtype": "bf16", "pool_sig": [{"a": 1}]}, "pool_sig"),
    ({"block": 8, "kv_dtype": "bf16", "pool_sig": [2, 4, 8, 16]}, "pool shape"),
])
def test_check_handoff_meta_names_each_field(meta, named):
    kw = {"block": 8, "kv_dtype": "bf16", "pool_sig": [2, 4, 8, 8]}
    with pytest.raises(ValueError) as want:
        jax_pc.check_handoff_meta(meta, **kw)
    with pytest.raises(ValueError) as got:
        pt_pc.check_handoff_meta(meta, **kw)
    assert str(got.value) == str(want.value) and named in str(got.value)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_exports_cross_between_the_packages(servers, kv_dtype):
    """JAX prefill -> port adopt and port prefill -> JAX adopt decode the
    JAX engine's own admit tokens; the exported payloads agree (float32 at
    2e-5, int8 values and scales exactly) and pack to the same layout."""
    jeng, peng = _engines(servers, kv_dtype=kv_dtype)
    for prompt in PROMPTS[:3]:
        want = _admit_tokens(jeng, prompt)
        jmeta, jarr = jeng.prefill_export(prompt, MAX_NEW)
        pmeta, parr = peng.prefill_export(prompt, MAX_NEW)
        assert pmeta == jmeta
        pnp, jnp_ = _np(parr), {k: np.asarray(v) for k, v in jarr.items()}
        assert list(pnp) == list(jnp_)
        for name in jnp_:
            assert pnp[name].dtype == jnp_[name].dtype and pnp[name].shape == jnp_[name].shape
            if name in ("k", "v") and kv_dtype == "int8":
                np.testing.assert_array_equal(pnp[name], jnp_[name])
            elif name == "counts":
                np.testing.assert_array_equal(pnp[name], jnp_[name])
            else:
                np.testing.assert_allclose(pnp[name], jnp_[name], atol=ATOL, rtol=0)
        # over the wire: each side packs, the other unpacks and adopts
        to_port = pt_pc.unpack_handoff(jax_pc.pack_handoff(jmeta, jarr))
        to_jax = jax_pc.unpack_handoff(pt_pc.pack_handoff(pmeta, parr))
        assert _adopt_tokens(peng, *to_port) == want
        assert _adopt_tokens(jeng, *to_jax) == want
        assert len(pt_pc.pack_handoff(pmeta, parr)) == len(jax_pc.pack_handoff(jmeta, jarr))
    assert peng.stats["exports"] == jeng.stats["exports"] == 3
    assert peng.stats["adopts"] == jeng.stats["adopts"] == 3
    assert peng.cache.stats()["kv_blocks_used"] == 0


# ---------------------------------------------------------------------------
# the port's engine and scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_export_adopt_equals_admit_and_blocks_survive(servers, kv_dtype):
    """Export on one port engine, adopt on another: the admit tokens, and
    the blocks and scales bitwise equal in the adopting arena."""
    _, pserver = servers
    src = PagedDecodeEngine(pserver, max_batch=4, block=BLK, kv_dtype=kv_dtype)
    dst = PagedDecodeEngine(pserver, max_batch=4, block=BLK, kv_dtype=kv_dtype)
    for prompt in PROMPTS:
        want = _admit_tokens(src, prompt)
        meta, arrays = pt_pc.unpack_handoff(pt_pc.pack_handoff(*src.prefill_export(prompt,
                                                                                   MAX_NEW)))
        slot = dst.adopt(meta, arrays)
        back = gather_kv_blocks(dst.pools, dst.slots[slot].table[: arrays["k"].shape[1]])
        for name, t in back.items():
            assert t.numpy().tobytes() == np.ascontiguousarray(arrays[name]).tobytes(), name
        assert _drain(dst)[slot] == want
        dst.release(slot)


def test_adopt_refuses_incompatible_payloads_untouched(servers):
    """A payload of another block size, kv dtype or pool shape, missing an
    array, with a mistyped or misshapen block, or a bfloat16 payload into a
    float32 arena: refused with ValueError, and the arena, the allocator
    and the slots untouched."""
    _, pserver = servers
    src = PagedDecodeEngine(pserver, max_batch=2, block=BLK)
    dst = PagedDecodeEngine(pserver, max_batch=2, block=BLK)
    meta, arrays = src.prefill_export(PROMPTS[1], MAX_NEW)
    arrays = _np(arrays)
    bad = [
        ({**meta, "block": 16}, arrays, "block size"),
        ({**meta, "kv_dtype": "int8"}, arrays, "kv dtype"),
        ({**meta, "pool_sig": [3, 4, 8, 8]}, arrays, "pool shape"),
        ({**meta, "prompt_len": 4}, arrays, "prompt_len"),
        (meta, {k: v for k, v in arrays.items() if k != "v"}, "missing arrays"),
        (meta, {**arrays, "k": arrays["k"][:, :1]}, "does not carry"),
        (meta, {**arrays, "k": arrays["k"].astype(np.float16)}, "dtype"),
        (meta, {**arrays, "logits": arrays["logits"][:5]}, "logits shape"),
        (meta, pt_pc.unpack_handoff(pt_pc.pack_handoff(
            meta, {**arrays, "k": torch.from_numpy(arrays["k"]).bfloat16()}))[1], "bfloat16"),
    ]
    k0, v0 = dst.pools.k.clone(), dst.pools.v.clone()
    for m, a, want in bad:
        with pytest.raises(ValueError, match=want):
            dst.adopt(m, a)
        assert torch.equal(dst.pools.k, k0) and torch.equal(dst.pools.v, v0)
        assert dst.cache.stats()["kv_blocks_used"] == 0 and all(r is None for r in dst.slots)
    sched = ContinuousScheduler(dst, max_depth=2)
    with pytest.raises(ValueError, match="block size"):
        sched.submit_handoff({**meta, "block": 16}, arrays)
    assert sched.depth() == 0


def test_submit_handoff_end_to_end(servers):
    """A port prefill's payloads through ``submit_handoff`` on a running
    scheduler with dispatch-ahead answer the admit tokens; the counters
    move under the JAX names."""
    _, pserver = servers
    src = PagedDecodeEngine(pserver, max_batch=4, block=BLK)
    want = [_admit_tokens(src, p) for p in PROMPTS]
    sched = ContinuousScheduler(PagedDecodeEngine(pserver, max_batch=2, block=BLK),
                                dispatch_ahead=True).start()
    try:
        futs = [sched.submit_handoff(*pt_pc.unpack_handoff(pt_pc.pack_handoff(
            *src.prefill_export(p, MAX_NEW))), deadline_s=60) for p in PROMPTS]
        got = [f.result(timeout=60)[0] for f in futs]
    finally:
        sched.shutdown(timeout=60)
    assert got == want
    assert sched.engine.stats["adopts"] == 4 and sched.stats["prefill_admits"] == 4
    assert sched.engine.cache.stats()["kv_blocks_used"] == 0


def test_prefix_hit_export_computes_only_the_suffix(servers):
    """With the prefix cache on, the second export of a shared prefix maps
    the cached blocks and runs only its suffix: ``prefill_tokens`` and the
    exported payload equal the JAX engine's."""
    shared = list(range(10, 30))
    prompts = [shared + [1, 2, 3], shared + [7, 8, 9, 4, 5]]
    jeng, peng = _engines(servers, prefix_cache_blocks=16)
    for p in prompts:
        jm, ja = jeng.prefill_export(p, MAX_NEW)
        pm, pa = peng.prefill_export(p, MAX_NEW)
        assert pm == jm
        for name, a in _np(pa).items():
            np.testing.assert_allclose(a, np.asarray(ja[name]), atol=ATOL, rtol=0)
    hit = peng.cache.prefix.stats["hit_tokens"]
    assert hit == jeng.cache.prefix.stats["hit_tokens"] == len(shared)
    assert peng.stats["prefill_tokens"] == jeng.stats["prefill_tokens"] == \
        len(prompts[0]) + len(prompts[1]) - hit
    assert peng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"] >= 1
    assert peng.cache.prefix.stats["hits"] == jeng.cache.prefix.stats["hits"] == 1


def test_prefix_migration_matches_jax(servers):
    """``export_hot_prefixes`` on a donor and ``adopt_prefixes`` on a peer:
    the same prefixes and adopted block counts as the JAX engines, a
    re-send adopts nothing, and the adopted prefix is a hit whose tokens
    equal a cold admit's."""
    shared = list(range(40, 64))
    results = []
    for make, srv in ((JaxEngine, servers[0]), (PagedDecodeEngine, servers[1])):
        donor = make(srv, max_batch=2, block=BLK, prefix_cache_blocks=16)
        peer = make(srv, max_batch=2, block=BLK, prefix_cache_blocks=16)
        cold = _admit_tokens(make(srv, max_batch=2, block=BLK), shared + [3, 4])
        _admit_tokens(donor, shared + [1, 2])
        meta, arrays = donor.export_hot_prefixes(4)
        payload = (pt_pc if make is PagedDecodeEngine else jax_pc).pack_handoff(meta, arrays)
        meta, arrays = (pt_pc if make is PagedDecodeEngine else jax_pc).unpack_handoff(payload)
        first = peer.adopt_prefixes(meta, arrays)
        again = peer.adopt_prefixes(meta, arrays)
        hit = _admit_tokens(peer, shared + [3, 4])
        results.append((meta["prefixes"], first, again, peer.stats["migrate_adopted"],
                        peer.cache.prefix.stats["hits"], hit == cold, len(payload)))
    assert results[1] == results[0]
    assert results[1][1] == 3 and results[1][2] == 0 and results[1][4] == 1 and results[1][5]


def test_bf16_arena_round_trip():
    """A bfloat16 model's arena: the export packs its blocks as ``<V2``
    words and a second bfloat16 engine adopts them bit for bit and decodes
    the admit tokens (the JAX codec writes but cannot adopt this type);
    a float32 arena refuses the payload."""
    cfg = _port_cfg({"dtype": "bfloat16"})
    module = GPTModule(cfg)
    srv = GenerationServer(cfg, module, module.init_model(3, "cpu"), torch.device("cpu"))
    src = PagedDecodeEngine(srv, max_batch=2, block=BLK)
    dst = PagedDecodeEngine(srv, max_batch=2, block=BLK)
    assert src.pools.k.dtype == torch.bfloat16
    want = _admit_tokens(src, PROMPTS[1])
    payload = pt_pc.pack_handoff(*src.prefill_export(PROMPTS[1], MAX_NEW))
    meta, arrays = pt_pc.unpack_handoff(payload)
    assert arrays["k"].dtype.str == "|V2"
    slot = dst.adopt(meta, arrays)
    back = gather_kv_blocks(dst.pools, dst.slots[slot].table[: arrays["k"].shape[1]])
    assert back["k"].view(torch.int16).numpy().tobytes() == arrays["k"].tobytes()
    assert _drain(dst)[slot] == want
    dst.release(slot)
    with pytest.raises(ValueError, match="bfloat16"):
        pt_pc.handoff_tensor(arrays["k"], torch.float32, "k")
