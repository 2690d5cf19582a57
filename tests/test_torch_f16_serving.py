"""PyTorch port: serving a float16 model, against the JAX package on the
CPU.

  - the plain float16 K7, K8 and K9 (the CPU spelling of the card's
    float16 routes) against the JAX functions in float16, through their
    Pallas kernels in interpret mode and their lax spelling, at TINY
    shapes, at the sm90 tiles (head dims 64 / 128) and at the route
    boundaries t = 1, 5, 16, 17 and 64.  Tolerance: one float16 rounding of
    p before P.V, which the two sides may place on neighbouring values, is
    at most 2^-10 of max |v| in the output (``F16_P_ROUNDING``), plus 2e-5
    of float32 summation order; int8 caches under float16 q do their math
    in float32 on both sides and are held at 2e-5;
  - the coalescing server and the continuous-batching engine on the TINY
    serving config (tests/test_kv_tier.py's) in float16, against the JAX
    server and engine on the same weights: native and int8 KV, logits
    teacher-forced with the JAX tokens (``F16_LOGITS_TOL``), free-running
    greedy tokens equal wherever every step's top-2 margin clears that
    tolerance (the share is printed), ``draft_k`` 4 with equal accept
    counts, a chunked prefill with a prefix hit, a spill and a readmit
    (blocks bit for bit, the CRC over float16 bytes), a preemption's
    resume;
  - beam search in float16 against the JAX beam search;
  - a ``--device cpu`` serve CLI round trip over a float16 ``step_N``
    written by the port's train CLI at TINY width.
"""

import copy
import dataclasses
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

from paddlefleetx_tpu.core.continuous_batching import PagedDecodeEngine as JaxEngine
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops import decode_attention as jax_da
from paddlefleetx_tpu.ops import speculative as jax_spec
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core import paged_cache as pt_pc
from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as pt_gen
from paddlefleetx_tpu_torch.data import gpt_dataset as gd
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax, params_to_jax
from paddlefleetx_tpu_torch.models.gpt.model import GPTModel
from paddlefleetx_tpu_torch.ops import decode_attention as pt_da
from paddlefleetx_tpu_torch.ops import speculative as pt_spec
from paddlefleetx_tpu_torch.tools.serve import build_server
from paddlefleetx_tpu_torch.utils.checkpoint import load_params_into, restore_params
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs
import test_torch_prefix_cache as pfx  # its engine cases, prompts and drivers

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOL = 2e-5
# one float16 rounding of p (2^-11 of p either side) placed differently by
# the two sides moves sum(p v) / l by at most 2^-10 of max |v|
F16_P_ROUNDING = 2.0**-10


def _f16_tol(kind, v):
    if kind == "int8":
        return TOL
    return F16_P_ROUNDING * float(np.abs(np.asarray(v, np.float32)).max()) + TOL


# ---------------------------------------------------------------------------
# K7 / K8: the plain float16 flash-decode against the JAX decode_attention
# ---------------------------------------------------------------------------

# (b, t, n, d, L, pos, block, kv_valid_from): the TINY model's head dim 8 and
# its block 8, the sm90 route's head dims 64 / 128 at t = 1 (decode), 5
# (draft_k 4's verify chunk), 16 (the split-K kernel's last t), 17 and 64
# (the tensor-core prefill), with left pads that cut a stage or tile
DECODE_CASES = {
    "tiny_decode_block8": (2, 1, 4, 8, 40, 39, 8, None),
    "tiny_prefill_left_pad": (3, 16, 4, 8, 40, 0, 8, [0, 5, 11]),
    "decode_t1_d64": (2, 1, 2, 64, 160, 120, 0, [70, 0]),
    "verify_t5_d64": (2, 5, 2, 64, 160, 95, 0, [3, 40]),
    "verify_t16_d128": (2, 16, 2, 128, 160, 100, 0, [40, 33]),
    "prefill_t17_d64": (2, 17, 2, 64, 160, 100, 0, [70, 0]),
    "prefill_t64_d64_pads": (2, 64, 2, 64, 320, 236, 0, [130, 7]),
    "prefill_t64_d128_pads": (2, 64, 2, 128, 320, 236, 0, [260, 3]),
}


def _decode_inputs(case, kind, seed=0):
    """numpy float16 q (and caches, or int8 caches with float32 scales
    quantized from float16 values)."""
    b, t, n, d, L, pos, block, vf = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, n, d)).astype(np.float16)
    kc = rng.normal(size=(b, n, L, d)).astype(np.float16)
    vc = (rng.normal(size=(b, n, L, d)) * 3.0).astype(np.float16)
    ks = vs = None
    if kind == "int8":
        kq, ks = pt_da.quantize_kv(torch.from_numpy(kc))
        vq, vs = pt_da.quantize_kv(torch.from_numpy(vc))
        kc, vc, ks, vs = kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()
    vf = None if vf is None else np.asarray(vf, np.int32)
    return q, kc, vc, pos, block, vf, ks, vs


def _decode_both(impl, q, kc, vc, pos, block, vf, ks, vs):
    """(port plain, JAX) float32 [b, n, t, d] on the same float16 inputs:
    ``decode_attention_plain`` against ``_decode_pallas`` (interpret) or
    ``_decode_lax``, before either casts back to q's type."""
    b, t, n, d = q.shape
    q_t = np.ascontiguousarray(q.transpose(0, 2, 1, 3))
    limit, scale, L = pos + t, 1.0 / d**0.5, kc.shape[2]
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    c = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    fn = jax_da._decode_pallas if impl == "pallas" else jax_da._decode_lax
    want = np.asarray(fn(j(q_t), j(kc), j(vc), limit, j(vf), jax_da.decode_block(L, block), scale,
                         j(ks), j(vs)), np.float32)
    before = pt_da.COUNTS["plain"]
    got = pt_da.decode_attention_plain(c(q_t), c(kc), c(vc), limit, c(vf),
                                       pt_da.decode_block(L, block), scale, c(ks), c(vs))
    assert pt_da.COUNTS["plain"] == before and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("impl", ["pallas", "lax"])
@pytest.mark.parametrize("kind", ["f16", "int8"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_f16_plain_decode_matches_jax(case, kind, impl):
    """K7 over float16 caches and K8 over int8 caches under float16 q: the
    port's plain version against JAX's Pallas kernel (interpret) and lax
    spelling, float32 outputs."""
    args = _decode_inputs(case, kind)
    got, want = _decode_both(impl, *args)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=_f16_tol(kind, args[2]), rtol=0)


@pytest.mark.parametrize("kind", ["f16", "int8"])
@pytest.mark.parametrize("case", ["tiny_prefill_left_pad", "verify_t5_d64"])
def test_f16_decode_wrapper_matches_jax_in_float16(case, kind):
    """The wrapper generation calls (``flash_decode``'s plain version on
    the CPU, counted in ``plain``): [b, t, n, d] in float16 on both sides,
    which adds one float16 rounding of the output (2^-10 of its largest
    value) to the float32 outputs' tolerance."""
    q, kc, vc, pos, block, vf, ks, vs = _decode_inputs(case, kind)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    c = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    want = np.asarray(jax_da.decode_attention(
        j(q), j(kc), j(vc), jnp.int32(pos), kv_valid_from=j(vf), block=block, impl="lax",
        k_scale=j(ks), v_scale=j(vs)))
    before = pt_da.COUNTS["plain"]
    got = pt_da.decode_attention(c(q), c(kc), c(vc), pos, kv_valid_from=c(vf), block=block,
                                 k_scale=c(ks), v_scale=c(vs))
    assert pt_da.COUNTS["plain"] == before + 1
    assert got.dtype == torch.float16 and want.dtype == np.float16
    want = want.astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_f16_tol(kind, vc) + F16_P_ROUNDING * np.abs(want).max())


# ---------------------------------------------------------------------------
# K9: the plain float16 paged attention against _paged_lax / _paged_pallas
# ---------------------------------------------------------------------------

# (b, n, d, bs, M, positions): TINY's head dim and block, the sm90 route's
# head dims and blocks 8-128, skewed rows over shuffled pool blocks, tables
# null-padded past each row's last needed block at the widest t
PAGED_CASES = {
    "tiny_d8_bs8": (3, 4, 8, 8, 16, [17, 9, 28]),
    "d64_bs16_skew": (4, 2, 64, 16, 16, [0, 150, 31, 100]),
    "d128_bs8_mid_block": (2, 2, 128, 8, 32, [13, 150]),
    "d64_bs128": (2, 2, 64, 128, 4, [300, 3]),
}
PAGED_TS = (1, 5, 16, 17, 64)


def _paged_inputs(case, t, kind, seed=0):
    b, n, d, bs, M, pos = PAGED_CASES[case]
    rng = np.random.default_rng(seed)
    nb = b * M + 1
    k_pool = rng.normal(size=(nb, n, bs, d)).astype(np.float16)
    v_pool = (rng.normal(size=(nb, n, bs, d)) * 3.0).astype(np.float16)
    q_t = rng.normal(size=(b, n, t, d)).astype(np.float16)
    tables = rng.permutation(np.arange(1, nb))[: b * M].reshape(b, M).astype(np.int32)
    for i, p in enumerate(pos):
        tables[i, (p + t - 1) // bs + 1:] = 0
    ks = vs = None
    if kind == "int8":
        kq, ks = pt_da.quantize_kv(torch.from_numpy(k_pool))
        vq, vs = pt_da.quantize_kv(torch.from_numpy(v_pool))
        k_pool, v_pool, ks, vs = kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()
    return q_t, k_pool, v_pool, tables, np.asarray(pos, np.int32), ks, vs


def _paged_both(jax_fn, q_t, k_pool, v_pool, tables, pos, ks, vs):
    """(port plain, JAX) float32 [b, n, t, d] on the same float16 inputs."""
    scale = 1.0 / q_t.shape[-1] ** 0.5
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    c = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    want = np.asarray(jax_fn(j(q_t), j(k_pool), j(v_pool), j(tables), j(pos), scale, j(ks),
                             j(vs)), np.float32)
    got = pt_da.paged_decode_attention_plain(c(q_t), c(k_pool), c(v_pool), c(tables), c(pos),
                                             scale, c(ks), c(vs)).numpy()
    return got, want


@pytest.mark.parametrize("kind", ["f16", "int8"])
@pytest.mark.parametrize("t", PAGED_TS)
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_f16_plain_paged_matches_jax_lax(case, t, kind):
    args = _paged_inputs(case, t, kind)
    got, want = _paged_both(jax_da._paged_lax, *args)
    assert got.shape == want.shape == args[0].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=_f16_tol(kind, args[2]), rtol=0)


@pytest.mark.parametrize("kind", ["f16", "int8"])
@pytest.mark.parametrize("t", [1, 5, 17])
def test_f16_plain_paged_matches_pallas_interpret(t, kind):
    args = _paged_inputs("d64_bs16_skew", t, kind)
    got, want = _paged_both(jax_da._paged_pallas, *args)
    np.testing.assert_allclose(got, want, atol=_f16_tol(kind, args[2]), rtol=0)


def test_f16_paged_wrapper_matches_jax_in_float16():
    """The wrapper the engine calls, [b, t, n, d] in float16 on both sides
    (one float16 rounding of the output more, as the contiguous wrapper's
    test says)."""
    q_t, k_pool, v_pool, tables, pos, _, _ = _paged_inputs("d64_bs16_skew", 5, "f16")
    q = np.ascontiguousarray(q_t.transpose(0, 2, 1, 3))
    want = np.asarray(jax_da.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(tables),
        jnp.asarray(pos), impl="lax"), np.float32)
    got = pt_da.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(tables), torch.from_numpy(pos))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_f16_tol("f16", v_pool) + F16_P_ROUNDING * np.abs(want).max())


@pytest.mark.parametrize("d,t,bs,route", [
    (64, 1, 16, "sm90"), (128, 5, 8, "sm90"), (64, 16, 128, "sm90"), (64, 17, 16, "sm90"),
    (128, 256, 64, "sm90"), (8, 1, 8, "cuda_core"), (32, 64, 16, "cuda_core"),
    (64, 1, 24, "cuda_core"),
])
def test_f16_routes_follow_dtype_and_shape(d, t, bs, route):
    """float16 q takes bf16's routes: the sm90 kernels at d = 64 / 128 (and
    blocks 8-128) at every t, the CUDA-core kernels elsewhere."""
    assert pt_da.paged_kernel_route(torch.float16, d, t, bs) == route
    want = "sm90" if d in (64, 128) else "cuda_core"
    assert pt_da.kernel_route(torch.float16, d) == want
    assert pt_da.kernel_route(torch.bfloat16, d) == want


def test_f16_launch_count_moves_only_for_float16(monkeypatch):
    monkeypatch.setattr(pt_da, "COUNTS", dict(pt_da.COUNTS))
    before = dict(pt_da.COUNTS)
    pt_da._count("paged_decode", 17, "sm90", torch.float16)
    pt_da._count("flash_decode_q8", 1, "sm90", torch.bfloat16)
    moved = {k: pt_da.COUNTS[k] - before[k] for k in pt_da.COUNTS if pt_da.COUNTS[k] != before[k]}
    assert moved == {"paged_decode": 1, "paged_decode_f16": 1, "paged_decode_sm90": 1,
                     "paged_decode_chunk": 1, "paged_decode_sm90_chunk": 1,
                     "flash_decode_q8": 1, "flash_decode_q8_sm90": 1}


# ---------------------------------------------------------------------------
# the float16 model served: the coalescing server and the paged engine
# against the JAX server and engine on the same weights
# ---------------------------------------------------------------------------


TINY = copy.deepcopy(pfx.TINY)
TINY["Model"]["dtype"] = "float16"
BLK, MAX_NEW = pfx.BLK, pfx.MAX_NEW
PROMPTS = [[5, 17, 33, 2, 8], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [7, 7, 8, 9]]
# float16 logits of the two sides, teacher-forced on the same tokens: the
# matmuls, LayerNorms and GELU round their float16 outputs at the same
# points but may land a value on the neighbouring float16 number (XLA and
# PyTorch sum in other orders), and a layer passes that on.  At TINY width
# the logits sit below 2 in magnitude, where a float16 ulp is 2^-10 or
# less; the two sides differ by up to one such ulp (1.07e-3 read), and the
# limit is 4
F16_LOGITS_TOL = 2.0**-8


def _weights():
    """The perturbed JAX weights of tests/test_torch_prefix_cache.py
    (float32 numpy leaves)."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k != "module"}
    jparams = jax_model.init(JaxGPTConfig(**model_kw), jax.random.key(0))
    rng = np.random.default_rng(3)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), jparams)


def _pair(tree, generation=None):
    """(JAX GenerationServer, port GenerationServer), float16 models on
    ``tree`` with ``generation`` merged into the Generation section."""
    raw = copy.deepcopy(TINY)
    raw["Generation"].update(generation or {})
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(raw)),
                              num_devices=jax.device_count())
    jserver = JaxServer(cfg, init_dist_env(cfg), build_module(cfg),
                        params=jax.tree.map(jnp.asarray, tree))
    pcfg = process_configs(AttrDict.from_nested(
        {k: v for k, v in raw.items() if k in pfx.PORT_SECTIONS}))
    module = GPTModule(pcfg)
    model = params_from_jax(module.config, tree)
    assert model.embeddings.word.dtype == torch.float16
    return jserver, GenerationServer(pcfg, module, model, torch.device("cpu"))


@pytest.fixture(scope="module")
def servers():
    """(JAX GenerationServer, port GenerationServer, float32 weight tree),
    both float16 models on the same perturbed JAX weights."""
    tree = _weights()
    return (*_pair(tree), tree)


def _jax_cfg():
    return JaxGPTConfig(**{k: v for k, v in TINY["Model"].items() if k != "module"})


def _teacher_forced(pserver, tree, prompt, answer, kv_dtype):
    """Each step's float32 logits [len(answer), vocab] from both sides'
    cached forward, fed the same tokens: the prompt as one prefill, then
    the answer's tokens one at a time (the served decode loop's calls)."""
    jcfg = _jax_cfg()
    jparams = jax.tree.map(jnp.asarray, tree)
    total = len(prompt) + len(answer)
    jcache = jax_gen.init_cache(jcfg, 1, total, kv_dtype=kv_dtype)
    pcache = pt_gen.init_cache(pserver.module.config, 1, total, torch.device("cpu"),
                               kv_dtype=kv_dtype)
    out = {"jax": [], "port": []}
    pos, chunk = 0, list(prompt)
    for step in range(len(answer)):
        jl, jcache = jax_gen.forward_cached(jparams, jnp.asarray([chunk], jnp.int32), jcache,
                                            jnp.int32(pos), jcfg)
        pl = pt_gen.forward_cached(pserver.model, torch.tensor([chunk]), pcache, pos)
        out["jax"].append(np.asarray(jl[0, -1], np.float32))
        out["port"].append(pl[0, -1].float().numpy())
        pos += len(chunk)
        chunk = [answer[step]]
    return np.stack(out["port"]), np.stack(out["jax"])


def _margin_ok(logits, tol):
    """Whether each step's top-2 margin clears ``tol`` (a choice no
    rounding inside the tolerance can flip)."""
    top = np.sort(logits, axis=-1)[:, -2:]
    return (top[:, 1] - top[:, 0]) > tol


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"], ids=["native", "int8"])
def test_f16_coalescing_server_matches_jax(servers, kv_dtype, capsys):
    """The coalescing server in float16 (native float16 caches: K7's float16
    route on the card; int8: K8 under float16 q): each step's logits,
    teacher-forced with the JAX answer, within ``F16_LOGITS_TOL``; the
    free-running answers equal JAX's wherever every step's margin clears
    it."""
    jserver, pserver, tree = servers
    try:
        jserver.kv_dtype = pserver.kv_dtype = kv_dtype
        want = jserver.generate_ids(PROMPTS, max_dec_len=MAX_NEW)
        got = pserver.generate_ids(PROMPTS, max_dec_len=MAX_NEW)
    finally:
        jserver.kv_dtype = pserver.kv_dtype = "bf16"
    clear = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        p_logits, j_logits = _teacher_forced(pserver, tree, prompt, w, kv_dtype)
        assert np.isfinite(p_logits).all()
        np.testing.assert_allclose(p_logits, j_logits, atol=F16_LOGITS_TOL, rtol=0)
        ok = _margin_ok(j_logits, 2 * F16_LOGITS_TOL)
        if ok.all():
            clear += 1
            assert g == w
        else:  # equal up to the first step whose choice could flip
            first = int(np.argmin(ok))
            assert g[:first] == w[:first]
    with capsys.disabled():
        print(f"\n  float16 {kv_dtype}: {clear}/{len(PROMPTS)} answers clear the margin")
    assert clear >= 1


SPEC_PROMPTS = [[3, 4, 5, 3, 4, 5, 3, 4], [9, 10, 11, 9, 10], pfx.SHORT]


def _spec_engine(engine_cls, server, kv_dtype):
    """Three rows through the paged engine at draft_k 4: (tokens,
    proposed, accepted)."""
    mod = jax_spec if engine_cls is JaxEngine else pt_spec
    eng = engine_cls(server, max_batch=8, block=BLK, kv_dtype=kv_dtype,
                     spec=mod.SpecConfig(draft_k=4))
    slots = [eng.admit(p, 12) for p in SPEC_PROMPTS]
    pfx._drain(eng)
    return ([[int(x) for x in eng.slots[s].tokens] for s in slots],
            int(eng.stats["spec_proposed"]), int(eng.stats["spec_accepted"]))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"], ids=["native", "int8"])
def test_f16_speculative_serving_accepts_as_jax(servers, kv_dtype):
    """draft_k 4 in float16: the coalescing server's tokens equal the JAX
    server's and the plain server's (the verify chunk's t = 5 on K7 / K8);
    the paged engine's tokens and accept counts equal the JAX engine's
    (t = 5 on K9)."""
    _, plain, tree = servers
    jserver, pserver = _pair(tree, {"speculative": {"draft_k": 4, "kv_dtype": kv_dtype}})
    assert pserver.spec.draft_k == 4 and pserver.kv_dtype == kv_dtype
    want = jserver.generate_ids(SPEC_PROMPTS, max_dec_len=12)
    assert pserver.generate_ids(SPEC_PROMPTS, max_dec_len=12) == want
    assert pserver.stats["spec_proposed"] > 0
    try:
        plain.kv_dtype = kv_dtype
        assert plain.generate_ids(SPEC_PROMPTS, max_dec_len=12) == want
    finally:
        plain.kv_dtype = "bf16"
    got = _spec_engine(PagedDecodeEngine, pserver, kv_dtype)
    assert got == _spec_engine(JaxEngine, jserver, kv_dtype) and got[1] > 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"], ids=["native", "int8"])
@pytest.mark.parametrize("name", ["hit_prefills_only_suffix", "chunk_and_hit_suffix_only",
                                  "chunked_interleaves_with_decode", "spill_readmit",
                                  "spec_with_rows_mid_prefill"])
def test_f16_engine_matches_jax_engine(servers, name, kv_dtype):
    """The paged engine in float16 (K9's float16 route on the card, float16
    or int8 pools) against the JAX engine: greedy tokens, block tables,
    prefix hits and the prefix, spill and chunk accounting equal, the
    prefill logits within ``F16_LOGITS_TOL``."""
    jserver, pserver, _ = servers
    _, want, want_logits = pfx._run_case(JaxEngine, jserver, name, kv_dtype)
    eng, got, got_logits = pfx._run_case(PagedDecodeEngine, pserver, name, kv_dtype)
    assert eng.pools.k.dtype == (torch.int8 if kv_dtype == "int8" else torch.float16)
    assert got == want
    assert len(got_logits) == len(want_logits) > 0
    for g, w in zip(got_logits, want_logits):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=F16_LOGITS_TOL, rtol=0)


def test_f16_spill_readmit_restores_float16_blocks_bitwise(servers):
    """A float16 block spills to host RAM, passes its CRC and comes back bit
    for bit; a flipped bit in the host copy is caught and recomputed."""
    _, pserver, _ = servers
    eng = PagedDecodeEngine(pserver, max_batch=4, block=BLK, kv_dtype="bf16",
                            prefix_cache_blocks=1, prefix_spill_bytes=64 << 20)
    obs, logits = [], []
    pfx._serve(eng, pfx.A1, obs, logits)
    (blk,) = eng.cache.prefix.match(pfx.A2)[0]
    saved = pt_gen.gather_kv_blocks(eng.pools, [blk])
    assert set(saved) == {"k", "v"} and saved["k"].dtype == torch.float16
    pfx._serve(eng, pfx.B1, obs, logits)
    (key, entry), = eng.cache.spill._entries.items()
    assert key == tuple(pfx.PFX_A) and entry["arrays"]["k"].dtype == torch.float16
    slot = eng.admit(pfx.A2, MAX_NEW)
    assert eng.slots[slot].prefix_hit == BLK and eng.cache.spill.stats["readmits"] == 1
    back = pt_gen.gather_kv_blocks(eng.pools, [eng.slots[slot].table[0]])
    assert all(torch.equal(back[n].view(torch.int16), saved[n].view(torch.int16)) for n in saved)
    pfx._drain(eng)
    eng.release(slot)
    # the CRC over float16 bytes: one flipped bit is a discard
    store = pt_pc.PrefixSpillStore(budget_bytes=1 << 20)
    assert store.put((1, 2), saved)
    torn = store.get((1, 2))["v"].clone()
    torn.view(torch.int16).view(-1)[3] ^= 1
    store._entries[(1, 2)]["arrays"]["v"] = torn
    assert store.get((1, 2)) is None and store.stats["discards"] == 1


def _preempt_resume(engine_cls, server, kv_dtype):
    """Admit a row, decode three steps, preempt it (its KV-valid prefix is
    published), resume it as prompt + committed tokens (a prefix hit whose
    suffix runs as a chunk), drain: (hit, committed, resumed tokens)."""
    eng = engine_cls(server, max_batch=8, block=BLK, kv_dtype=kv_dtype, prefix_cache_blocks=32)
    slot = eng.admit(pfx.LONG_A, MAX_NEW + 4)
    for _ in range(3):
        eng.step()
    committed = [int(x) for x in eng.preempt_row(slot)]
    slot = eng.admit(pfx.LONG_A + committed, MAX_NEW + 4 - len(committed))
    row = eng.slots[slot]
    hit = int(row.prefix_hit)
    pfx._drain(eng)
    return hit, committed, [int(x) for x in row.tokens]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"], ids=["native", "int8"])
def test_f16_preemption_resume_matches_jax(servers, kv_dtype):
    jserver, pserver, _ = servers
    want = _preempt_resume(JaxEngine, jserver, kv_dtype)
    got = _preempt_resume(PagedDecodeEngine, pserver, kv_dtype)
    assert got == want and got[0] > 0 and len(got[1]) == 3


def test_f16_beam_search_matches_jax(servers):
    """Beam search (4 beams) on the float16 model: the JAX beam search's
    tokens (the beam cache in float16, K7's float16 route on the card)."""
    _, pserver, tree = servers
    beam = dict(max_dec_len=8, decode_strategy="beam_search", eos_token_id=95, pad_token_id=0,
                num_beams=4)
    ids, lens = jax_gen.pad_prompts(PROMPTS, 0, multiple=8)
    want = np.asarray(jax_gen.generate(jax.tree.map(jnp.asarray, tree), ids, _jax_cfg(),
                                       jax_gen.GenerationConfig(**beam), prompt_lens=lens))
    got = pt_gen.generate(pserver.model, torch.from_numpy(np.array(ids)).long(),
                          pt_gen.GenerationConfig(**beam),
                          prompt_lens=torch.from_numpy(np.array(lens)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# a float16 step_N of the port's train CLI, served
# ---------------------------------------------------------------------------

CONFIG = os.path.join(REPO, "configs", "gpt", "pretrain_gpt_345M_single.yaml")
STEPS = 3
F16_MODEL = ["Model.num_layers=2", "Model.hidden_size=32", "Model.num_attention_heads=4",
             "Model.vocab_size=96", "Model.max_position_embeddings=128", "Model.dtype=float16"]
F16_TRAIN = ["Engine.mix_precision.enable=True", "Engine.mix_precision.dtype=float16",
             "Global.global_batch_size=4", "Global.local_batch_size=4",
             "Global.micro_batch_size=2",
             'Optimizer.lr={"name": "Constant", "learning_rate": 1.0e-4}']
F16_GEN = ["Generation.decode_strategy=greedy_search", "Generation.max_dec_len=8",
           "Generation.pad_to_multiple=8", "Generation.eos_token_id=95",
           "Generation.pad_token_id=0"]


def _spawn(module, args):
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES=""))
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    return proc, lines, reader


@pytest.fixture(scope="module")
def f16_step(tmp_path_factory):
    """The step_<STEPS> directory of a float16 train CLI run at TINY width
    (dynamic loss scaling, float32 masters)."""
    root = tmp_path_factory.mktemp("f16_serve")
    gd.write_synthetic_corpus(str(root / "data" / "tiny"), vocab_size=96, num_docs=60,
                              mean_len=80, seed=3)
    out = root / "out"
    args = ["-c", CONFIG, "--device", "cpu"]
    for o in F16_MODEL + F16_TRAIN + [
            f"Data.Train.dataset.input_dir={root / 'data'}",
            f"Data.Eval.dataset.input_dir={root / 'data'}", "Data.Train.dataset.max_seq_len=64",
            "Data.Eval.dataset.max_seq_len=64", f"Engine.max_steps={STEPS}",
            "Engine.eval_freq=0", "Engine.logging_freq=1", f"Engine.save_load.save_steps={STEPS}",
            f"Engine.save_load.output_dir={out}"]:
        args += ["-o", o]
    proc, lines, reader = _spawn("paddlefleetx_tpu_torch.tools.train", args)
    rc = proc.wait(timeout=300)
    reader.join(timeout=30)
    assert rc == 0, "".join(lines)[-3000:]
    return str(out / f"step_{STEPS}")


def test_f16_step_loads_as_the_jax_server_casts(f16_step):
    """A float16 server over a train CLI step_N (float32 masters): every
    served leaf is the JAX cast of its master to float16, bit for bit
    (round to nearest; the LayerNorm affines stay float32), and the server
    answers the JAX server's tokens on those masters."""
    masters = restore_params(f16_step)
    assert all(p.dtype == torch.float32 for p in masters.values())
    served = build_server(CONFIG, F16_MODEL + F16_GEN + [
        f"Engine.save_load.ckpt_dir={f16_step}"], device="cpu")
    own = dict(served.model.named_parameters())
    assert own["embeddings.word"].dtype == torch.float16
    for name, p in own.items():
        want = np.asarray(jnp.asarray(masters[name].numpy()).astype(
            jnp.float16 if p.dtype == torch.float16 else jnp.float32))
        got = p.detach().numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
    # the JAX server holds the float32 masters and casts them at use
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(TINY)),
                              num_devices=jax.device_count())
    f32 = load_params_into(GPTModel(dataclasses.replace(served.module.config, dtype="float32")),
                           masters, f16_step)
    jserver = JaxServer(cfg, init_dist_env(cfg), build_module(cfg),
                        params=jax.tree.map(jnp.asarray, params_to_jax(f32)))
    assert served.generate_ids(PROMPTS, max_dec_len=8) == jserver.generate_ids(PROMPTS,
                                                                               max_dec_len=8)


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        return json.load(r)


@pytest.mark.parametrize("scheduler,flags", [
    ("coalesce", ["--kv-dtype", "bf16", "--draft-k", "2"]),
    ("continuous", ["--kv-dtype", "int8", "--cb-batch", "4", "--prefill-chunk", "8",
                    "--prefix-cache-blocks", "16"]),
])
def test_f16_serve_cli_round_trip(f16_step, scheduler, flags):
    """``tools.serve --device cpu -o Model.dtype=float16`` over the float16
    step_N answers what the in-process server answers on the same params;
    /healthz counts the plain versions' calls (the CPU's route) and
    float16 launches stay 0 there."""
    overrides = F16_MODEL + F16_GEN + [f"Engine.save_load.ckpt_dir={f16_step}"]
    want = build_server(CONFIG, overrides, device="cpu").generate_ids(PROMPTS, max_dec_len=8)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["-c", CONFIG, "--port", str(port), "--device", "cpu", "--warmup-batches", "1",
            "--scheduler", scheduler, *flags]
    for o in overrides:
        args += ["-o", o]
    env_block = os.environ.get("PFX_KV_BLOCK")
    os.environ["PFX_KV_BLOCK"] = "8"
    try:
        proc, lines, reader = _spawn("paddlefleetx_tpu_torch.tools.serve", args)
    finally:
        if env_block is None:
            os.environ.pop("PFX_KV_BLOCK")
        else:
            os.environ["PFX_KV_BLOCK"] = env_block
    try:
        deadline = time.time() + 180
        while True:
            assert proc.poll() is None, "".join(lines)[-3000:]
            assert time.time() < deadline, "server never healthy"
            try:
                _healthz(port)
                break
            except OSError:
                time.sleep(0.3)
        got = []
        for prompt in PROMPTS:  # one at a time: a finished row publishes its blocks
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"prompt_ids": prompt, "max_tokens": 8}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got.append(json.load(r)["completion_ids"])
        health = _healthz(port)
        kern = health["kernels"]
        assert kern["plain" if scheduler == "coalesce" else "paged_plain"] > 0
        assert all(kern[f"{k}_f16"] == 0 for k in ("flash_decode", "flash_decode_q8",
                                                    "paged_decode", "paged_decode_q8"))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=10)
    if scheduler == "coalesce":
        assert got == want
    else:  # int8 pools: its own engine answers, checked against the in-process engine
        served = build_server(CONFIG, overrides + ["Generation.speculative.kv_dtype=int8"],
                              device="cpu")
        eng = PagedDecodeEngine(served, max_batch=4, block=8, kv_dtype="int8",
                                prefill_chunk=8, prefix_cache_blocks=16)
        mine = []
        for prompt in PROMPTS:
            slot = eng.admit(prompt, 8)
            pfx._drain(eng)
            toks = [int(x) for x in eng.slots[slot].tokens]
            mine.append(toks[: toks.index(95)] if 95 in toks else toks)
            eng.release(slot)
        assert got == mine
