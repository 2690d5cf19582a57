"""PyTorch port: the plain flash-decode (the CPU spelling of the CUDA
kernels in paddlefleetx_tpu_torch/csrc/decode_attention.cu) against the
JAX package's Pallas kernels in interpret mode and its lax spelling.

Same numpy inputs on both sides; float32; tolerance 2e-5, the bar of
tests/test_decode_attention.py.  Covers decode (t = 1) and prefill /
chunks (t > 1), blocks 8 and 16, an unaligned cache length, left-padded
rows (fully masked rows must be 0, not NaN), the int8 cache, and the
shapes around the card's sm90 route (head dims 64 and 128, t = 16, 17 and
64; for the int8 cache also t = 1 and 4, and lengths, limits and pads that
are not multiples of 4).  The route and split-count rules of the card's wrapper are plain
Python and are pinned here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.ops import decode_attention as jax_da
from paddlefleetx_tpu_torch.ops import decode_attention as pt_da

TOL = 2e-5

# (b, t, n, d, L, pos, block, kv_valid_from)
CASES = {
    "decode_odd_pos": (2, 1, 4, 16, 40, 13, 16, None),
    "decode_last_slot_block8": (2, 1, 4, 16, 40, 39, 8, None),
    "prefill_left_pad": (3, 16, 4, 16, 40, 0, 8, [0, 5, 11]),
    "chunk_unaligned_len": (2, 5, 4, 16, 20, 7, 0, [2, 0]),
    "decode_left_pad_unaligned": (2, 1, 2, 8, 27, 20, 16, [9, 3]),
    # the head dims of the card's sm90 route, on both sides of its regime
    # boundary (split-K up to t = 16: 64-key stages at d = 64, 32-key at
    # d = 128; tensor cores above: 128-key tiles at d = 64, 64-key at
    # d = 128): left pads that cut a stage or tile and pads that cover
    # whole ones, limits (pos + t) that end mid-tile
    "verify_t16_d64": (2, 16, 2, 64, 160, 100, 0, [70, 0]),
    "prefill_t17_d64": (2, 17, 2, 64, 160, 100, 0, [70, 0]),
    "prefill_t64_d64_pads": (2, 64, 2, 64, 320, 236, 0, [130, 7]),
    "verify_t16_d128": (2, 16, 2, 128, 160, 100, 0, [40, 33]),
    "prefill_t17_d128": (2, 17, 2, 128, 300, 180, 0, [130, 0]),
    "prefill_t64_d128_pads": (2, 64, 2, 128, 320, 236, 0, [260, 3]),
}


# The int8 cache at the boundaries of the card's int8 sm90 route: t = 1, 4,
# 16 (split-K: 128-key stages at d = 64, 64-key at d = 128, each with its
# scale slices) and 17, 64 (tensor cores: 128-key tiles at d = 64, 64-key at
# d = 128) at both head dims; cache lengths L, limits (pos + t) and left
# pads that are not multiples of 4 (a scale slice of any start or end, the
# last head's slice at the very end of the [b, n, L] scales); pads that cut
# a stage or tile and pads that skip whole ones
Q8_CASES = {
    "q8_decode_t1_d64": (2, 1, 2, 64, 301, 290, 0, [37, 130]),
    "q8_decode_t1_d64_skip_stages": (1, 1, 2, 64, 1023, 1000, 0, [517]),
    "q8_decode_t1_d128_limit_is_L": (2, 1, 2, 128, 203, 202, 0, [0, 65]),
    "q8_verify_t4_d64": (2, 4, 2, 64, 150, 97, 0, [5, 0]),
    "q8_verify_t4_d128": (2, 4, 2, 128, 151, 147, 0, [66, 3]),
    "q8_verify_t16_d64": (2, 16, 2, 64, 301, 250, 0, [131, 2]),
    "q8_verify_t16_d128": (2, 16, 2, 128, 150, 117, 0, [70, 1]),
    "q8_prefill_t17_d64": (2, 17, 2, 64, 150, 100, 0, [70, 0]),
    "q8_prefill_t17_d128": (2, 17, 2, 128, 150, 100, 0, [3, 90]),
    "q8_prefill_t64_d64_pads": (2, 64, 2, 64, 299, 235, 0, [131, 262]),
    "q8_prefill_t64_d128_limit_is_L": (2, 64, 2, 128, 267, 203, 0, [65, 195]),
}


def _inputs(case, seed=0):
    b, t, n, d, L, pos, block, vf = {**CASES, **Q8_CASES}[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, n, d)).astype(np.float32)
    kc = rng.normal(size=(b, n, L, d)).astype(np.float32)
    vc = rng.normal(size=(b, n, L, d)).astype(np.float32)
    vf = None if vf is None else np.asarray(vf, np.int32)
    return q, kc, vc, pos, block, vf


def _jax(q, kc, vc, pos, block, vf, impl, ks=None, vs=None):
    return np.asarray(jax_da.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(pos),
        kv_valid_from=None if vf is None else jnp.asarray(vf),
        block=block, impl=impl,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
    ))


def _port(q, kc, vc, pos, block, vf, ks=None, vs=None):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return pt_da.decode_attention(
        t(q), t(kc), t(vc), pos, kv_valid_from=t(vf), block=block,
        k_scale=t(ks), v_scale=t(vs),
    ).numpy()


@pytest.mark.parametrize("impl", ["pallas", "lax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_decode_matches_jax(case, impl):
    q, kc, vc, pos, block, vf = _inputs(case)
    ref = _jax(q, kc, vc, pos, block, vf, impl)
    got = _port(q, kc, vc, pos, block, vf)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["pallas", "lax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_decode_q8_matches_jax(case, impl):
    q, kc, vc, pos, block, vf = _inputs(case, seed=1)
    kq, ks = (np.asarray(a) for a in jax_da.quantize_kv(jnp.asarray(kc)))
    vq, vs = (np.asarray(a) for a in jax_da.quantize_kv(jnp.asarray(vc)))
    ref = _jax(q, kq, vq, pos, block, vf, impl, ks, vs)
    got = _port(q, kq, vq, pos, block, vf, ks, vs)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["pallas", "lax"])
@pytest.mark.parametrize("case", sorted(Q8_CASES))
def test_plain_decode_q8_matches_jax_at_sm90_boundaries(case, impl):
    """bf16 q, as the card's int8 sm90 route takes it (the model's dtype):
    both sides read the same bf16 values as float32."""
    q, kc, vc, pos, block, vf = _inputs(case, seed=4)
    q = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float32)
    kq, ks = (np.asarray(a) for a in jax_da.quantize_kv(jnp.asarray(kc)))
    vq, vs = (np.asarray(a) for a in jax_da.quantize_kv(jnp.asarray(vc)))
    ref = _jax(q, kq, vq, pos, block, vf, impl, ks, vs)
    got = _port(q, kq, vq, pos, block, vf, ks, vs)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 4, 40, 16), (1, 3, 5, 64)])
def test_quantize_kv_exact(shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero vector takes the scale floor
    jq, js = jax_da.quantize_kv(jnp.asarray(x))
    pq, ps = pt_da.quantize_kv(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_left_pad_rows_are_zero_not_nan():
    q, kc, vc, pos, block, vf = _inputs("prefill_left_pad")
    got = _port(q, kc, vc, pos, block, vf)
    assert np.isfinite(got).all()
    for row, pad in enumerate(vf):
        # query rows before the first real token see no key at all
        assert (got[row, :pad] == 0).all()
        assert (np.abs(got[row, pad:]).sum(axis=-1) > 0).all()


def test_dense_path_matches_jax():
    q, kc, vc, pos, block, vf = _inputs("chunk_unaligned_len")
    ref = np.asarray(jax_da.dense_cache_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(pos),
        kv_valid_from=jnp.asarray(vf),
    ))
    got = pt_da.dense_cache_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), pos,
        kv_valid_from=torch.from_numpy(vf),
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    q, kc, vc, pos, block, vf = _inputs("decode_odd_pos")
    before = dict(pt_da.COUNTS)
    _port(q, kc, vc, pos, block, vf)
    assert pt_da.COUNTS["plain"] == before["plain"] + 1
    assert pt_da.COUNTS["flash_decode"] == before["flash_decode"]
    assert pt_da.COUNTS["flash_decode_q8"] == before["flash_decode_q8"]


@pytest.mark.parametrize("max_len,block", [(1024, 0), (20, 0), (40, 16), (5, 0)])
def test_block_resolution_matches_jax(max_len, block):
    assert pt_da.decode_block(max_len, block) == jax_da.decode_block(max_len, block)
    bs = pt_da.decode_block(max_len, block)
    for limit in (1, bs, max_len):
        assert pt_da.blocks_visited(limit, bs, max_len) == int(
            jax_da.blocks_visited(limit, bs, max_len)
        )


def test_knobs_fail_loudly(monkeypatch):
    monkeypatch.setenv("PFX_DECODE_BLOCK", "12")
    with pytest.raises(ValueError):
        pt_da.decode_block(64)
    monkeypatch.setenv("PFX_KV_DTYPE", "fp8")
    with pytest.raises(ValueError):
        pt_da.kv_cache_dtype()
    monkeypatch.setenv("PFX_DECODE_ATTN", "sparse")
    with pytest.raises(ValueError):
        pt_da.decode_attn_mode()
    with pytest.raises(ValueError):
        pt_da.flash_decode(
            torch.zeros(1, 1, 1, 8), torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
            1, None, 1.0, k_scale=torch.ones(1, 1, 4),
        )


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 8, "cuda_core"), (torch.bfloat16, 96, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
])
def test_kernel_route_follows_dtype_and_head_dim(dtype, head_dim, route):
    assert pt_da.kernel_route(dtype, head_dim) == route


@pytest.mark.parametrize("q_dtype,head_dim,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 32, "cuda_core"), (torch.bfloat16, 96, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
])
def test_kernel_route_answers_for_int8_caches(q_dtype, head_dim, route):
    """int8 caches route by q's dtype and the head dim, as bf16 ones do:
    bf16 q at d = 64 / 128 takes flash_decode_q8_sm90, f32 q or another d
    the CUDA-core flash_decode_q8."""
    assert pt_da.kernel_route(q_dtype, head_dim) == route


def test_split_count_rule():
    sms = 132  # an H100 SXM
    # the main-path decode step (batch 8, 16 heads, limit 80): one split
    assert pt_da.decode_splits(8 * 16, 80, sms) == 1
    # batch 1 at limit 1024: 8 splits of 128 keys, 128 CTAs
    assert pt_da.decode_splits(16, 1024, sms) == 8
    # batch 8 at limit 1024: every SM already holds a CTA
    assert pt_da.decode_splits(8 * 16, 1024, sms) == 1
    assert pt_da.split_rows(1) == 1
    assert all(pt_da.split_rows(t) == pt_da.SPLIT_ROWS for t in range(2, pt_da.SPLIT_MAX_ROWS + 1))
    for ctas in (1, 7, 16, 64, 128, 512):
        for keys in (1, 63, 64, 200, 1024, 100000):
            s = pt_da.decode_splits(ctas, keys, sms)
            assert s >= 1
            if s > 1:  # never a split under SPLIT_MIN_KEYS, never past one CTA per SM
                assert keys // s >= pt_da.SPLIT_MIN_KEYS and ctas * s <= sms
