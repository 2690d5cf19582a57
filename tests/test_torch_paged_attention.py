"""PyTorch port: the plain paged decode attention (the CPU spelling of the
CUDA kernels in paddlefleetx_tpu_torch/csrc/paged_attention.cu) against
the JAX package's ``paged_decode_attention``: its lax spelling, and its
Pallas kernel in interpret mode.

Same numpy inputs on both sides; float32; tolerance 2e-5, the bar of
tests/test_paged_cache.py.  Covers decode (t = 1) and the verify chunk
(t = 3), float32 and int8 pools with scale tiles, shuffled pool blocks
with null-padded tables, a row ending exactly on a block boundary, a
table wider than any row needs, and the NaN-poison visit bound.  At the
shapes of the kernels' sm90 route (d = 64 / 128, blocks 8, 16 and 128,
t = 1, 4 and 16, skewed row lengths) the float32 outputs of both sides
are held for float32 pools, int8 pools under bf16 q (2e-5) and bf16
pools (``BF16_P_ROUNDING``); the route and split rules are pinned too.
At the chunk kernel's widths (t = 17, 64 and 80: past the split-K
kernel's 16 rows and across a 64-query tile; a first slot of 0, one
mid-block and one over a cached prefix) the same three kinds are held
against ``_paged_lax``, and once against ``_paged_pallas`` in interpret
mode; the launch counts of the chunk route are pinned.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.ops import decode_attention as jax_da
from paddlefleetx_tpu_torch.ops import decode_attention as pt_da

torch.set_num_threads(2)

# Workaround for an open fault of the reference's test harness (ROADMAP
# queue C), kept here because this change may not edit tests/conftest.py
# or the drills.  jax 0.9 logs two ~2.5 KB "cpu_aot_loader ... machine
# type doesn't match" ERROR lines for every executable it loads from the
# persistent cache.  The JAX CLI drills pipe their servers' output and
# read it only at exit, so a server that loads ~13 cached executables
# fills the 64 KB pipe and blocks; without this, full runs of the suite
# hang those drills at random.  Every pytest worker imports this module
# while collecting, so the servers the session starts inherit it.  Only
# jax's own default ("1") is replaced; an explicit setting is kept.
# Remove once the drills drain their pipes or conftest sets the level.
if os.environ.get("TF_CPP_MIN_LOG_LEVEL", "1") == "1":
    os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"

TOL = 2e-5

# (b, n, d, bs, M, positions): every row's table is null-padded past its
# last needed block; M is a power of two wider than any row needs
CASES = {
    "rows_differ": (3, 2, 8, 8, 8, [17, 9, 28]),
    "block_boundary": (3, 4, 16, 8, 4, [7, 15, 0]),
    "block16_wide_table": (2, 2, 16, 16, 8, [40, 3]),
}


def _inputs(case, t, quant, seed=0):
    b, n, d, bs, M, pos = CASES[case]
    rng = np.random.default_rng(seed)
    nb = b * M + 1
    k_pool = rng.normal(size=(nb, n, bs, d)).astype(np.float32)
    v_pool = rng.normal(size=(nb, n, bs, d)).astype(np.float32)
    q = rng.normal(size=(b, t, n, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[: b * M].reshape(b, M).astype(np.int32)
    for i, p in enumerate(pos):
        tables[i, (p + t - 1) // bs + 1:] = 0  # null-block padding
    ks = vs = None
    if quant:
        kq, ks = pt_da.quantize_kv(torch.from_numpy(k_pool))
        vq, vs = pt_da.quantize_kv(torch.from_numpy(v_pool))
        k_pool, v_pool, ks, vs = kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()
    return q, k_pool, v_pool, tables, np.asarray(pos, np.int32), ks, vs


def _jax(q, k_pool, v_pool, tables, pos, ks, vs, impl):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(jax_da.paged_decode_attention(
        j(q), j(k_pool), j(v_pool), j(tables), j(pos), impl=impl,
        k_scale=j(ks), v_scale=j(vs),
    ))


def _port(q, k_pool, v_pool, tables, pos, ks=None, vs=None):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return pt_da.paged_decode_attention(
        t(q), t(k_pool), t(v_pool), t(tables), t(pos), k_scale=t(ks), v_scale=t(vs),
    ).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_lax(case, t, quant):
    args = _inputs(case, t, quant)
    before = pt_da.COUNTS["paged_plain"]
    got = _port(*args)
    assert pt_da.COUNTS["paged_plain"] == before + 1
    assert got.shape == args[0].shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, _jax(*args, impl="lax"), atol=TOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_plain_matches_pallas_interpret(quant):
    args = _inputs("rows_differ", 1, quant)
    np.testing.assert_allclose(_port(*args), _jax(*args, impl="pallas"), atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [1, 3])
def test_plain_never_reads_past_a_rows_bound(t):
    """NaN-poison every pool block a row cannot see, the null block that
    pads the tables included: the result must stay finite and equal."""
    q, k_pool, v_pool, tables, pos, _, _ = _inputs("rows_differ", t, False)
    clean = _port(q, k_pool, v_pool, tables, pos)
    bs = k_pool.shape[2]
    seen = set()
    for i, p in enumerate(pos):
        seen.update(tables[i, : (p + t - 1) // bs + 1].tolist())
    for blk in range(k_pool.shape[0]):
        if blk not in seen:
            k_pool[blk] = np.nan
            v_pool[blk] = np.nan
    got = _port(q, k_pool, v_pool, tables, pos)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, clean)


def test_verify_chunk_is_causal_per_query():
    """Query qi of a t-token chunk equals a t = 1 call at position + qi."""
    q, k_pool, v_pool, tables, pos, _, _ = _inputs("rows_differ", 3, False)
    got = _port(q, k_pool, v_pool, tables, pos)
    for qi in range(3):
        one = _port(q[:, qi:qi + 1], k_pool, v_pool, tables, pos + qi)
        np.testing.assert_allclose(got[:, qi:qi + 1], one, atol=1e-6, rtol=0)


def test_loud_errors():
    q, k_pool, v_pool, tables, pos, _, _ = _inputs("rows_differ", 1, False)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="both"):
        pt_da.paged_decode_attention(t(q), t(k_pool), t(v_pool), t(tables), t(pos),
                                     k_scale=t(k_pool[:, :, :, 0]))
    with pytest.raises(ValueError, match="t >= 1"):
        pt_da.paged_decode_attention(t(q[:, :0]), t(k_pool), t(v_pool), t(tables), t(pos))


# ---------------------------------------------------------------------------
# The shapes of the sm90 route (paged_kernel_route: bf16 q at d = 64 / 128,
# t <= 16, block 8-128): the plain version the card holds that kernel
# against, held here against the JAX function's float32 output
# ---------------------------------------------------------------------------

# (b, n, d, bs, M, positions): skewed row lengths over shuffled pool blocks,
# tables null-padded past each row's last needed block
SM90_CASES = {
    "d64_bs8_skew": (3, 2, 64, 8, 32, [5, 200, 17]),
    "d64_bs16_skew": (4, 2, 64, 16, 16, [0, 230, 31, 100]),
    "d128_bs128": (2, 2, 128, 128, 4, [300, 3]),
}
# bf16 pools: both sides round p to bf16 before p @ v, from scores summed in
# another order, so a p can land on the neighbouring bf16 value, at most
# 2**-7 of p away; the output, sum(p v) / l, then moves by at most
# 2**-7 * max|v| however many p do.  f32 pools and int8 pools (bf16 q, whose
# products with the int8 values are exact in float32): summation order only.
BF16_P_ROUNDING = 2.0**-7


def _bf16_exact(x):
    """float32 values that bf16 holds exactly (both sides then start from
    the same bf16 numbers)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _sm90_inputs(case, t, kind, seed=0):
    b, n, d, bs, M, pos = {**SM90_CASES, **CHUNK_CASES}[case]
    rng = np.random.default_rng(seed)
    nb = b * M + 1
    k_pool = rng.normal(size=(nb, n, bs, d)).astype(np.float32)
    v_pool = rng.normal(size=(nb, n, bs, d)).astype(np.float32)
    q_t = rng.normal(size=(b, n, t, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[: b * M].reshape(b, M).astype(np.int32)
    for i, p in enumerate(pos):
        tables[i, (p + t - 1) // bs + 1:] = 0
    ks = vs = None
    if kind == "int8":
        kq, ks = pt_da.quantize_kv(torch.from_numpy(k_pool))
        vq, vs = pt_da.quantize_kv(torch.from_numpy(v_pool))
        k_pool, v_pool, ks, vs = kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()
    if kind in ("bf16", "int8"):
        q_t = _bf16_exact(q_t)
    if kind == "bf16":
        k_pool, v_pool = _bf16_exact(k_pool), _bf16_exact(v_pool)
    return q_t, k_pool, v_pool, tables, np.asarray(pos, np.int32), ks, vs


def _both(kind, q_t, k_pool, v_pool, tables, pos, ks, vs, jax_fn):
    """(port plain, JAX) float32 [b, n, t, d] on the same inputs, q and
    pools in bf16 where ``kind`` says so."""
    scale = 1.0 / q_t.shape[-1] ** 0.5
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.bfloat16}[kind]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.bfloat16}[kind]
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    c = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    pool_j = (lambda a: jnp.asarray(a, jnp.bfloat16)) if kind == "bf16" else j
    pool_t = (lambda a: c(a).to(torch.bfloat16)) if kind == "bf16" else c
    want = np.asarray(jax_fn(jnp.asarray(q_t, jdt), pool_j(k_pool), pool_j(v_pool), j(tables),
                             j(pos), scale, j(ks), j(vs)))
    got = pt_da.paged_decode_attention_plain(c(q_t).to(tdt), pool_t(k_pool), pool_t(v_pool),
                                             c(tables), c(pos), scale, c(ks), c(vs)).numpy()
    return got, want


def _tol(kind, v_pool):
    if kind == "bf16":
        return BF16_P_ROUNDING * float(np.abs(v_pool).max()) + TOL
    return TOL


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("t", [1, 4, 16])
@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_plain_matches_jax_lax_at_sm90_route_shapes(case, t, kind):
    args = _sm90_inputs(case, t, kind)
    got, want = _both(kind, *args, jax_fn=jax_da._paged_lax)
    assert got.shape == want.shape == args[0].shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=_tol(kind, args[2]), rtol=0)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_plain_matches_pallas_interpret_at_sm90_route_shapes(kind):
    args = _sm90_inputs("d64_bs16_skew", 4, kind)
    got, want = _both(kind, *args, jax_fn=jax_da._paged_pallas)
    np.testing.assert_allclose(got, want, atol=_tol(kind, args[2]), rtol=0)


@pytest.mark.parametrize("dtype,d,t,bs,route", [
    (torch.bfloat16, 64, 1, 16, "sm90"),
    (torch.bfloat16, 128, 16, 8, "sm90"),
    (torch.bfloat16, 64, 4, 128, "sm90"),
    (torch.bfloat16, 64, 1, 32, "sm90"),
    (torch.bfloat16, 128, 1, 64, "sm90"),
    (torch.bfloat16, 64, 17, 16, "sm90"),  # t past the split-K kernel's 16 rows: chunks
    (torch.bfloat16, 64, 64, 16, "sm90"),  # a prefix hit's suffix bucket
    (torch.bfloat16, 64, 256, 16, "sm90"),  # a chunked prefill's chunk
    (torch.bfloat16, 128, 80, 128, "sm90"),
    (torch.float32, 64, 1, 16, "cuda_core"),  # phase 8's float32 model
    (torch.float32, 64, 256, 16, "cuda_core"),  # phase 19's float32 chunks
    (torch.bfloat16, 32, 1, 16, "cuda_core"),  # head dims other than 64 / 128
    (torch.bfloat16, 32, 256, 16, "cuda_core"),
    (torch.bfloat16, 64, 256, 24, "cuda_core"),  # block 24 at chunk width
    (torch.bfloat16, 8, 3, 24, "cuda_core"),
    (torch.bfloat16, 64, 1, 24, "cuda_core"),  # a block neither dividing the stage nor a multiple
    (torch.bfloat16, 64, 1, 256, "cuda_core"),
])
def test_paged_kernel_route(dtype, d, t, bs, route):
    assert pt_da.paged_kernel_route(dtype, d, t, bs) == route


@pytest.mark.parametrize("M,bs,split_keys,splits", [
    (8, 16, 256, 1),    # phase 7's table: one split, no partials
    (64, 16, 256, 4),   # PAGED_POS at t = 1: the 1023-key row takes 4 CTAs
    (128, 16, 256, 8),  # PAGED_POS at t = 4 (table width 128)
    (1, 8, 256, 1),
    (33, 8, 256, 2),
    (4, 128, 128, 4),
    (4, 128, 512, 1),
])
def test_paged_splits_cover_the_table_from_shapes_alone(M, bs, split_keys, splits):
    assert pt_da.paged_splits(M, bs, split_keys) == splits
    assert splits * split_keys >= M * bs > (splits - 1) * split_keys


def test_paged_split_keys_fit_every_stage_and_block():
    """The kernel takes split sizes that are multiples of 128 up to 512: a
    whole number of key stages (32-128 keys) and of blocks (8-128)."""
    assert pt_da.PAGED_SPLIT_KEYS % 128 == 0 and 128 <= pt_da.PAGED_SPLIT_KEYS <= 512
    assert all(pt_da.PAGED_SPLIT_KEYS % bs == 0 for bs in pt_da.PAGED_SM90_BLOCKS)


# ---------------------------------------------------------------------------
# The chunk kernel's widths (t > SPLIT_MAX_ROWS on the sm90 route: 64-query
# tiles over key tiles assembled from the row's blocks): a chunked
# prefill's chunk, a prefix hit's suffix, a wide verify
# ---------------------------------------------------------------------------

# (b, n, d, bs, M, positions): a row's chunk from slot 0, one starting
# mid-block, one over a cached prefix; tables null-padded past each row's
# last needed block at the widest t below (M covers positions + 80)
CHUNK_CASES = {
    "d64_bs16_slot0_mid_prefix": (3, 2, 64, 16, 16, [0, 37, 128]),
    "d128_bs8_mid_block": (2, 2, 128, 8, 32, [13, 150]),
}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("t", [17, 64, 80])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_plain_matches_jax_lax_at_chunk_widths(case, t, kind):
    args = _sm90_inputs(case, t, kind)
    got, want = _both(kind, *args, jax_fn=jax_da._paged_lax)
    assert got.shape == want.shape == args[0].shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=_tol(kind, args[2]), rtol=0)


def test_plain_matches_pallas_interpret_at_a_chunk_width():
    args = _sm90_inputs("d64_bs16_slot0_mid_prefix", 80, "int8")
    got, want = _both("int8", *args, jax_fn=jax_da._paged_pallas)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name,t,route,chunk,sm90_chunk", [
    ("paged_decode", 17, "sm90", 1, 1),  # the chunk kernel's first t
    ("paged_decode_q8", 256, "sm90", 1, 1),
    ("paged_decode", 16, "sm90", 0, 0),  # the split-K kernel's last t
    ("paged_decode", 256, "cuda_core", 1, 0),  # f32 q: CUDA cores at any t
    ("paged_decode_q8", 1, "sm90", 0, 0),
])
def test_chunk_launches_are_counted_by_route(monkeypatch, name, t, route, chunk, sm90_chunk):
    # a synthetic launch, counted in a copy, so no later test in this
    # process reads it as a real one
    monkeypatch.setattr(pt_da, "COUNTS", dict(pt_da.COUNTS))
    before = dict(pt_da.COUNTS)
    pt_da._count(name, t, route)
    moved = {key for key in pt_da.COUNTS if pt_da.COUNTS[key] != before[key]}
    sm90 = route == "sm90"
    want = {name: 1, f"{name}_sm90": sm90, f"{name}_chunk": chunk,
            f"{name}_sm90_chunk": sm90_chunk}
    assert {key: pt_da.COUNTS[key] - before[key] for key in want} == want
    # besides the multi-query counts of 1 < t <= 16, nothing else moves
    assert {key for key in moved if not key.endswith("_multi")} == {
        key for key, n in want.items() if n}


def test_chunk_rows_and_splits_come_from_shapes():
    """The chunk kernel takes 64-query tiles, and its split count, like
    split-K's, from the table width and block size alone."""
    assert [pt_da.paged_rows(t) for t in (1, 4, 16, 17, 256)] == [1, 4, 4, 64, 64]
    assert pt_da.PAGED_CHUNK_SPLIT_KEYS % 128 == 0
    # phase 18's chunk over a 512-token prefix: a 64-block table of 16
    assert pt_da.paged_splits(64, 16, pt_da.PAGED_CHUNK_SPLIT_KEYS) == -(
        -1024 // pt_da.PAGED_CHUNK_SPLIT_KEYS)
