"""PyTorch port on the card: the flash-decode, paged-decode, flash
attention (K3-K6) and fused LayerNorm (K1/K2) CUDA kernels against their
plain PyTorch versions on the same CUDA inputs, and the serving and
training paths on the card against the CPU.

Marked ``cuda``; each test skips itself when there is no card.  Imports
no JAX, so it runs on a GPU machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
Tolerances: float32 1e-4 (summation order and the four-warp merge differ
from the plain loop), bfloat16 2e-2 absolute in float32 (probabilities
are rounded to bf16 before p @ v on both sides, at different points of
the sum), int8 1e-4 (the plain version's dequantization math in another
order; the tensor-core prefill keeps p * v_scale as a bf16 high and low
part, within ~2^-17 of itself).
The flash kernels have their own limits (``FLASH_TOL``, ``BF16_ROW_TOL``,
``BF16_DIFFER_TOL``, the values of ``chip_smoke.py`` phase 9).
"""

import numpy as np
import pytest
import torch

from paddlefleetx_tpu_torch.ops import decode_attention as da

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 1e-4}

# request D's eight prompts in the 64-token bucket, left-padded
D_PADS = [64 - n for n in (12, 20, 28, 36, 44, 52, 60, 64)]

# (b, n, t, d, L, limit, kv_valid_from).  bf16 q at d = 64 or 128 takes the
# sm90 route, over bf16 or int8 caches: its split-K kernel up to t = 16
# (bf16: 64-key stages at d = 64, 32 at d = 128; int8: 128 and 64), its
# tensor-core prefill (128-key tiles at d = 64, 64 at d = 128) above.  The
# "odd" shapes put cache lengths, limits, pads and split boundaries off
# multiples of 4 keys (the int8 kernels' scale slices, 4 bytes a key)
SHAPES = {
    "decode_gpt345m_b8": (8, 16, 1, 64, 1024, 517, None),
    "prefill_left_pad": (3, 16, 70, 64, 256, 70, [0, 13, 69]),
    "chunk_unaligned": (2, 4, 5, 64, 99, 60, [7, 0]),
    "decode_head_dim_128": (2, 8, 1, 128, 300, 300, [40, 0]),
    "decode_small_head_dim": (2, 4, 3, 8, 40, 40, None),
    "decode_main_path_step": (8, 16, 1, 64, 96, 80, D_PADS),
    "prefill_request_d": (8, 16, 64, 64, 96, 64, D_PADS),
    "verify_t16": (2, 4, 16, 64, 300, 200, [0, 70]),
    "prefill_t17": (2, 4, 17, 64, 300, 200, [0, 70]),
    "decode_b1_split_k": (1, 16, 1, 64, 1024, 1024, None),
    "decode_b8_long_split_k": (8, 16, 1, 64, 1024, 1024, [0, 3, 100, 700, 0, 64, 1000, 1023]),
    "decode_d128_split_k": (1, 8, 1, 128, 1024, 1000, [300]),
    "prefill_d128": (2, 4, 100, 128, 512, 400, [0, 130]),
    "decode_pad_cuts_tile": (2, 4, 1, 64, 512, 500, [70, 3]),
    "decode_pad_skips_tiles": (2, 4, 1, 64, 512, 500, [300, 257]),
    "prefill_pad_cuts_tile": (2, 4, 200, 64, 512, 450, [70, 3]),
    "prefill_pad_skips_tiles": (2, 4, 300, 64, 512, 500, [260, 400]),
    "prefill_limit_mid_tile": (2, 4, 500, 64, 512, 500, [0, 1]),
    "decode_b1_split_k_short": (1, 16, 1, 64, 1024, 700, [5]),
    "decode_b1_split_k_odd": (1, 16, 1, 64, 1023, 1021, [7]),
    "decode_odd": (2, 4, 1, 64, 301, 291, [37, 130]),
    "decode_d128_limit_is_odd_L": (2, 4, 1, 128, 203, 203, [0, 65]),
    "verify_t4_odd": (2, 4, 4, 64, 151, 147, [66, 3]),
    "verify_t16_d128_odd": (2, 4, 16, 128, 150, 133, [70, 1]),
    "prefill_t64_d128_limit_is_odd_L": (2, 4, 64, 128, 267, 267, [65, 195]),
    "prefill_t64_odd": (2, 4, 64, 64, 299, 299, [131, 262]),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(name, kv_dtype, dev, seed=0):
    b, n, t, d, L, limit, vf = SHAPES[name]
    g = torch.Generator().manual_seed(seed)
    qdt = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    q = torch.randn(b, n, t, d, generator=g).to(dev, qdt)
    k = torch.randn(b, n, L, d, generator=g)
    v = torch.randn(b, n, L, d, generator=g)
    ks = vs = None
    if kv_dtype == torch.int8:
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
        ks, vs = ks.to(dev), vs.to(dev)
    k, v = k.to(dev, kv_dtype), v.to(dev, kv_dtype)
    vf = None if vf is None else torch.tensor(vf, dtype=torch.int32, device=dev)
    return q, k, v, limit, vf, 1.0 / d**0.5, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_plain(name, kv_dtype):
    dev = _card()
    q, k, v, limit, vf, scale, ks, vs = _case(name, kv_dtype, dev)
    key = "flash_decode_q8" if kv_dtype == torch.int8 else "flash_decode"
    before = dict(da.COUNTS)
    got = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    torch.cuda.synchronize()
    assert da.COUNTS[key] == before[key] + 1
    # bf16 q at d = 64 / 128 on the sm90 route (bf16 or int8 caches),
    # everything else off it
    t, d = q.shape[2], q.shape[3]
    sm90 = int(da.kernel_route(q.dtype, d) == "sm90")
    assert da.COUNTS[f"{key}_sm90"] == before[f"{key}_sm90"] + sm90
    assert da.COUNTS[f"{key}_sm90_prefill"] == (
        before[f"{key}_sm90_prefill"] + sm90 * int(t > da.SPLIT_MAX_ROWS))
    other = "flash_decode" if key == "flash_decode_q8" else "flash_decode_q8"
    assert all(da.COUNTS[k] == before[k]
               for k in (other, f"{other}_sm90", f"{other}_sm90_prefill"))
    ref = da.decode_attention_plain(q, k, v, limit, vf, da.decode_block(k.shape[2]),
                                    scale, ks, vs)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= TOL[kv_dtype], err
    if vf is not None:
        t = q.shape[2]
        for row, pad in enumerate(vf.tolist()):
            first_real = pad - (limit - t)  # query rows before it see no key
            if first_real > 0:
                assert (got[row, :, :first_real] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_gpt345m_b8", "prefill_request_d",
                                  "decode_b1_split_k_short"])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
def test_kernel_never_reads_past_limit(kv_dtype, name):
    """NaN in every cache slot at or past ``limit`` (int8: in every scale
    there, the slots at the int8 extremes; t = 1 and t = 64, a split-K decode
    over several splits): the output must not change."""
    dev = _card()
    q, k, v, limit, vf, scale, ks, vs = _case(name, kv_dtype, dev)
    ref = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    if kv_dtype == torch.int8:
        for x in (ks, vs):
            x[:, :, limit:] = float("nan")
        k[:, :, limit:] = 127
        v[:, :, limit:] = -128
    else:
        k[:, :, limit:] = float("nan")
        v[:, :, limit:] = float("nan")
    got = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_b1_split_k", "decode_b8_long_split_k",
                                  "decode_d128_split_k", "verify_t16", "prefill_request_d"])
def test_kernel_is_bitwise_repeatable(name):
    """The split-K kernel combines its partials in split order whichever
    CTA arrives last, and the prefill has no atomics: the same inputs give
    the same bits on every call."""
    dev = _card()
    q, k, v, limit, vf, scale, _, _ = _case(name, torch.bfloat16, dev)
    first = da.flash_decode(q, k, v, limit, vf, scale)
    for _ in range(3):
        again = da.flash_decode(q, k, v, limit, vf, scale)
        torch.cuda.synchronize()
        assert torch.equal(again, first)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_b1_split_k_odd", "decode_b8_long_split_k",
                                  "decode_d128_split_k", "verify_t16", "prefill_request_d",
                                  "prefill_t64_d128_limit_is_odd_L"])
def test_q8_kernel_is_bitwise_repeatable(name):
    """The int8 kernels on the sm90 route: split order for the partials,
    no atomics in the prefill, the same bits on every call."""
    dev = _card()
    q, k, v, limit, vf, scale, ks, vs = _case(name, torch.int8, dev)
    first = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    for _ in range(3):
        again = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
        torch.cuda.synchronize()
        assert torch.equal(again, first)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    q, k, v, limit, vf, scale, _, _ = _case("chunk_unaligned", torch.bfloat16, dev)
    with pytest.raises(ValueError):
        da.flash_decode(q.float(), k, v, limit, vf, scale)  # dtype mismatch
    with pytest.raises(ValueError):
        da.flash_decode(q, k.transpose(2, 3), v, limit, vf, scale)  # wrong layout
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, limit, vf.cpu(), scale)  # device mismatch
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, k.shape[2] + 1, vf, scale)  # limit past the cache
    q, k, v, limit, vf, scale, ks, vs = _case("chunk_unaligned", torch.int8, dev)
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, limit, vf, scale, ks)  # one scale without the other
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, limit, vf, scale, ks.bfloat16(), vs)  # scale dtype
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, limit, vf, scale, ks[:, :, :-1], vs)  # scale shape
    with pytest.raises(ValueError):
        da.flash_decode(q, k.float(), v, limit, vf, scale, ks, vs)  # int8 caches only


@pytest.mark.cuda
def test_generation_on_card_matches_cpu():
    dev = _card()
    from paddlefleetx_tpu_torch.models.gpt import generation as gen_mod
    from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
    from paddlefleetx_tpu_torch.models.gpt.model import GPTModel, init_params

    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2, num_attention_heads=4,
                    max_position_embeddings=128, dtype="float32")
    model = init_params(GPTModel(cfg), torch.Generator().manual_seed(0))
    gen = gen_mod.GenerationConfig(max_dec_len=8, decode_strategy="greedy_search",
                                   eos_token_id=-1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 90, size=n).tolist() for n in (5, 12)]
    ids, lens = gen_mod.pad_prompts(prompts, 0, 8)
    cpu = gen_mod.generate(model, ids, gen, prompt_lens=lens)
    before = da.COUNTS["flash_decode"]
    card = gen_mod.generate(model.to(dev), ids.to(dev), gen, prompt_lens=lens.to(dev))
    assert da.COUNTS["flash_decode"] > before
    assert torch.equal(card.cpu(), cpu)


# (b, n, t, d, bs, M, positions): paged decode / verify / chunk over
# shuffled pool blocks, each row's table null-padded past its last needed
# block.  bf16 q at d = 64 or 128 and bs 8-128 takes the sm90 route: for t
# <= 16 split-K of 256 keys over bulk copies (key stages of 64 / 32 bf16
# keys at d = 64 / 128, 128 / 64 int8 keys), above it the tensor-core chunk
# kernel (64-query tiles, key tiles of 128 / 64 keys at d = 64 / 128
# assembled block by block, 256 keys a split); every other case the
# CUDA-core one.  The skew cases are chip_smoke.py's PAGED_POS (rows of 6
# to 1027 keys: 1 to 5 splits), "main_path_step" its phase-7 decode step
# halfway.  The chunk cases start mid-block, cross a 64-query tile, take
# blocks of 8 (16 a key tile), 64 and 128 (a block larger than a d = 128
# key tile: one copy a tile-sized run) and rows over several splits
PAGED_POS = [5, 17, 80, 200, 511, 700, 1000, 1023]
PAGED_SHAPES = {
    "decode_gpt345m_b8": (8, 16, 1, 64, 16, 128, PAGED_POS),
    "verify_t4_gpt345m": (8, 16, 4, 64, 16, 128, PAGED_POS),
    "block8_boundaries": (3, 4, 2, 64, 8, 8, [7, 15, 0]),
    "block32_head_dim_128": (2, 8, 1, 128, 32, 4, [31, 100]),
    "block24_head_dim_8": (2, 4, 3, 8, 24, 4, [10, 60]),
    "verify_t16": (2, 4, 16, 64, 16, 8, [0, 40]),
    "main_path_step": (8, 16, 1, 64, 16, 8, [n + 16 for n in (12, 20, 28, 36, 44, 52, 60, 64)]),
    "block8_head_dim_128": (3, 8, 1, 128, 8, 64, [300, 37, 511]),
    "block64_head_dim_128": (2, 8, 4, 128, 64, 16, [700, 63]),
    "block128_head_dim_128": (3, 8, 1, 128, 128, 8, [1000, 127, 128]),
    "block8_long_rows": (2, 4, 1, 64, 8, 128, [1000, 517]),
    "verify_t16_mid_block": (3, 4, 16, 64, 16, 16, [37, 5, 100]),
    "verify_t16_head_dim_128": (2, 4, 16, 128, 32, 8, [3, 150]),
    "verify_t16_long_rows": (2, 4, 16, 64, 16, 64, [600, 33]),
    "verify_t17": (2, 4, 17, 64, 16, 8, [3, 60]),
    "chunk_t80_block8_mid_block": (2, 4, 80, 64, 8, 32, [13, 150]),
    "chunk_t64_head_dim_128_block64": (2, 4, 64, 128, 64, 8, [100, 7]),
    "chunk_t130_block128": (2, 4, 130, 64, 128, 4, [300, 0]),
    "chunk_t100_head_dim_128_block128": (2, 4, 100, 128, 128, 4, [200, 37]),
    "chunk_t17_long_rows": (2, 4, 17, 64, 16, 64, [600, 33]),
    "chunk_t256_head_dim_128_block8": (1, 4, 256, 128, 8, 128, [517]),
}
# the cases whose bf16 q (bf16 and int8 pools) leave the sm90 route
PAGED_CUDA_CORE = {"block24_head_dim_8"}


def _paged_case(name, kv_dtype, dev, seed=0):
    b, n, t, d, bs, M, pos = PAGED_SHAPES[name]
    g = torch.Generator().manual_seed(seed)
    nb = b * M + 1
    ids = torch.randperm(nb - 1, generator=g)[: b * M].reshape(b, M) + 1
    for i, p in enumerate(pos):
        ids[i, (p + t - 1) // bs + 1:] = 0  # null-block padding
    qdt = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    q = torch.randn(b, t, n, d, generator=g).to(dev, qdt)
    k = torch.randn(nb, n, bs, d, generator=g)
    v = torch.randn(nb, n, bs, d, generator=g)
    ks = vs = None
    if kv_dtype == torch.int8:
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
        ks, vs = ks.to(dev), vs.to(dev)
    k, v = k.to(dev, kv_dtype), v.to(dev, kv_dtype)
    tables = ids.to(dev, torch.int32)
    positions = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, k, v, tables, positions, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", sorted(PAGED_SHAPES))
def test_paged_kernel_matches_plain(name, kv_dtype):
    dev = _card()
    q, k, v, tables, positions, ks, vs = _paged_case(name, kv_dtype, dev)
    key = "paged_decode_q8" if kv_dtype == torch.int8 else "paged_decode"
    route = da.paged_kernel_route(q.dtype, q.shape[-1], q.shape[1], k.shape[2])
    assert route == ("cuda_core" if kv_dtype == torch.float32 or name in PAGED_CUDA_CORE
                     else "sm90")
    before = dict(da.COUNTS)
    q_t = q.transpose(1, 2).contiguous()
    scale = 1.0 / q.shape[-1] ** 0.5
    got = da._paged_launch(q_t, k, v, tables, positions, scale, ks, vs)  # float32 out
    torch.cuda.synchronize()
    assert da.COUNTS[key] == before[key] + 1
    assert da.COUNTS[f"{key}_sm90"] == before[f"{key}_sm90"] + (route == "sm90")
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, positions, scale, ks, vs)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= TOL[kv_dtype], err
    # the wrapper the engine calls: [b, t, n, d] in q's dtype, against the
    # plain output given the same layout and cast
    out = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    assert da.COUNTS[key] == before[key] + 2
    assert out.dtype == q.dtype and out.shape == q.shape
    want = ref.transpose(1, 2).to(q.dtype).float()
    assert (out.float() - want).abs().max().item() <= TOL[q.dtype]


def _poison_past_bounds(k, v, ks, vs, tables, positions, t):
    """NaN in every pool block no row can see (the null block included,
    which pads the tables) and in the slots of each row's last block past
    its bound, positions + t - 1; int8 pools: NaN scales there, the
    payload at the int8 extremes."""
    bs = k.shape[2]
    seen = set()
    for i, p in enumerate(positions.tolist()):
        last = (p + t - 1) // bs
        seen.update(tables[i, : last + 1].tolist())
    cuts = [(blk, slice(None)) for blk in range(k.shape[0]) if blk not in seen]
    for i, p in enumerate(positions.tolist()):
        cuts.append((int(tables[i, (p + t - 1) // bs]), slice((p + t - 1) % bs + 1, None)))
    for blk, sl in cuts:
        if ks is None:
            k[blk, :, sl] = float("nan")
            v[blk, :, sl] = float("nan")
        else:
            ks[blk, :, sl] = float("nan")
            vs[blk, :, sl] = float("nan")
            k[blk, :, sl] = 127
            v[blk, :, sl] = -128


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["decode_gpt345m_b8", "block8_boundaries", "verify_t4_gpt345m",
                                  "verify_t16_mid_block", "block128_head_dim_128",
                                  "chunk_t80_block8_mid_block", "chunk_t100_head_dim_128_block128",
                                  "chunk_t17_long_rows"])
def test_paged_kernel_never_reads_past_a_rows_bound(name, kv_dtype):
    """Every pool block a row cannot see, and every slot of a row's last
    block past its bound, is NaN-poisoned: the result must not change, on
    either route (f32: the CUDA-core kernel, bf16 / int8: sm90, split-K or
    the chunk kernel)."""
    dev = _card()
    q, k, v, tables, positions, ks, vs = _paged_case(name, kv_dtype, dev)
    clean = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    _poison_past_bounds(k, v, ks, vs, tables, positions, q.shape[1])
    got = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["decode_gpt345m_b8", "verify_t4_gpt345m", "block8_long_rows",
                                  "block64_head_dim_128", "verify_t16_long_rows",
                                  "chunk_t17_long_rows", "chunk_t256_head_dim_128_block8"])
def test_paged_sm90_kernel_is_bitwise_repeatable(name, kv_dtype):
    """Rows over several splits: the last split to arrive merges them in
    split order, so two calls give the same bits."""
    dev = _card()
    q, k, v, tables, positions, ks, vs = _paged_case(name, kv_dtype, dev)
    assert da.paged_kernel_route(q.dtype, q.shape[-1], q.shape[1], k.shape[2]) == "sm90"
    assert da.paged_splits(tables.shape[1], k.shape[2]) > 1
    a = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    b = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_paged_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    q, k, v, tables, positions, _, _ = _paged_case("block8_boundaries", torch.bfloat16, dev)
    with pytest.raises(ValueError):
        da.paged_decode_attention(q, k, v, tables.long(), positions)  # int64 tables
    with pytest.raises(ValueError):
        da.paged_decode_attention(q, k, v, tables, positions.cpu())  # device mismatch
    with pytest.raises(ValueError):
        da.paged_decode_attention(q.float(), k, v, tables, positions)  # dtype mismatch
    with pytest.raises(ValueError):
        da.paged_decode_attention(q, k[:, :, :4], v[:, :, :4], tables, positions)  # block 4
    q_t = q.float().transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="sm90 route"):  # f32 q is not the sm90 route's
        da._paged_launch(q_t, k.float(), v.float(), tables, positions, 0.125, None, None,
                         route="sm90")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_engine_on_card_matches_cpu(kv_dtype):
    """The continuous-batching engine at float32: greedy tokens on the
    card (paged kernel) equal the CPU's (plain version), including a row
    admitted mid-decode."""
    dev = _card()
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

    cfg = process_configs(AttrDict.from_nested({
        "Global": {"seed": 1},
        "Engine": {"mix_precision": {"enable": False}},
        "Model": {"module": "GPTModule", "vocab_size": 96, "hidden_size": 64,
                  "num_layers": 2, "num_attention_heads": 4,
                  "max_position_embeddings": 128, "dtype": "float32"},
        "Generation": {"max_dec_len": 8, "decode_strategy": "greedy_search",
                       "pad_to_multiple": 8, "eos_token_id": -1, "pad_token_id": 0},
    }))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 90, size=n).tolist() for n in (5, 12, 3)]
    outs = {}
    for device in ("cpu", "cuda"):
        module = GPTModule(cfg)
        server = GenerationServer(cfg, module, module.init_model(1, device),
                                  torch.device(device))
        eng = PagedDecodeEngine(server, max_batch=4, kv_dtype=kv_dtype)
        before = dict(da.COUNTS)
        slots = [eng.admit(prompts[0], 8), eng.admit(prompts[1], 8)]
        eng.step()
        slots.append(eng.admit(prompts[2], 8))
        for _ in range(16):
            eng.step()
        outs[device] = [eng.slots[s].tokens for s in slots]
        used = {key: da.COUNTS[key] - before[key] for key in da.COUNTS}
        if device == "cuda":
            key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
            assert used[key] > 0 and used["paged_plain"] == 0, used
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# speculative decoding: K7 / K8 / K9 at the verify chunk's t = draft_k + 1
# ---------------------------------------------------------------------------

# t = 5 (draft_k 4, the served default), 8, 16 (the split-K kernels' and the
# sm90 paged route's last t) and 17 (K7/K8's tensor-core prefill, K9's
# CUDA-core kernel).  Rows sit at rewound positions: the rejected tail of
# an earlier, longer chunk stays past each query's causal bound, NaN here.
VERIFY_TS = [5, 8, 16, 17]
VERIFY_LENS = (12, 20, 28, 36, 44, 52, 60, 64)  # chip_smoke.py's request D


def _multi_delta(before, key, t, sm90):
    """The multi-query and prefill counts one launch at ``t`` should add."""
    multi = int(1 < t <= da.SPLIT_MAX_ROWS)
    return {f"{key}_multi": multi, f"{key}_sm90_multi": multi * sm90,
            f"{key}_sm90": sm90}


@pytest.mark.cuda
@pytest.mark.parametrize("t", VERIFY_TS)
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_contiguous_verify_chunk_over_a_stale_tail(kv_dtype, t):
    """K7 (bf16 caches) and K8 (int8) against the plain version at request
    D's rows (batch 8, 16 heads, d = 64, left pads), the chunk at
    positions [pos, pos + t) of a cache rewound to pos = 80; NaN in every
    slot at or past pos + t (int8: NaN scales, the payload at the int8
    extremes) leaves the output bitwise unchanged."""
    dev = _card()
    b, n, d, pos = 8, 16, 64, 80
    L = pos + 16 + 1 + 4  # the bucket, the decode budget and draft_k slack
    limit = pos + t
    g = torch.Generator().manual_seed(t)
    q = torch.randn(b, n, t, d, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(b, n, L, d, generator=g)
    v = torch.randn(b, n, L, d, generator=g)
    ks = vs = None
    if kv_dtype == torch.int8:
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
        ks, vs = ks.to(dev), vs.to(dev)
    k, v = k.to(dev, kv_dtype), v.to(dev, kv_dtype)
    vf = torch.tensor([64 - x for x in VERIFY_LENS], dtype=torch.int32, device=dev)
    scale = 1.0 / d**0.5
    key = "flash_decode_q8" if kv_dtype == torch.int8 else "flash_decode"
    before = dict(da.COUNTS)
    clean = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    torch.cuda.synchronize()
    for name, want in _multi_delta(before, key, t, 1).items():
        assert da.COUNTS[name] - before[name] == want, name
    assert da.COUNTS[f"{key}_sm90_prefill"] - before[f"{key}_sm90_prefill"] == int(t > 16)
    ref = da.decode_attention_plain(q, k, v, limit, vf, da.decode_block(L), scale, ks, vs)
    assert (clean - ref).abs().max().item() <= TOL[kv_dtype]
    if ks is None:
        k[:, :, limit:] = float("nan")
        v[:, :, limit:] = float("nan")
    else:
        ks[:, :, limit:] = float("nan")
        vs[:, :, limit:] = float("nan")
        k[:, :, limit:] = 127
        v[:, :, limit:] = -128
    got = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("t", VERIFY_TS)
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_paged_verify_chunk_over_a_stale_tail(kv_dtype, t):
    """K9 against its plain version at the continuous path's verify chunk:
    batch 8, 16 heads, d = 64, block 16, rows at request D's lengths plus
    16 generated tokens, each table holding the row's reserved blocks
    (positions + t plus draft_k slack, so blocks past the bound are in the
    table); NaN past every query's bound positions + j + 1, in the row's
    last block and in its slack blocks, leaves the output bitwise
    unchanged.  Every t takes the sm90 route: t <= 16 its split-K kernel,
    t = 17 its tensor-core chunk kernel."""
    dev = _card()
    b, n, d, bs = 8, 16, 64, 16
    positions = [x + 16 for x in VERIFY_LENS]
    g = torch.Generator().manual_seed(t)
    need = [(p + t - 1 + 16) // bs + 1 for p in positions]  # reserved: + slack
    M = 1
    while M < max(need):
        M *= 2
    nb = sum(need) + 1
    ids = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    tables = torch.zeros((b, M), dtype=torch.int32)
    at = 0
    for i, c in enumerate(need):
        tables[i, :c] = torch.tensor(ids[at:at + c], dtype=torch.int32)
        at += c
    q = torch.randn(b, t, n, d, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(nb, n, bs, d, generator=g)
    v = torch.randn(nb, n, bs, d, generator=g)
    ks = vs = None
    if kv_dtype == torch.int8:
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
        ks, vs = ks.to(dev), vs.to(dev)
    k, v = k.to(dev, kv_dtype), v.to(dev, kv_dtype)
    tables = tables.to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    route = da.paged_kernel_route(q.dtype, d, t, bs)
    assert route == "sm90"
    key = "paged_decode_q8" if kv_dtype == torch.int8 else "paged_decode"
    before = dict(da.COUNTS)
    clean = da.paged_decode_attention(q, k, v, tables, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    for name, want in _multi_delta(before, key, t, 1).items():
        assert da.COUNTS[name] - before[name] == want, name
    assert da.COUNTS[f"{key}_sm90_chunk"] - before[f"{key}_sm90_chunk"] == int(t > 16)
    q_t = q.transpose(1, 2).contiguous()
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, pos, 1.0 / d**0.5, ks, vs)
    want = ref.transpose(1, 2).to(q.dtype).float()
    assert (clean.float() - want).abs().max().item() <= TOL[torch.bfloat16]
    _poison_past_bounds(k, v, ks, vs, tables, pos, t)
    got = da.paged_decode_attention(q, k, v, tables, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, clean)


# ---------------------------------------------------------------------------
# chunked prefill and a prefix hit's suffix: K9 at t = chunk width
# ---------------------------------------------------------------------------

# (t, position): one row, 16 heads, d = 64, block 16.  A 256-token chunk
# opening a long prompt and one over a 512-token cached prefix, a prefix
# hit's 64-token suffix bucket over it, t = 16 (the split-K kernel's last),
# t = 17 (the chunk kernel's first) and a chunk that starts mid-block
CHUNK_CASES = [(256, 0), (256, 512), (64, 512), (16, 512), (17, 512), (80, 517)]


def _chunk_case(t, pos, kv_dtype, dev, seed=0):
    n, d, bs = 16, 64, 16
    g = torch.Generator().manual_seed(seed + t + pos)
    need = (pos + t - 1) // bs + 1
    M = 1
    while M < need:
        M *= 2
    nb = need + 2
    tables = torch.zeros((1, M), dtype=torch.int32)
    tables[0, :need] = torch.randperm(nb - 1, generator=g)[:need].to(torch.int32) + 1
    q = torch.randn(1, t, n, d, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(nb, n, bs, d, generator=g)
    v = torch.randn(nb, n, bs, d, generator=g)
    ks = vs = None
    if kv_dtype == torch.int8:
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
        ks, vs = ks.to(dev), vs.to(dev)
    k, v = k.to(dev, kv_dtype), v.to(dev, kv_dtype)
    positions = torch.tensor([pos], dtype=torch.int32, device=dev)
    return q, k, v, tables.to(dev), positions, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("t,pos", CHUNK_CASES)
def test_paged_chunk_over_a_cached_prefix(t, pos, kv_dtype):
    """K9 at chunk width against its plain version (bf16 2e-2, int8 1e-4):
    every t takes the sm90 route, t > 16 its tensor-core chunk kernel,
    counted in ``*_chunk`` and ``*_sm90_chunk``, t = 16 its split-K one;
    NaN in the null block, in the spare block and past the last query's
    bound leaves the output bitwise unchanged, and two calls give the same
    bits."""
    dev = _card()
    q, k, v, tables, positions, ks, vs = _chunk_case(t, pos, kv_dtype, dev)
    route = da.paged_kernel_route(q.dtype, 64, t, 16)
    assert route == "sm90"
    key = "paged_decode_q8" if kv_dtype == torch.int8 else "paged_decode"
    before = dict(da.COUNTS)
    q_t = q.transpose(1, 2).contiguous()
    scale = 1.0 / 8.0
    got = da._paged_launch(q_t, k, v, tables, positions, scale, ks, vs)
    torch.cuda.synchronize()
    chunk = int(t > da.SPLIT_MAX_ROWS)
    assert da.COUNTS[f"{key}_chunk"] - before[f"{key}_chunk"] == chunk
    assert da.COUNTS[f"{key}_sm90_chunk"] - before[f"{key}_sm90_chunk"] == chunk
    assert da.COUNTS[f"{key}_sm90"] - before[f"{key}_sm90"] == 1
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, positions, scale, ks, vs)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL[kv_dtype]
    clean = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    again = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    _poison_past_bounds(k, v, ks, vs, tables, positions, t)
    poisoned = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(again, clean)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("t,pos,n_valid", [(64, 512, 21), (256, 0, 200), (80, 37, 70)])
def test_paged_padded_chunk_table(t, pos, n_valid, kv_dtype):
    """A chunk of ``n_valid`` prompt tokens padded to t, as the engine
    launches it: its table repeats the row's last real block past it (so
    pad queries never meet the null block), null past that.  The chunk
    kernel against its plain version on the same table (bf16 2e-2, int8
    1e-4); NaN in every pool block the table does not name, the null block
    included, leaves the output bitwise unchanged."""
    dev = _card()
    q, k, v, tables, positions, ks, vs = _chunk_case(t, pos, kv_dtype, dev)
    bs = k.shape[2]
    real = (pos + n_valid - 1) // bs
    tables[0, real + 1:(pos + t - 1) // bs + 1] = tables[0, real]
    key = "paged_decode_q8" if kv_dtype == torch.int8 else "paged_decode"
    before = dict(da.COUNTS)
    q_t = q.transpose(1, 2).contiguous()
    got = da._paged_launch(q_t, k, v, tables, positions, 1.0 / 8.0, ks, vs)
    torch.cuda.synchronize()
    assert da.COUNTS[f"{key}_sm90_chunk"] - before[f"{key}_sm90_chunk"] == 1
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, positions, 1.0 / 8.0, ks, vs)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL[kv_dtype]
    clean = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    named = set(tables[0, : (pos + t - 1) // bs + 1].tolist())
    for blk in range(k.shape[0]):
        if blk not in named:
            if ks is None:
                k[blk] = float("nan")
                v[blk] = float("nan")
            else:
                ks[blk] = float("nan")
                vs[blk] = float("nan")
    poisoned = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunked_prefix_engine_on_card_matches_cpu(kv_dtype):
    """The engine at float32 with chunked prefill (chunk 32), the prefix
    cache and its spill tier: a long prompt streaming in next to a
    decoding row, then a shared-prefix family that hits, spills and
    readmits.  Greedy tokens and the reuse accounting on the card (K9
    chunk launches, no plain call) equal the CPU's."""
    dev = _card()
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

    cfg = process_configs(AttrDict.from_nested({
        "Global": {"seed": 1},
        "Engine": {"mix_precision": {"enable": False}},
        "Model": {"module": "GPTModule", "vocab_size": 96, "hidden_size": 64,
                  "num_layers": 2, "num_attention_heads": 4,
                  "max_position_embeddings": 256, "dtype": "float32"},
        "Generation": {"max_dec_len": 8, "decode_strategy": "greedy_search",
                       "pad_to_multiple": 16, "eos_token_id": -1, "pad_token_id": 0},
    }))
    rng = np.random.default_rng(0)
    pa, pb = rng.integers(1, 90, 48).tolist(), rng.integers(1, 90, 48).tolist()
    short, long_ = rng.integers(1, 90, 5).tolist(), rng.integers(1, 90, 150).tolist()
    family = [pa + [3, 4, 5], pb + [6, 7], pa + [8, 9, 10, 11]]
    outs = {}
    for device in ("cpu", "cuda"):
        module = GPTModule(cfg)
        server = GenerationServer(cfg, module, module.init_model(1, device),
                                  torch.device(device))
        eng = PagedDecodeEngine(server, max_batch=4, block=16, kv_dtype=kv_dtype,
                                prefill_chunk=32, prefix_cache_blocks=3,
                                prefix_spill_bytes=1 << 26)
        before = dict(da.COUNTS)
        s0 = eng.admit(short, 8)
        eng.step()
        s1 = eng.admit(long_, 8)
        toks = []
        while eng.active.any() or any(r is not None and not r.prefill_done for r in eng.slots):
            for slot in eng.step():
                toks.append(list(eng.slots[slot].tokens))
                eng.release(slot)
        for p in family:
            slot = eng.admit(p, 8)
            while eng.slots[slot].tokens == [] or eng.active[slot]:
                eng.step()
            toks.append(list(eng.slots[slot].tokens))
            eng.release(slot)
        used = {key: da.COUNTS[key] - before[key] for key in da.COUNTS}
        outs[device] = (toks, dict(eng.cache.prefix.stats), dict(eng.cache.spill.stats),
                        eng.stats["prefill_tokens"], eng.stats["prefill_chunks"])
        if device == "cuda":
            key = "paged_decode_q8" if kv_dtype == "int8" else "paged_decode"
            assert used[f"{key}_chunk"] > 0 and used["paged_plain"] == 0, used
        del s0, s1
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"][1]["hits"] >= 1 and outs["cpu"][2]["readmits"] >= 1


def _spec_card_server(dev, draft_k, kv_dtype="bf16"):
    """A bf16 TINY model at head dim 64 (hidden 128, 2 heads, 2 layers,
    vocab 96) on the card, so both attention kernels take their sm90
    routes, with ``Generation.speculative.draft_k``."""
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

    cfg = process_configs(AttrDict.from_nested({
        "Global": {"seed": 3},
        "Engine": {"mix_precision": {"enable": False}},
        "Model": {"module": "GPTModule", "vocab_size": 96, "hidden_size": 128,
                  "num_layers": 2, "num_attention_heads": 2,
                  "max_position_embeddings": 128, "dtype": "bfloat16"},
        "Generation": {"max_dec_len": 24, "decode_strategy": "greedy_search",
                       "pad_to_multiple": 8, "eos_token_id": -1, "pad_token_id": 0,
                       "speculative": {"draft_k": draft_k, "kv_dtype": kv_dtype}},
    }))
    module = GPTModule(cfg)
    return GenerationServer(cfg, module, module.init_model(3, dev), dev)


# an answer token's logit under its prefix's argmax, in bf16 ulps of the
# argmax (chip_smoke.py's SPEC_ULPS): the verify chunk's GEMMs and attention
# run at t = k + 1 and round differently from the t = 1 step, which flips
# near-ties of the top two logits; a wrongly accepted draft sits far below
SPEC_ULPS = 4.0


def _deficit_ulps(server, prompt, answer):
    """Teacher-force ``prompt + answer`` through the server's model (one
    prefill over a cache of its KV dtype): the largest gap, in bf16 ulps
    of the argmax, between an answer token's logit and its prefix's
    argmax."""
    import math

    from paddlefleetx_tpu_torch.models.gpt import generation as gen_mod

    ids = torch.tensor([prompt + answer], device=server.device)
    with torch.inference_mode():
        cache = gen_mod.init_cache(server.module.config, 1, ids.shape[1], server.device,
                                   kv_dtype=server.kv_dtype)
        lg = gen_mod.forward_cached(server.model, ids, cache, 0)[0].float()
    lg = lg[len(prompt) - 1: len(prompt) - 1 + len(answer)]
    top = lg.max(dim=-1).values.tolist()
    chosen = lg.gather(-1, torch.tensor(answer, device=server.device)[:, None])[:, 0].tolist()
    return max((a - c) / 2.0 ** (math.floor(math.log2(max(abs(a), 2.0**-126))) - 7)
               for a, c in zip(top, chosen))


@pytest.mark.cuda
@pytest.mark.parametrize("draft_k", [4, 16])
@pytest.mark.parametrize("scheduler", ["coalesce", "continuous"])
def test_spec_serving_on_card_matches_plain(scheduler, draft_k):
    """Greedy speculation on the card against the plain loop, on both
    schedulers: every token of either answer is its prefix's argmax up to
    SPEC_ULPS (the two agree up to a near-tie of the top two bf16 logits).
    draft_k 4 verifies at t = 5 (K7's split-K kernel, K9's sm90 route);
    draft_k 16 at t = 17, where K7 takes its tensor-core prefill and K9
    its tensor-core chunk kernel."""
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine

    dev = _card()
    rng = np.random.default_rng(0)
    # a 24-token bucket: the coalescing path's prefill takes K7's prefill
    # kernel, so its multi-query launches are the verify chunks'
    prompts = [rng.integers(1, 90, size=n).tolist() for n in (5, 20, 3, 9)]
    outs, used, worst = {}, {}, {}
    for k in (0, draft_k):
        server = _spec_card_server(dev, k)
        assert (server.spec is None) == (k == 0)
        before = dict(da.COUNTS)
        if scheduler == "coalesce":
            outs[k] = server.generate_ids(prompts, max_dec_len=24)
        else:
            eng = PagedDecodeEngine(server, max_batch=4, block=16)
            slots = [eng.admit(p, 24) for p in prompts[:2]]
            eng.step()
            slots += [eng.admit(p, 24) for p in prompts[2:]]  # admitted mid-decode
            while eng.active.any():
                eng.step()
            outs[k] = [eng.slots[s].tokens for s in slots]
        used[k] = {key: da.COUNTS[key] - before[key] for key in da.COUNTS}
        worst[k] = max(_deficit_ulps(server, p, a) for p, a in zip(prompts, outs[k]))
    assert [len(a) for a in outs[draft_k]] == [len(a) for a in outs[0]] == [24] * 4
    assert max(worst.values()) <= SPEC_ULPS, (worst, outs)
    got = used[draft_k]
    assert got["plain"] == 0 and got["paged_plain"] == 0, got
    if scheduler == "coalesce":
        if draft_k == 16:  # every verify chunk on the tensor-core prefill
            assert got["flash_decode_sm90_prefill"] > 0 and got["flash_decode_multi"] == 0
        else:
            assert got["flash_decode_sm90_multi"] == got["flash_decode_multi"] > 0
    elif draft_k == 16:  # K9 past t = 16: the sm90 route's chunk kernel
        assert got["paged_decode_sm90"] == got["paged_decode"] > 0, got
        assert got["paged_decode_sm90_chunk"] == got["paged_decode_chunk"] > 0, got
    else:
        assert got["paged_decode_sm90_multi"] == got["paged_decode"] > 0, got


# ---------------------------------------------------------------------------
# flash attention: K3 (forward), K4 + K5 (split backward), K6 (fused)
# ---------------------------------------------------------------------------

# Kernel vs plain, the plain version at each kernel's own tile (fa.kernel_tile:
# bf16 on the tensor cores K3 128 x 128, K4 128 x 64, K5 and K6 64 x 128;
# f32 64 x 64), a partial last tile included.  float32 (fwd, grads): max
# |err|, and max |err| over the leaf's max.  bfloat16, per kernel: the
# largest error of a row over that row's largest value, and the share of
# elements that differ at all: set at 2-4x the CUDA-core kernels' readings;
# the tensor-core K4-K6 read up to 0.93 of the share's limit at head dim
# 128 (PERF.md).  float16 takes bfloat16's rules with its own ulp (2**-10
# of a value, 2**-7 for bf16): the row limit 8x tighter (two ulps either
# way), the share 16x wider (a float32 sum of another order straddles one of
# the type's rounding boundaries 8x as often when they lie 8x as close, and
# p and ds, rounded to the type before their products, flip 8x as often
# too: chip_smoke.py's ROW_SCALE and DIFFER_SCALE).
FLASH_TOL = {torch.float32: (1e-4, 2e-4)}
BF16_ROW_TOL = {"fwd": 2.0**-6, "split": 2.0**-6, "fused": 2.0**-6}
BF16_DIFFER_TOL = {"fwd": 5e-4, "split": 1.5e-3, "fused": 1.5e-3}
ROW_SCALE = {torch.bfloat16: 1.0, torch.float16: 2.0**-3}
DIFFER_SCALE = {torch.bfloat16: 1.0, torch.float16: 16.0}


def flash_blocks(fa, dtype):
    """The block each kernel's plain version runs at to round as the
    kernel does: the kernel's own tile on its route for ``dtype``."""
    return {name: fa.kernel_tile(name, dtype) for name in fa.KERNELS}


def _flash_case(dtype, d, s, dev, bh=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(bh, s, d, generator=g).to(dev, dtype) for _ in range(4))
    return q, k, v, do


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / max(1.0, ref.float().abs().max())).item()


def _row_err(got, ref):
    diff = (got.float() - ref.float()).abs()
    return (diff.amax(-1) / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _differ(got, ref):
    return (got.float() != ref.float()).float().mean().item()


def _hold(kernel, got, ref, record):
    """The flash limits above for one output; records the readings."""
    dtype = got.dtype
    readings = {"abs": (got.float() - ref.float()).abs().max().item(),
                "of_max": _rel_err(got, ref), "row": _row_err(got, ref),
                "differ": _differ(got, ref)}
    record(readings)
    if dtype == torch.float32:
        key = "abs" if kernel == "fwd" else "of_max"
        assert readings[key] <= FLASH_TOL[dtype][kernel != "fwd"], (kernel, readings)
    else:
        assert readings["row"] <= BF16_ROW_TOL[kernel] * ROW_SCALE[dtype], (kernel, readings)
        assert readings["differ"] <= BF16_DIFFER_TOL[kernel] * DIFFER_SCALE[dtype], (kernel,
                                                                                      readings)


def _match_plain(dtype, d, s, bh, record_property):
    """K3's out and lse, then K4's dq, K5's dk/dv and K6's dq/dk/dv from
    the same lse, against the plain versions at each kernel's own tile, so
    both round alike; bf16 and f16 by the tensor-core route, f32 by the
    CUDA-core one (the *_sm90 counts rise for bf16 and f16 only).  K6 adds dq with
    reductions in a varying order: a tolerance, not bitwise.  The readings
    go to the junit XML (``record_property``)."""
    dev = _card()
    from paddlefleetx_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(dtype, d, s, dev, bh=bh)
    scale, blocks = 1.0 / d**0.5, flash_blocks(fa, dtype)
    before = dict(fa.COUNTS)
    out, lse = fa.launch_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward(q, k, v, scale, blocks["flash_fwd"])
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _hold("fwd", out, ref_out, lambda r: record_property("fwd_out", r))
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = (do.float() * ref_out.float()).sum(-1)
    args = (q, k, v, do, ref_lse, delta, scale)
    # K4, K5 and K6 each against its plain version at its own tile
    for mode, names, launch, plain, block in (
            ("split", ("dq",), fa.launch_bwd_dq, fa.flash_bwd_dq, blocks["flash_bwd_dq"]),
            ("split", ("dk", "dv"), fa.launch_bwd_dkv, fa.flash_bwd_dkv,
             blocks["flash_bwd_dkv"]),
            ("fused", ("dq", "dk", "dv"), fa.launch_bwd_fused, fa.flash_bwd_fused,
             blocks["flash_bwd_fused"])):
        got, ref = launch(*args), plain(*args, block)
        torch.cuda.synchronize()
        if len(names) == 1:
            got, ref = (got,), (ref,)
        for name, a, b in zip(names, got, ref):
            assert a.dtype == dtype and torch.isfinite(a).all(), (mode, name)
            _hold(mode, a, b, lambda r: record_property(f"{mode}_{name}", r))
    used = {key: fa.COUNTS[key] - before[key] for key in fa.COUNTS}
    sm90 = int(dtype != torch.float32)
    assert used == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                    "flash_bwd_fused": 1, "flash_fwd_sm90": sm90,
                    "flash_bwd_dq_sm90": sm90, "flash_bwd_dkv_sm90": sm90,
                    "flash_bwd_fused_sm90": sm90, "flash_plain": 0}, used


@pytest.mark.cuda
@pytest.mark.parametrize("s", [40, 200, 1024])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_flash_kernels_match_plain(dtype, d, s, record_property):
    _match_plain(dtype, d, s, 6, record_property)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernels_match_plain_with_more_ctas_than_sms(d, dtype, record_property):
    """b*h = 256 at seq 1024: 2048 CTAs for each of K3-K6, many waves of
    the 132 SMs (bf16 and f16, the tensor-core route)."""
    _match_plain(dtype, d, 1024, 256, record_property)


@pytest.mark.cuda
def test_flash_f16_overflow_becomes_inf():
    """Under a float16 loss scale a gradient past 65504 must reach the grads
    as inf (so the step is skipped), never as the largest finite value:
    dO scaled by 2**15 overflows ds, dq, dk and dv in the plain version and
    in K4-K6 alike, and no output holds a saturated +-65504."""
    dev = _card()
    from paddlefleetx_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_case(torch.float16, 64, 256, dev, bh=2)
    do = (do.float() * 2.0**15).half()
    scale, blocks = 0.125, flash_blocks(fa, torch.float16)
    out, lse = fa.launch_fwd(q, k, v, scale)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale)
    for got, ref in ((fa.launch_bwd_split(*args), fa.flash_bwd_split(*args, blocks["flash_bwd_dq"])),
                     (fa.launch_bwd_fused(*args),
                      fa.flash_bwd_fused(*args, blocks["flash_bwd_fused"]))):
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert not torch.isfinite(b).all() and not torch.isfinite(a).all()
            assert not ((a.abs() == 65504) & ~torch.isfinite(b)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("flash_bwd", ["split", "fused"])
def test_flash_dispatch_takes_the_kernels_at_any_seq(flash_bwd, monkeypatch):
    """seq 300 is off the block ladder: on the CPU ``attention(impl=
    "flash")`` warns and takes the plain path, on the card it launches
    K3 and K4 + K5 or K6 and never the plain path; out and grads agree
    at float32."""
    dev = _card()
    from paddlefleetx_tpu_torch.ops import attention as attn
    from paddlefleetx_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((2, 300, 2, 64)).astype(np.float32) for _ in range(4))
    assert not fa.flash_supported(300)
    res = {}
    for device in ("cpu", "cuda"):
        xs = [torch.tensor(x, device=device, requires_grad=True) for x in (q, k, v)]
        before = dict(fa.COUNTS)
        if device == "cpu":
            with pytest.warns(UserWarning, match="flash attention unsupported"):
                out = attn.attention(*xs, impl="flash", flash_bwd=flash_bwd)
        else:
            def refuse(*args, **kwargs):
                raise AssertionError("the plain attention path ran on the card")

            monkeypatch.setattr(attn, "xla_attention", refuse)
            out = attn.attention(*xs, impl="flash", flash_bwd=flash_bwd)
        out.backward(torch.tensor(do, device=device))
        torch.cuda.synchronize()
        used = {key: fa.COUNTS[key] - before[key] for key in fa.COUNTS}
        res[device] = [t.detach().cpu() for t in (out, *(x.grad for x in xs))]
        if device == "cuda":
            bwd = ({"flash_bwd_fused": 1} if flash_bwd == "fused"
                   else {"flash_bwd_dq": 1, "flash_bwd_dkv": 1})
            assert used == dict(dict.fromkeys(fa.COUNTS, 0), flash_fwd=1, **bwd), used
        else:
            assert all(n == 0 for n in used.values()), used
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _rel_err(a, b) <= 2e-4


@pytest.mark.cuda
def test_flash_kernel_is_causal():
    """Changing the last key and value leaves every earlier row's output."""
    dev = _card()
    from paddlefleetx_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_case(torch.float32, 64, 200, dev)
    out1, _ = fa.launch_fwd(q, k, v, 0.125)
    k[:, -1], v[:, -1] = 99.0, 99.0
    out2, _ = fa.launch_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out1[:, :-1], out2[:, :-1])


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    from paddlefleetx_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_case(torch.bfloat16, 64, 128, dev)
    with pytest.raises(ValueError):
        fa.launch_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                      v[..., :32].contiguous(), 0.1)  # head dim 32
    with pytest.raises(ValueError):
        fa.launch_fwd(q.double(), k.double(), v.double(), 0.1)  # float64
    with pytest.raises(ValueError):
        fa.launch_fwd(q, k.float(), v, 0.1)  # mixed types
    with pytest.raises(ValueError):
        fa.launch_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 0.1)  # strides
    with pytest.raises(ValueError):
        fa.launch_fwd(q, k.cpu(), v, 0.1)  # device mismatch
    with pytest.raises(ValueError):
        fa.launch_fwd(q[None], k[None], v[None], 0.1)  # not [bh, s, d]
    # the tensor-core route (bf16 K3-K6): a misaligned tensor, and mixed types
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    lse = torch.zeros(q.shape[:2], dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fa.launch_fwd(odd, k, v, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_fused(q, k, odd, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_fused(q.half(), k, v, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dq(q, k, odd, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dkv(odd, k, v, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dq(q, k.half(), v, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dkv(q, k, v, q.half(), lse, lse, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("flash_bwd", ["split", "fused"])
def test_train_step_on_card_matches_cpu(flash_bwd):
    """A small GPT (head dim 64, selective recompute) at float32: the loss
    and every grad on the card (K3-K6) against the CPU (plain versions)."""
    dev = _card()
    from paddlefleetx_tpu_torch.models.gpt import model as gpt
    from paddlefleetx_tpu_torch.models.gpt.bridge import grads_to_jax, params_to_jax
    from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
    from paddlefleetx_tpu_torch.ops import flash_attention as fa

    cfg = GPTConfig(vocab_size=96, hidden_size=128, num_layers=2, num_attention_heads=2,
                    max_position_embeddings=128, dtype="float32", attn_impl="flash",
                    flash_bwd=flash_bwd, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0, use_recompute=True,
                    recompute_granularity="selective")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 96, (2, 96)), "labels": rng.integers(0, 96, (2, 96)),
             "loss_mask": np.ones((2, 96), np.float32)}
    res = {}
    for device in ("cpu", "cuda"):
        model = gpt.init_params(gpt.GPTModel(cfg, trainable=True),
                                torch.Generator().manual_seed(3)).to(device)
        before = dict(fa.COUNTS)
        loss = gpt.loss_fn(model, {k_: torch.as_tensor(x).to(device) for k_, x in batch.items()},
                           cfg)
        loss.backward()
        res[device] = (loss.item(), grads_to_jax(model), params_to_jax(model))
        used = {key: fa.COUNTS[key] - before[key] for key in fa.COUNTS}
        if device == "cuda":
            kernel = "flash_bwd_fused" if flash_bwd == "fused" else "flash_bwd_dq"
            assert used["flash_fwd"] == 2 and used[kernel] == 2 and used["flash_plain"] == 0
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for (a, b) in zip(_leaves(res["cuda"][1]), _leaves(res["cpu"][1])):
        assert np.abs(a - b).max() <= 1e-3 * max(np.abs(b).max(), 1e-12)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


# ---------------------------------------------------------------------------
# fused LayerNorm (K1 forward, K2 backward)
# ---------------------------------------------------------------------------

# (rows, n): the training path's micro-batch, rows and n that are not
# multiples of anything (the kernels take any), one row, a wide row.
# The register paths of K1 and K2 take "gpt345m", "odd" and "one_row", and
# "at_cap" in bf16 (fl.REGISTER_MAX_N); "past_cap" (one bf16 vector past
# the bf16 cap) and "above_cap" are aligned but wider than the caps, "tiny"
# and "wide" no multiple of the 16-byte vector: those take the strided paths
LN_SHAPES = {"gpt345m": (8192, 1024), "odd": (8191, 1000), "tiny": (5, 7), "one_row": (1, 64),
             "wide": (300, 4097), "above_cap": (300, 4096), "at_cap": (300, 2048),
             "past_cap": (300, 2056)}
# float32: summation order only; bfloat16 and float16: outputs within one
# ulp of their type (2**-7, 2**-10 of the value) of the plain version's, the
# float32 sums of the two differing in order; dscale/dbias (float32 sums
# over the rows) 1e-4 of the largest
LN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2.0**-7),
          torch.float16: (1e-5, 2.0**-10)}
LN_DTYPES = dict(argvalues=[torch.float32, torch.bfloat16, torch.float16],
                 ids=["f32", "bf16", "f16"])


def _ln_case(rows, n, dtype, with_res, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, n, generator=g).to(dev, dtype)
    res = torch.randn(rows, n, generator=g).to(dev, dtype) if with_res else None
    scale = torch.randn(n, generator=g).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    gy = torch.randn(rows, n, generator=g).to(dev, dtype)
    return x, res, scale, bias, gy


@pytest.mark.cuda
@pytest.mark.parametrize("with_res", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("name", sorted(LN_SHAPES))
@pytest.mark.parametrize("dtype", **LN_DTYPES)
def test_fused_ln_kernels_match_plain(dtype, name, with_res, record_property):
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    dev = _card()
    x, res, scale, bias, gy = _ln_case(*LN_SHAPES[name], dtype, with_res, dev)
    atol, rtol = LN_TOL[dtype]
    record_property("register_vecs", fl.register_vecs(x.dtype, x.shape[1], x.data_ptr()))
    before = dict(fl.COUNTS)
    y, mean, rstd = fl.launch_fwd(x, res, scale, bias, 1e-5)
    dx, dscale, dbias = fl.launch_bwd(x, res, scale, mean, rstd, gy)
    torch.cuda.synchronize()
    assert fl.COUNTS["fused_ln_fwd"] == before["fused_ln_fwd"] + 1
    assert fl.COUNTS["fused_ln_bwd"] == before["fused_ln_bwd"] + 1
    ref_y, ref_mean, ref_rstd = fl.layer_norm_fwd_plain(x, res, scale, bias, 1e-5)
    ref_dx, ref_ds, ref_db = fl.layer_norm_bwd_plain(x, res, scale, ref_mean, ref_rstd, gy)
    assert y.dtype == dx.dtype == dtype and dscale.dtype == torch.float32
    torch.testing.assert_close(mean, ref_mean, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, ref_rstd, rtol=1e-5, atol=0)
    torch.testing.assert_close(y.float(), ref_y.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(dx.float(), ref_dx.float(), rtol=rtol, atol=atol)
    for what, got, ref in (("dscale", dscale, ref_ds), ("dbias", dbias, ref_db)):
        err = (got - ref).abs().max().item()
        record_property(f"{what}_err", err)
        assert err <= 1e-4 * max(ref.abs().max().item(), 1.0), (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt345m", "odd", "above_cap"])
@pytest.mark.parametrize("dtype", **LN_DTYPES)
def test_fused_ln_bwd_is_bitwise_repeatable(dtype, name):
    """K2's sums run in a fixed order on both of its paths: the same inputs
    give the same dx, dscale and dbias bits on every call."""
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    dev = _card()
    x, res, scale, bias, gy = _ln_case(*LN_SHAPES[name], dtype, True, dev)
    _, mean, rstd = fl.launch_fwd(x, res, scale, bias, 1e-5)
    first = fl.launch_bwd(x, res, scale, mean, rstd, gy)
    for _ in range(3):
        again = fl.launch_bwd(x, res, scale, mean, rstd, gy)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt345m", "odd", "at_cap", "past_cap", "tiny"])
@pytest.mark.parametrize("dtype", **LN_DTYPES)
def test_fused_ln_fwd_is_bitwise_repeatable(dtype, name):
    """K1 sums each row in a fixed order on both of its paths: the same
    inputs give the same y, mean and rstd bits on every call."""
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    dev = _card()
    x, res, scale, bias, _ = _ln_case(*LN_SHAPES[name], dtype, True, dev)
    first = fl.launch_fwd(x, res, scale, bias, 1e-5)
    for _ in range(3):
        again = fl.launch_fwd(x, res, scale, bias, 1e-5)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gpt345m", "tiny"])
def test_fused_ln_f16_overflow_becomes_inf(name):
    """float16 stores round to nearest: an output past 65504 is inf in K1's
    y and K2's dx, as in the plain version, never a saturated value (the
    register path at "gpt345m", the strided one at "tiny")."""
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    dev = _card()
    x, res, scale, bias, gy = _ln_case(*LN_SHAPES[name], torch.float16, True, dev)
    scale = scale * 2.0**16
    y, mean, rstd = fl.launch_fwd(x, res, scale, bias, 1e-5)
    dx, _, _ = fl.launch_bwd(x, res, scale, mean, rstd, gy)
    ref_y, ref_mean, ref_rstd = fl.layer_norm_fwd_plain(x, res, scale, bias, 1e-5)
    ref_dx, _, _ = fl.layer_norm_bwd_plain(x, res, scale, ref_mean, ref_rstd, gy)
    torch.cuda.synchronize()
    for got, ref in ((y, ref_y), (dx, ref_dx)):
        assert torch.equal(torch.isinf(got), torch.isinf(ref)) and torch.isinf(ref).any()


@pytest.mark.cuda
def test_fused_ln_wrapper_rejects_what_the_kernel_does_not_take():
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    dev = _card()
    x, res, scale, bias, gy = _ln_case(16, 64, torch.bfloat16, True, dev)
    with pytest.raises(ValueError):
        fl.launch_fwd(x.double(), None, scale, bias, 1e-5)  # float64
    with pytest.raises(ValueError):
        fl.launch_fwd(x, None, scale.bfloat16(), bias, 1e-5)  # bf16 scale
    with pytest.raises(ValueError):
        fl.launch_fwd(x, res.float(), scale, bias, 1e-5)  # mixed types
    with pytest.raises(ValueError):
        fl.launch_fwd(x.t(), None, scale, bias, 1e-5)  # strides
    with pytest.raises(ValueError):
        fl.launch_fwd(x, None, scale.cpu(), bias, 1e-5)  # device mismatch
    with pytest.raises(ValueError):
        fl.fused_ln_fwd(x.double(), None, scale, bias, 1e-5)  # the op: no fallback either
    # a dtype code no kernel takes is refused by the entry point itself
    with pytest.raises(RuntimeError):
        fl._call("fused_ln_fwd", x.data_ptr(), None, scale.data_ptr(), bias.data_ptr(),
                 x.data_ptr(), x.data_ptr(), x.data_ptr(), 16, 64, 1e-5, 3,
                 torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,vpl", [
    (torch.bfloat16, 1024, 4), (torch.bfloat16, 1000, 4), (torch.bfloat16, 64, 1),
    (torch.bfloat16, 256, 1), (torch.bfloat16, 264, 2), (torch.bfloat16, 2048, 8),
    (torch.bfloat16, 2056, 0), (torch.bfloat16, 1001, 0), (torch.bfloat16, 1004, 0),
    (torch.float32, 1024, 8), (torch.float32, 1028, 0), (torch.float32, 1000, 8),
    (torch.float32, 128, 1), (torch.float32, 1022, 0), (torch.float32, 7, 0),
    (torch.float16, 1024, 4), (torch.float16, 2048, 8), (torch.float16, 2056, 0),
    (torch.float16, 1001, 0),
])
def test_register_path_follows_dtype_width_and_alignment(dtype, n, vpl):
    """The path K1 and K2 take, as their library chooses it: 16-byte
    vectors per lane covering the row, or 0 for the strided path; the
    register cap is ``fl.REGISTER_MAX_N``."""
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    _card()
    assert fl.register_vecs(dtype, n, 4096, None, 8192) == vpl
    assert vpl == 0 or fl.REGISTER_MAX_N[dtype] >= n
    per = 4 if dtype == torch.float32 else 8
    cap = fl.REGISTER_MAX_N[dtype]
    assert fl.register_vecs(dtype, cap, 4096) > 0 == fl.register_vecs(dtype, cap + per, 4096)
    # one tensor off the 16-byte grid sends every width to the strided path
    assert fl.register_vecs(dtype, n, 4096, 4104) == 0


@pytest.mark.cuda
def test_fused_ln_train_on_card_matches_cpu():
    """The GPT loss and every grad with use_fused_ln (selective recompute,
    flash fused) at float32: on the card K1/K2 (9 and 5 launches for two
    layers), against the CPU's plain versions."""
    dev = _card()
    from paddlefleetx_tpu_torch.models.gpt import model as gpt
    from paddlefleetx_tpu_torch.models.gpt.bridge import grads_to_jax
    from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    cfg = GPTConfig(vocab_size=96, hidden_size=128, num_layers=2, num_attention_heads=2,
                    max_position_embeddings=128, dtype="float32", attn_impl="flash",
                    flash_bwd="fused", hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0, use_recompute=True,
                    recompute_granularity="selective", use_fused_ln=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 96, (2, 96)), "labels": rng.integers(0, 96, (2, 96)),
             "loss_mask": np.ones((2, 96), np.float32)}
    res = {}
    for device in ("cpu", dev):
        model = gpt.init_params(gpt.GPTModel(cfg, trainable=True),
                                torch.Generator().manual_seed(3)).to(device)
        before = dict(fl.COUNTS)
        loss = gpt.loss_fn(model, {k_: torch.as_tensor(x).to(device) for k_, x in batch.items()},
                           cfg)
        loss.backward()
        res[str(device)] = (loss.item(), grads_to_jax(model))
        used = {key: fl.COUNTS[key] - before[key] for key in fl.COUNTS}
        if device != "cpu":
            assert used == {"fused_ln_fwd": 9, "fused_ln_bwd": 5, "fused_ln_fwd_plain": 0,
                            "fused_ln_bwd_plain": 0}, used
    cu, cp = res[str(dev)], res["cpu"]
    assert abs(cu[0] - cp[0]) <= 1e-5 * abs(cp[0])
    for (a, b) in zip(_leaves(cu[1]), _leaves(cp[1])):
        assert np.abs(a - b).max() <= 1e-3 * max(np.abs(b).max(), 1e-12)


# ---------------------------------------------------------------------------
# float16 routes of K7, K8 and K9 (a float16 model served): float16 q at d =
# 64 / 128 takes the sm90 kernels at every t (split-K, the tensor-core
# prefill and chunk kernels), over float16 caches and pools or int8 ones;
# other head dims and blocks take the CUDA-core kernels.  Selected with
# ``-k f16``.
# ---------------------------------------------------------------------------

F16_KV = dict(argvalues=[torch.float16, torch.int8], ids=["f16", "int8"])


def _f16_tol(kv_dtype, v):
    """float16 caches: the kernel and the plain version each round p to
    float16 once before P.V, at other points of the sum (the kernel against
    its lane group's or tile's running max): at most 2^-10 of max |v|, plus
    2e-5 of float32 summation order.  int8 caches under float16 q: float32
    math on both sides, bf16's 1e-4."""
    if kv_dtype == torch.int8:
        return TOL[torch.int8]
    return 2.0**-10 * v.float().abs().max().item() + 2e-5


def _as_f16(case):
    """A case of :func:`_case` or :func:`_paged_case` with q (and native
    caches or pools) in float16: the same draws, rounded to float16."""
    q, k, v, *rest = case
    if k.dtype != torch.int8:
        k, v = k.to(torch.float16), v.to(torch.float16)
    return (q.to(torch.float16), k, v, *rest)


def _f16_contiguous(name, kv_dtype, dev, seed=0):
    return _as_f16(_case(name, torch.float32 if kv_dtype == torch.float16 else kv_dtype, dev,
                         seed))


def _f16_paged(name, kv_dtype, dev, seed=0):
    return _as_f16(_paged_case(name, torch.float32 if kv_dtype == torch.float16 else kv_dtype,
                               dev, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", **F16_KV)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_f16_kernel_matches_plain(name, kv_dtype):
    dev = _card()
    q, k, v, limit, vf, scale, ks, vs = _f16_contiguous(name, kv_dtype, dev)
    key = "flash_decode_q8" if kv_dtype == torch.int8 else "flash_decode"
    t, d = q.shape[2], q.shape[3]
    route = da.kernel_route(q.dtype, d)
    assert route == ("sm90" if d in (64, 128) else "cuda_core")
    before = dict(da.COUNTS)
    got = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    torch.cuda.synchronize()
    sm90 = int(route == "sm90")
    assert da.COUNTS[key] - before[key] == 1 and da.COUNTS[f"{key}_f16"] - before[f"{key}_f16"] == 1
    assert da.COUNTS[f"{key}_sm90"] - before[f"{key}_sm90"] == sm90
    assert da.COUNTS[f"{key}_sm90_prefill"] - before[f"{key}_sm90_prefill"] == (
        sm90 * int(t > da.SPLIT_MAX_ROWS))
    assert da.COUNTS["plain"] == before["plain"]
    ref = da.decode_attention_plain(q, k, v, limit, vf, da.decode_block(k.shape[2]), scale, ks, vs)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= _f16_tol(kv_dtype, v), err
    # the wrapper generation calls: q's type, [b, t, n, d]
    out = da.decode_attention(q.transpose(1, 2), k, v, limit - t, kv_valid_from=vf,
                              k_scale=ks, v_scale=vs)
    assert out.dtype == torch.float16 and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_gpt345m_b8", "prefill_request_d",
                                  "decode_b1_split_k_short", "prefill_d128"])
@pytest.mark.parametrize("kv_dtype", **F16_KV)
def test_f16_kernel_never_reads_past_limit_and_repeats(kv_dtype, name):
    """NaN past ``limit`` (int8: in the scales, the payload at the int8
    extremes) leaves the float16 routes' output bitwise unchanged, and a
    repeat call gives the same bits."""
    dev = _card()
    q, k, v, limit, vf, scale, ks, vs = _f16_contiguous(name, kv_dtype, dev)
    ref = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    again = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    if kv_dtype == torch.int8:
        for x in (ks, vs):
            x[:, :, limit:] = float("nan")
        k[:, :, limit:] = 127
        v[:, :, limit:] = -128
    else:
        k[:, :, limit:] = float("nan")
        v[:, :, limit:] = float("nan")
    got = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(again, ref)
    assert torch.isfinite(got).all() and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", **F16_KV)
@pytest.mark.parametrize("name", sorted(PAGED_SHAPES))
def test_f16_paged_kernel_matches_plain(name, kv_dtype):
    dev = _card()
    q, k, v, tables, positions, ks, vs = _f16_paged(name, kv_dtype, dev)
    key = "paged_decode_q8" if kv_dtype == torch.int8 else "paged_decode"
    t = q.shape[1]
    route = da.paged_kernel_route(q.dtype, q.shape[-1], t, k.shape[2])
    assert route == ("cuda_core" if name in PAGED_CUDA_CORE else "sm90")
    before = dict(da.COUNTS)
    q_t = q.transpose(1, 2).contiguous()
    scale = 1.0 / q.shape[-1] ** 0.5
    got = da._paged_launch(q_t, k, v, tables, positions, scale, ks, vs)
    torch.cuda.synchronize()
    chunk = int(route == "sm90" and t > da.SPLIT_MAX_ROWS)
    assert da.COUNTS[key] - before[key] == 1 and da.COUNTS[f"{key}_f16"] - before[f"{key}_f16"] == 1
    assert da.COUNTS[f"{key}_sm90"] - before[f"{key}_sm90"] == int(route == "sm90")
    assert da.COUNTS[f"{key}_sm90_chunk"] - before[f"{key}_sm90_chunk"] == chunk
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, positions, scale, ks, vs)
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= _f16_tol(kv_dtype, v), err
    out = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    assert out.dtype == torch.float16 and out.shape == q.shape and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", **F16_KV)
@pytest.mark.parametrize("name", ["decode_gpt345m_b8", "verify_t4_gpt345m", "block8_boundaries",
                                  "block128_head_dim_128", "chunk_t80_block8_mid_block",
                                  "chunk_t100_head_dim_128_block128", "chunk_t17_long_rows",
                                  "chunk_t256_head_dim_128_block8"])
def test_f16_paged_kernel_never_reads_past_a_rows_bound_and_repeats(name, kv_dtype):
    """NaN in every block no row sees (the null block too) and past each
    row's bound in its last block leaves the float16 routes' output bitwise
    unchanged (split-K and the chunk kernel), and two calls give the same
    bits."""
    dev = _card()
    q, k, v, tables, positions, ks, vs = _f16_paged(name, kv_dtype, dev)
    clean = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    again = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    _poison_past_bounds(k, v, ks, vs, tables, positions, q.shape[1])
    got = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(again, clean)
    assert torch.isfinite(got).all() and torch.equal(got, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5, 64], ids=["split_k", "verify", "prefill"])
def test_f16_values_near_float16_max_are_neither_clamped_nor_nan(t):
    """V of +-65504 (float16's largest finite value) through K7 and K9 on
    their float16 routes: the float32 outputs equal the plain version's
    within the float16 rule, every row that sees one key returns that key's
    V exactly (+-65504, neither clamped nor NaN), and the float16 wrapper
    output holds them exactly."""
    dev = _card()
    g = torch.Generator().manual_seed(t)
    b, n, d, L = 2, 4, 64, 128
    limit = 100
    q = torch.randn(b, n, t, d, generator=g).to(dev, torch.float16)
    k = torch.randn(b, n, L, d, generator=g).to(dev, torch.float16)
    sign = torch.randint(0, 2, (b, n, L, d), generator=g) * 2 - 1
    v = (65504.0 * sign).to(dev, torch.float16)
    # row 1's first query sees exactly one key (the one at limit - t)
    vf = torch.tensor([0, limit - t], dtype=torch.int32, device=dev)
    scale = 1.0 / d**0.5
    got = da.flash_decode(q, k, v, limit, vf, scale)
    ref = da.decode_attention_plain(q, k, v, limit, vf, da.decode_block(L), scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= _f16_tol(torch.float16, v)
    one = got[1, :, 0]
    assert torch.equal(one, v[1, :, limit - t].float())
    out = da.decode_attention(q.transpose(1, 2), k, v, limit - t, kv_valid_from=vf)
    assert torch.equal(out[1, 0].float(), v[1, :, limit - t].float())
    # K9: one row at slot 0 (its first query sees one key), one mid-table
    bs = 16
    M = 8
    nb = b * M + 1
    pk = torch.randn(nb, n, bs, d, generator=g).to(dev, torch.float16)
    psign = torch.randint(0, 2, (nb, n, bs, d), generator=g) * 2 - 1
    pv = (65504.0 * psign).to(dev, torch.float16)
    tables = (torch.randperm(nb - 1, generator=g)[: b * M].reshape(b, M) + 1).to(dev, torch.int32)
    positions = torch.tensor([0, 37], dtype=torch.int32, device=dev)
    qp = torch.randn(b, t, n, d, generator=g).to(dev, torch.float16)
    q_t = qp.transpose(1, 2).contiguous()
    pgot = da._paged_launch(q_t, pk, pv, tables, positions, scale, None, None)
    pref = da.paged_decode_attention_plain(q_t, pk, pv, tables, positions, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(pgot).all()
    assert (pgot - pref).abs().max().item() <= _f16_tol(torch.float16, pv)
    first = pv[int(tables[0, 0])][:, 0].float()  # slot 0 of row 0: [n, d]
    assert torch.equal(pgot[0, :, 0], first)
    pout = da.paged_decode_attention(qp, pk, pv, tables, positions)
    assert torch.equal(pout[0, 0].float(), first)


# ---------------------------------------------------------------------------
# the continuous engine's decode and verify steps as CUDA graphs
# ---------------------------------------------------------------------------

# TINY's depth (2 layers) at head dim 64, so K9 takes its sm90 route (a
# bf16 or float16 model) as at GPT-345M
GRAPH_KINDS = {"bf16": ("bfloat16", "bf16"), "int8": ("bfloat16", "int8"),
               "float16": ("float16", "bf16")}


def _graph_server(dtype, strategy="greedy_search", max_pos=128, **gen):
    from paddlefleetx_tpu_torch.core.module import GPTModule
    from paddlefleetx_tpu_torch.core.serving import GenerationServer
    from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

    cfg = process_configs(AttrDict.from_nested({
        "Global": {"seed": 1},
        "Engine": {"mix_precision": {"enable": False}},
        "Model": {"module": "GPTModule", "vocab_size": 96, "hidden_size": 256,
                  "num_layers": 2, "num_attention_heads": 4,
                  "max_position_embeddings": max_pos, "dtype": dtype},
        "Generation": {"max_dec_len": 24, "decode_strategy": strategy, "pad_to_multiple": 8,
                       "eos_token_id": -1, "pad_token_id": 0, **gen},
    }))
    module = GPTModule(cfg)
    return GenerationServer(cfg, module, module.init_model(1, "cuda"), torch.device("cuda"))


def _graph_traffic(eng, prompts, steps=6):
    """Two short rows, then a row whose table is twice as wide (a second
    graph key), stepped to the end; returns (tokens, the pending logits
    after every step)."""
    slots = [eng.admit(prompts[0], 20), eng.admit(prompts[1], 20)]
    seen = []
    for _ in range(steps):
        eng.step()
        seen.append(eng._logits.clone())
    slots.append(eng.admit(prompts[2], 20))
    while eng.active.any():
        eng.step()
        seen.append(eng._logits.clone())
    torch.cuda.synchronize()
    return [list(eng.slots[s].tokens) for s in slots], seen


@pytest.mark.cuda
@pytest.mark.parametrize("draft_k", [0, 3], ids=["decode", "verify"])
@pytest.mark.parametrize("kind", sorted(GRAPH_KINDS))
def test_step_graph_replay_is_bitwise_the_eager_step(kind, draft_k):
    """The captured decode (t = 1) and verify (t = draft_k + 1) steps at two
    table widths: every replay's tokens and pending logits equal the eager
    engine's bit for bit, and a replay's K9 launches are counted as the
    eager step's are (one a layer, all on the sm90 route)."""
    _card()
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
    from paddlefleetx_tpu_torch.ops.speculative import SpecConfig

    dtype, kv = GRAPH_KINDS[kind]
    server = _graph_server(dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 90, size=n).tolist() for n in (5, 9)] + [[7, 8] * 30]
    spec = SpecConfig(draft_k=draft_k) if draft_k else None
    key = "paged_decode_q8" if kv == "int8" else "paged_decode"
    runs = {}
    for graphs in (False, True):
        eng = PagedDecodeEngine(server, max_batch=4, block=16, kv_dtype=kv, spec=spec,
                                graphs=graphs)
        before = dict(da.COUNTS)
        tokens, seen = _graph_traffic(eng, prompts)
        used = {k: da.COUNTS[k] - before[k] for k in da.COUNTS}
        runs[graphs] = (tokens, seen, used, eng)
    (t0, s0, u0, e0), (t1, s1, u1, e1) = runs[False], runs[True]
    assert t1 == t0 and all(len(t) == 20 for t in t1)
    assert len(s1) == len(s0) and all(torch.equal(a, b) for a, b in zip(s0, s1))
    steps = e1.stats["steps"]
    assert steps == e0.stats["steps"] and u1 == u0
    assert u1[key] == u1[f"{key}_sm90"] == 2 * steps and u1["paged_plain"] == 0
    if draft_k:
        assert u1[f"{key}_sm90_multi"] == u1[key]
    g = e1.graphs.stats
    assert g["graphs"] == 2 and g["graph_replays"] == steps - 2 and e0.graphs is None


@pytest.mark.cuda
def test_split_scratch_pointers_stay_across_captures():
    """Rows long enough for several K9 splits a row: the engine reserves
    the split-K scratch once, and captures at two table widths (and the
    eager chunk launches between them) never move the pair a graph holds."""
    _card()
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine

    server = _graph_server("bfloat16", max_pos=1024)
    eng = PagedDecodeEngine(server, max_batch=4, block=16, prefill_chunk=256, graphs=True)
    dev = torch.device("cuda")
    part, counters = da.split_scratch(dev)
    ptrs = (part.data_ptr(), counters.data_ptr())
    rng = np.random.default_rng(1)
    eng.admit(rng.integers(1, 90, size=300).tolist(), 8)
    while eng.active.any() or any(r is not None and not r.prefill_done for r in eng.slots):
        eng.step()
    eng.admit(rng.integers(1, 90, size=700).tolist(), 8)
    while eng.active.any() or any(r is not None and not r.prefill_done for r in eng.slots):
        eng.step()
    torch.cuda.synchronize()
    assert eng.graphs.stats["graphs"] == 2
    held = eng.graphs._held
    assert held and held[0][0].data_ptr() == ptrs[0] and held[0][1].data_ptr() == ptrs[1]
    assert all(h[0].data_ptr() == ptrs[0] for h in held)


@pytest.mark.cuda
def test_step_graph_replays_draw_fresh_numbers():
    """The frozen-Philox check: the generator registered with a graph
    advances on every replay, so two replays draw different numbers, and
    reseeding it repeats the sequence an eager run of the same calls
    draws."""
    _card()
    from paddlefleetx_tpu_torch.core.step_graphs import StepGraphs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    out = torch.zeros(64, device=dev)
    graphs = StepGraphs(dev, gen)

    def fn():
        out.copy_(torch.rand(64, generator=gen, device=dev))

    gen.manual_seed(5)
    eager = []
    for _ in range(4):
        fn()
        eager.append(out.clone())
    gen.manual_seed(5)
    draws = []
    for _ in range(4):
        graphs.run("rand", fn)
        draws.append(out.clone())
    torch.cuda.synchronize()
    assert graphs.stats["graph_replays"] == 3
    assert not torch.equal(draws[1], draws[2]) and not torch.equal(draws[2], draws[3])
    assert all(torch.equal(a, b) for a, b in zip(draws, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_sampling_step_graphs_repeat_under_a_seed(top_p):
    """A sampled engine (multinomial, or the nucleus with its top-k
    prefilter) on graphs: the same generator seed gives the eager engine's
    tokens, and the draws vary from step to step."""
    _card()
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine

    server = _graph_server("bfloat16", strategy="sampling", top_p=top_p)
    outs = []
    for graphs in (False, True, True):
        server.generator.manual_seed(9)
        eng = PagedDecodeEngine(server, max_batch=4, block=16, graphs=graphs)
        slots = [eng.admit([3, 4, 5], 20), eng.admit([3, 4, 5], 20)]
        while eng.active.any():
            eng.step()
        torch.cuda.synchronize()
        outs.append([list(eng.slots[s].tokens) for s in slots])
    assert outs[0] == outs[1] == outs[2]
    assert outs[0][0] != outs[0][1] and len(set(outs[0][0])) > 3


@pytest.mark.cuda
def test_reset_keeps_the_graphs_valid():
    """reset() rewrites the arena and the step's buffers in place, so the
    graphs captured before it replay on the rebuilt arena: the next rows
    decode as on a fresh eager engine, with no new capture; after drop()
    they decode the same through a new capture."""
    _card()
    from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine

    server = _graph_server("bfloat16")
    eng = PagedDecodeEngine(server, max_batch=4, block=16, graphs=True)
    pools = (eng.pools.k.data_ptr(), eng.pools.v.data_ptr(), eng._logits.data_ptr())
    eng.admit([1, 2, 3], 12)
    for _ in range(4):
        eng.step()
    captured = eng.graphs.stats["graphs"]
    dead = eng.reset()
    assert len(dead) == 1 and not eng.has_inflight
    assert (eng.pools.k.data_ptr(), eng.pools.v.data_ptr(), eng._logits.data_ptr()) == pools
    replays = eng.graphs.stats["graph_replays"]
    s = eng.admit([4, 5, 6, 7], 12)
    while eng.active.any():
        eng.step()
    ref = PagedDecodeEngine(server, max_batch=4, block=16, graphs=False)
    r = ref.admit([4, 5, 6, 7], 12)
    while ref.active.any():
        ref.step()
    torch.cuda.synchronize()
    assert eng.slots[s].tokens == ref.slots[r].tokens
    assert eng.graphs.stats["graphs"] == captured
    assert eng.graphs.stats["graph_replays"] > replays
    # drop() releases every graph; the next step captures its shape again
    eng.release(s)
    eng.graphs.drop()
    assert len(eng.graphs) == 0
    s = eng.admit([4, 5, 6, 7], 12)
    while eng.active.any():
        eng.step()
    torch.cuda.synchronize()
    assert eng.slots[s].tokens == ref.slots[r].tokens and len(eng.graphs) == 1


@pytest.mark.cuda
def test_capture_failure_raises_and_never_steps_eagerly(monkeypatch):
    """A step that cannot be captured (here: a host read inside it) fails
    the step with ArenaReset, every time, instead of running eagerly."""
    _card()
    from paddlefleetx_tpu_torch.core import continuous_batching as cb

    server = _graph_server("bfloat16")
    eng = cb.PagedDecodeEngine(server, max_batch=4, block=16, graphs=True)
    real = cb.decode_step

    def syncing(*a, **k):
        out = real(*a, **k)
        out[0].sum().item()  # a host read: refused inside a capture
        return out

    monkeypatch.setattr(cb, "decode_step", syncing)
    for _ in range(2):
        eng.admit([1, 2, 3], 8)
        with pytest.raises(cb.ArenaReset):
            eng.step()
        assert len(eng.graphs) == 0 and not eng.active.any()
    monkeypatch.undo()
    eng.admit([1, 2, 3], 8)
    eng.step()
    torch.cuda.synchronize()
    assert len(eng.graphs) == 1
