"""PyTorch port on the card: the flash-decode and paged-decode CUDA
kernels against their plain PyTorch versions on the same CUDA inputs,
and the serving paths on the card against the CPU.

Marked ``cuda``; each test skips itself when there is no card.  Imports
no JAX, so it runs on a GPU machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
Tolerances: float32 1e-4 (summation order and the four-warp merge differ
from the plain loop), bfloat16 2e-2 absolute in float32 (probabilities
are rounded to bf16 before p @ v on both sides, at different points of
the sum), int8 1e-4 (the same dequantization math as the plain version).
"""

import numpy as np
import pytest
import torch

from paddlefleetx_tpu_torch.ops import decode_attention as da

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.int8: 1e-4}

# (b, n, t, d, L, limit, kv_valid_from)
SHAPES = {
    "decode_gpt345m_b8": (8, 16, 1, 64, 1024, 517, None),
    "prefill_left_pad": (3, 16, 70, 64, 256, 70, [0, 13, 69]),
    "chunk_unaligned": (2, 4, 5, 64, 99, 60, [7, 0]),
    "decode_head_dim_128": (2, 8, 1, 128, 300, 300, [40, 0]),
    "decode_small_head_dim": (2, 4, 3, 8, 40, 40, None),
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
    before = da.COUNTS[key]
    got = da.flash_decode(q, k, v, limit, vf, scale, ks, vs)
    torch.cuda.synchronize()
    assert da.COUNTS[key] == before + 1
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
def test_kernel_never_reads_past_limit():
    dev = _card()
    q, k, v, limit, vf, scale, _, _ = _case("decode_gpt345m_b8", torch.float32, dev)
    ref = da.flash_decode(q, k, v, limit, vf, scale)
    k[:, :, limit:] = float("nan")
    v[:, :, limit:] = float("nan")
    got = da.flash_decode(q, k, v, limit, vf, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


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


# (b, n, t, d, bs, M, positions): paged decode / verify over shuffled pool
# blocks, each row's table null-padded past its last needed block
PAGED_SHAPES = {
    "decode_gpt345m_b8": (8, 16, 1, 64, 16, 128, [5, 17, 80, 200, 511, 700, 1000, 1023]),
    "verify_t4_gpt345m": (8, 16, 4, 64, 16, 128, [5, 17, 80, 200, 511, 700, 1000, 1023]),
    "block8_boundaries": (3, 4, 2, 64, 8, 8, [7, 15, 0]),
    "block32_head_dim_128": (2, 8, 1, 128, 32, 4, [31, 100]),
    "block24_head_dim_8": (2, 4, 3, 8, 24, 4, [10, 60]),
    "verify_t16": (2, 4, 16, 64, 16, 8, [0, 40]),
}


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
    before = da.COUNTS[key]
    q_t = q.transpose(1, 2).contiguous()
    scale = 1.0 / q.shape[-1] ** 0.5
    got = da._paged_launch(q_t, k, v, tables, positions, scale, ks, vs)  # float32 out
    torch.cuda.synchronize()
    assert da.COUNTS[key] == before + 1
    ref = da.paged_decode_attention_plain(q_t, k, v, tables, positions, scale, ks, vs)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= TOL[kv_dtype], err
    # the wrapper the engine calls: [b, t, n, d] in q's dtype, against the
    # plain output given the same layout and cast
    out = da.paged_decode_attention(q, k, v, tables, positions, k_scale=ks, v_scale=vs)
    assert da.COUNTS[key] == before + 2
    assert out.dtype == q.dtype and out.shape == q.shape
    want = ref.transpose(1, 2).to(q.dtype).float()
    assert (out.float() - want).abs().max().item() <= TOL[q.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_gpt345m_b8", "block8_boundaries"])
def test_paged_kernel_never_reads_past_a_rows_bound(name):
    """Every pool block a row cannot see (the null block included, which
    pads the tables) is NaN-poisoned: the result must not change."""
    dev = _card()
    q, k, v, tables, positions, _, _ = _paged_case(name, torch.float32, dev)
    clean = da.paged_decode_attention(q, k, v, tables, positions)
    t, bs = q.shape[1], k.shape[2]
    seen = set()
    for i, p in enumerate(positions.tolist()):
        seen.update(tables[i, : (p + t - 1) // bs + 1].tolist())
    for blk in range(k.shape[0]):
        if blk not in seen:
            k[blk] = float("nan")
            v[blk] = float("nan")
    got = da.paged_decode_attention(q, k, v, tables, positions)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


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
