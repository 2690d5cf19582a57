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
the sum), int8 1e-4 (the same dequantization math as the plain version).
The flash kernels have their own limits (``FLASH_TOL``, ``BF16_ROW_TOL``,
``BF16_DIFFER_TOL``, the values of ``chip_smoke.py`` phase 9).
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
# 128 (PERF.md).
FLASH_TOL = {torch.float32: (1e-4, 2e-4)}
BF16_ROW_TOL = {"fwd": 2.0**-6, "split": 2.0**-6, "fused": 2.0**-6}
BF16_DIFFER_TOL = {"fwd": 5e-4, "split": 1.5e-3, "fused": 1.5e-3}


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
        assert readings["row"] <= BF16_ROW_TOL[kernel], (kernel, readings)
        assert readings["differ"] <= BF16_DIFFER_TOL[kernel], (kernel, readings)


def _match_plain(dtype, d, s, bh, record_property):
    """K3's out and lse, then K4's dq, K5's dk/dv and K6's dq/dk/dv from
    the same lse, against the plain versions at each kernel's own tile, so
    both round alike; bf16 by the tensor-core route, f32 by the CUDA-core
    one (the *_sm90 counts rise for bf16 only).  K6 adds dq with
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
    sm90 = int(dtype == torch.bfloat16)
    assert used == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                    "flash_bwd_fused": 1, "flash_fwd_sm90": sm90,
                    "flash_bwd_dq_sm90": sm90, "flash_bwd_dkv_sm90": sm90,
                    "flash_bwd_fused_sm90": sm90, "flash_plain": 0}, used


@pytest.mark.cuda
@pytest.mark.parametrize("s", [40, 200, 1024])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernels_match_plain(dtype, d, s, record_property):
    _match_plain(dtype, d, s, 6, record_property)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernels_match_plain_with_more_ctas_than_sms(d, record_property):
    """b*h = 256 at seq 1024: 2048 CTAs for each of K3-K6, many waves of
    the 132 SMs (bf16, the tensor-core route)."""
    _match_plain(torch.bfloat16, d, 1024, 256, record_property)


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
        fa.launch_fwd(q.half(), k.half(), v.half(), 0.1)  # float16
    with pytest.raises(ValueError):
        fa.launch_fwd(q, k.float(), v, 0.1)  # mixed types
    with pytest.raises(ValueError):
        fa.launch_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 0.1)  # strides
    with pytest.raises(ValueError):
        fa.launch_fwd(q, k.cpu(), v, 0.1)  # device mismatch
    with pytest.raises(ValueError):
        fa.launch_fwd(q[None], k[None], v[None], 0.1)  # not [bh, s, d]
    # the tensor-core route (bf16 K3-K6): a misaligned tensor, and float16
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    lse = torch.zeros(q.shape[:2], dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fa.launch_fwd(odd, k, v, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_fused(q, k, odd, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_fused(q.half(), k.half(), v.half(), q.half(), lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dq(q, k, odd, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dkv(odd, k, v, q, lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dq(q.half(), k.half(), v.half(), q.half(), lse, lse, 0.1)
    with pytest.raises(ValueError):
        fa.launch_bwd_dkv(q.half(), k.half(), v.half(), q.half(), lse, lse, 0.1)


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
# multiples of anything (the kernels take any), one row, a wide row
LN_SHAPES = {"gpt345m": (8192, 1024), "odd": (8191, 1000), "tiny": (5, 7), "one_row": (1, 64),
             "wide": (300, 4097)}
# float32: summation order only; bfloat16: outputs within one bf16 ulp
# (2**-7 of the value) of the plain version's, the float32 sums of the
# two differing in order; dscale/dbias (float32 sums over the rows) 1e-4
# of the largest
LN_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2.0**-7)}


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_ln_kernels_match_plain(dtype, name, with_res, record_property):
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    dev = _card()
    x, res, scale, bias, gy = _ln_case(*LN_SHAPES[name], dtype, with_res, dev)
    atol, rtol = LN_TOL[dtype]
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
def test_fused_ln_wrapper_rejects_what_the_kernel_does_not_take():
    from paddlefleetx_tpu_torch.ops import fused_layernorm as fl

    dev = _card()
    x, res, scale, bias, gy = _ln_case(16, 64, torch.bfloat16, True, dev)
    with pytest.raises(ValueError):
        fl.launch_fwd(x.half(), None, scale, bias, 1e-5)  # float16
    with pytest.raises(ValueError):
        fl.launch_fwd(x, None, scale.bfloat16(), bias, 1e-5)  # bf16 scale
    with pytest.raises(ValueError):
        fl.launch_fwd(x, res.float(), scale, bias, 1e-5)  # mixed types
    with pytest.raises(ValueError):
        fl.launch_fwd(x.t(), None, scale, bias, 1e-5)  # strides
    with pytest.raises(ValueError):
        fl.launch_fwd(x, None, scale.cpu(), bias, 1e-5)  # device mismatch
    with pytest.raises(ValueError):
        fl.fused_ln_fwd(x.half(), None, scale, bias, 1e-5)  # the op: no fallback either


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
