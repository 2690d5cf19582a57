"""PyTorch port, ops/flash_attention.py and ops/attention.py, against the
JAX package on the CPU.

The port's plain versions of K3 (forward: out and lse), K4+K5 (split
backward) and K6 (fused backward) are held against the Pallas kernels,
which run in interpret mode on the CPU as the JAX package's own tests
run them, on the same numpy inputs; the whole op (autograd included) is
held against ``xla_attention`` of both packages.  Tolerances: float32
2e-5; bfloat16 0.05 forward and 0.35 grads against a float32 reference
(the bars of ``tests/test_flash_attention.py``).  The knob handling
(blocks, schedule, ``flash_supported``) must agree value for value and
raise on the same bad values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.ops import flash_attention as jfa
from paddlefleetx_tpu.ops.attention import attention as jax_attention
from paddlefleetx_tpu.ops.attention import xla_attention as jax_xla
from paddlefleetx_tpu_torch.ops import flash_attention as fa
from paddlefleetx_tpu_torch.ops.attention import attention, xla_attention

torch.set_num_threads(2)

ENV = ("PFX_FLASH_BLOCK", "PFX_FLASH_BLOCK_K", "PFX_FLASH_BWD")
# (b, s, n, d, PFX_FLASH_BLOCK_K): one block, two blocks, a seq that is no
# multiple of 64 (a partial tile for the CUDA kernel), asymmetric blocks
CASES = {
    "s64": (1, 64, 2, 16, ""),
    "s40_partial_tile": (2, 40, 2, 8, ""),
    "s128_block_k32": (1, 128, 2, 16, "32"),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _inputs(b, s, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, d)).astype(np.float32) for _ in range(4)]


def _bh(x):
    b, s, n, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * n, s, d))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0.0, atol=tol)


@pytest.fixture(scope="module")
def jax_kernels():
    """Per case: the Pallas kernels' forward (out, lse) and both backward
    schedules on the same residuals, in the [bh, s, d] layout."""
    import os

    out = {}
    for name, (b, s, n, d, bk) in CASES.items():
        if bk:
            os.environ["PFX_FLASH_BLOCK_K"] = bk
        try:
            block = jfa._block_sizes(s)
        finally:
            os.environ.pop("PFX_FLASH_BLOCK_K", None)
        q, k, v, do = (jnp.asarray(_bh(x)) for x in _inputs(b, s, n, d))
        scale = float(1.0 / d**0.5)
        o, lse = jfa._flash_fwd(q, k, v, scale, block)
        res = (q, k, v, o, lse)
        grads = {mode: jfa._flash_bwd(scale, block, mode, res, do) for mode in ("split", "fused")}
        out[name] = (block, np.asarray(o), np.asarray(lse)[..., 0], grads)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_kernels_match_pallas(name, jax_kernels, monkeypatch):
    b, s, n, d, bk = CASES[name]
    if bk:
        monkeypatch.setenv("PFX_FLASH_BLOCK_K", bk)
    block, j_out, j_lse, j_grads = jax_kernels[name]
    assert fa._block_sizes(s) == block
    q, k, v, do = (torch.tensor(_bh(x)) for x in _inputs(b, s, n, d))
    scale = float(1.0 / d**0.5)
    out, lse = fa.flash_forward(q, k, v, scale, block)
    _close(out, j_out, 2e-5)
    _close(lse, j_lse, 2e-5)
    delta = (do * out).sum(-1)
    for mode, plain in (("split", fa.flash_bwd_split), ("fused", fa.flash_bwd_fused)):
        for got, want in zip(plain(q, k, v, do, lse, delta, scale, block), j_grads[mode]):
            _close(got, want, 2e-5)


# (b, s, n, d, plain block): the CUDA kernels' own tiles off the ladder's
# block, most leaving a partial last tile: 64 x 64 (the CUDA-core kernels),
# 128 x 128 (bf16 K3 on the tensor cores), 128 x 64 (bf16 K4) and 64 x 128
# (bf16 K5 and K6), at s = 200 (a partial 128-tile) and s = 256 (whole
# tiles, two to a ladder block)
PARTIAL = {
    "s40_block16": (2, 40, 2, 8, (16, 16)),
    "s200_block64": (1, 200, 2, 16, (64, 64)),
    "s104_block64x32": (1, 104, 2, 16, (64, 32)),
    "s200_block128": (1, 200, 2, 16, (128, 128)),
    "s200_block128x64": (1, 200, 2, 16, (128, 64)),
    "s200_block64x128": (1, 200, 2, 16, (64, 128)),
    "s256_block128": (1, 256, 2, 16, (128, 128)),
    "s256_block128x64": (1, 256, 2, 16, (128, 64)),
    "s256_block64x128": (1, 256, 2, 16, (64, 128)),
}


@pytest.mark.parametrize("name", sorted(PARTIAL))
def test_plain_kernels_take_a_partial_last_tile(name):
    """At a block other than the ladder's, one that need not divide the seq
    (the kernels' own tiling, which the card tests hold the kernels
    against), the plain versions agree with the Pallas kernels at the
    ladder's dividing block."""
    b, s, n, d, block = PARTIAL[name]
    q, k, v, do = (_bh(x) for x in _inputs(b, s, n, d, seed=4))
    scale = float(1.0 / d**0.5)
    ladder = jfa._block_sizes(s)
    assert s % ladder[0] == 0 and block != ladder
    j_out, j_lse = jfa._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), scale, ladder)
    res = tuple(jnp.asarray(x) for x in (q, k, v)) + (j_out, j_lse)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    out, lse = fa.flash_forward(tq, tk, tv, scale, block)
    _close(out, j_out, 2e-5)
    _close(lse, np.asarray(j_lse)[..., 0], 2e-5)
    delta = (tdo * out).sum(-1)
    for mode, plain in (("split", fa.flash_bwd_split), ("fused", fa.flash_bwd_fused)):
        want = jfa._flash_bwd(scale, ladder, mode, res, jnp.asarray(do))
        for got, w in zip(plain(tq, tk, tv, tdo, lse, delta, scale, block), want):
            _close(got, w, 2e-5)


def _load(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_tiles_name_every_kernel_and_route():
    """The tile table names a tile for each kernel on each route it has
    (bf16 K3-K6 on the tensor cores, f32 on CUDA cores), the route follows
    the dtype alone, every kernel counts its tensor-core launches, and
    chip_smoke's phase 9 and the card test hold each kernel against its
    plain version at that tile."""
    from pathlib import Path

    want = {("flash_fwd", "sm90"): (128, 128), ("flash_bwd_dq", "sm90"): (128, 64),
            ("flash_bwd_dkv", "sm90"): (64, 128), ("flash_bwd_fused", "sm90"): (64, 128),
            **{(name, "cuda_core"): (64, 64) for name in fa.KERNELS}}
    assert fa.KERNEL_TILES == want
    for dtype in (torch.float32, torch.bfloat16):
        for name in fa.KERNELS:
            route = fa.kernel_route(name, dtype)
            assert route == ("sm90" if dtype == torch.bfloat16 else "cuda_core"), (name, dtype)
            assert fa.kernel_tile(name, dtype) == want[(name, route)]
    assert set(fa.COUNTS) == {*fa.KERNELS, *(f"{name}_sm90" for name in fa.KERNELS),
                              "flash_plain"}
    root = Path(__file__).resolve().parents[1]
    smoke = _load(root / "chip_smoke.py")
    card = _load(root / "tests" / "test_torch_kernels_cuda.py")
    for dtype in (torch.float32, torch.bfloat16):
        tiles = {name: fa.kernel_tile(name, dtype) for name in fa.KERNELS}
        assert smoke.flash_blocks(fa, dtype) == tiles
        assert card.flash_blocks(fa, dtype) == tiles


@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_xla_attention(name, mode, monkeypatch):
    """The autograd op on [b, s, n, d] against the plain attention path
    of both packages: out and the grads of sum(out * ct)."""
    b, s, n, d, bk = CASES[name]
    if bk:
        monkeypatch.setenv("PFX_FLASH_BLOCK_K", bk)
    q, k, v, ct = _inputs(b, s, n, d, seed=1)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = fa.COUNTS["flash_plain"]
    out = fa.flash_attention(tq, tk, tv, bwd_schedule=mode)
    (out * torch.tensor(ct)).sum().backward()
    assert fa.COUNTS["flash_plain"] == before + 2  # forward and backward, plain on the CPU
    ref = xla_attention(*(torch.tensor(x) for x in (q, k, v)))
    _close(out.detach(), ref, 2e-5)

    def loss(q, k, v):
        return jnp.sum(jax_xla(q, k, v, causal=True) * ct)

    j_out = jax_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    _close(ref, j_out, 2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jax.grad(loss, argnums=(0, 1, 2))(q, k, v)):
        _close(got, want, 2e-5)


def test_bf16_within_the_reference_bars():
    b, s, n, d = 1, 64, 2, 16
    q, k, v, ct = _inputs(b, s, n, d, seed=2)
    bf = [torch.tensor(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*bf, bwd_schedule="split")
    (out.float() * torch.tensor(ct)).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jax_xla(q, k, v, causal=True) * ct)

    j_ref = jax_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    _close(out.detach().float(), j_ref, 0.05)
    for got, want in zip(bf, jax.grad(loss, argnums=(0, 1, 2))(q, k, v)):
        _close(got.grad.float(), want, 0.35)
    j_bf = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    _close(out.detach().float(), np.asarray(j_bf, np.float32), 0.05)


BAD = {
    "block_not_int": ({"PFX_FLASH_BLOCK": "abc"}, 64, 0, ""),
    "block_not_divisor": ({"PFX_FLASH_BLOCK": "24"}, 64, 0, ""),
    "block_not_multiple_of_8": ({"PFX_FLASH_BLOCK": "4"}, 64, 0, ""),
    "block_negative": ({"PFX_FLASH_BLOCK": "-8"}, 64, 0, ""),
    "model_block_not_divisor": ({}, 64, 48, ""),
    "model_block_not_multiple_of_8": ({}, 64, 4, ""),
    "block_k_not_int": ({"PFX_FLASH_BLOCK_K": "x"}, 64, 0, ""),
    "block_k_not_divisor": ({"PFX_FLASH_BLOCK_K": "24"}, 128, 0, ""),
    "block_k_on_unsupported_seq": ({"PFX_FLASH_BLOCK_K": "12"}, 1000, 0, ""),
    "bwd_schedule_env": ({"PFX_FLASH_BWD": "splitt"}, 64, 0, ""),
    "bwd_schedule_arg": ({}, 64, 0, "fuse"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_knobs_raise_in_both_packages(name, monkeypatch):
    env, seq, block, sched = BAD[name]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    for mod in (jfa, fa):
        with pytest.raises(ValueError):
            mod._block_sizes(seq, block)
            mod._resolve_bwd_schedule(sched)


SEQS = [8, 12, 40, 64, 100, 128, 200, 248, 255, 256, 384, 640, 768, 1000, 1024, 2048]


@pytest.mark.parametrize("block_k", ["", "64"])
def test_block_ladder_and_flash_supported_agree(block_k, monkeypatch):
    if block_k:
        monkeypatch.setenv("PFX_FLASH_BLOCK_K", block_k)
    for seq in SEQS:
        for block in (0, 8, 128):
            try:
                want = (jfa._block_sizes(seq, block), jfa.flash_supported(seq, block))
            except ValueError:
                with pytest.raises(ValueError):
                    fa._block_sizes(seq, block)
                continue
            assert (fa._block_sizes(seq, block), fa.flash_supported(seq, block)) == want, seq


def test_dispatch_warns_on_an_unsupported_seq_in_both_packages():
    """seq 12 is not on the ladder: on the CPU impl="flash" warns and
    takes the plain path, as the JAX dispatch does; the plain flash
    versions are never asked.  (On the card every seq takes the kernels:
    ``tests/test_torch_kernels_cuda.py``.)"""
    q, k, v, _ = _inputs(1, 12, 2, 8, seed=3)
    before = fa.COUNTS["flash_plain"]
    with pytest.warns(UserWarning, match="flash attention unsupported"):
        got = attention(*(torch.tensor(x) for x in (q, k, v)), impl="flash")
    assert fa.COUNTS["flash_plain"] == before
    with pytest.warns(UserWarning, match="flash attention unsupported"):
        want = jax_attention(*(jnp.asarray(x) for x in (q, k, v)), impl="flash")
    _close(got, want, 2e-5)
