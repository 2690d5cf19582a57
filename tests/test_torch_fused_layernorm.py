"""PyTorch port, fused LayerNorm (K1/K2): the plain versions against the
JAX ``fused_layer_norm`` run as its own tests run it on the CPU (Pallas
interpret mode), and the GPT loss and grads with ``use_fused_ln`` against
``jax.value_and_grad`` for each attention implementation and recompute
granularity, with the K1/K2 plain-version calls pinned per step.

Tolerances: float32 forward 1e-5, grads (dx, dres, dscale, dbias) 2e-4
(``tests/test_fused_layernorm.py``'s bars), bfloat16 2e-2; the GPT loss
and every grad 1e-5 (float32, summation order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops.fused_layernorm import fused_layer_norm as jax_fused_layer_norm
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.models.gpt import model as gpt
from paddlefleetx_tpu_torch.models.gpt.bridge import grads_to_jax, params_from_jax
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.ops import fused_layernorm as fl
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

# tests/test_fused_layernorm.py's shapes, rows that are not a power of two
# (21 and 15 rows), and the widths at the edges of the two paths K1 and K2
# take on the card: n = 1000 (the register path, 16-byte vectors), each
# dtype's register cap and one vector past it (the strided path), and an n
# that is no multiple of either vector (strided)
SHAPES = [(4, 16, 64), (2, 128), (3, 7, 40), (15, 24), (5, 1024), (3, 1000),
          (3, fl.REGISTER_MAX_N[torch.float32] + 4), (3, fl.REGISTER_MAX_N[torch.bfloat16]),
          (3, fl.REGISTER_MAX_N[torch.bfloat16] + 8), (2, 1001)]


def _inputs(shape, seed, with_res):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32) if with_res else None
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    return x, res, scale, bias


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _port(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax(shape, with_res):
    x, res, scale, bias = _inputs(shape, 0, with_res)
    want = jax_fused_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                residual=None if res is None else jnp.asarray(res))
    before = dict(fl.COUNTS)
    got = fl.fused_layer_norm(*_port(x, scale, bias), residual=_port(res)[0])
    assert fl.COUNTS["fused_ln_fwd_plain"] == before["fused_ln_fwd_plain"] + 1
    assert fl.COUNTS["fused_ln_fwd"] == before["fused_ln_fwd"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_jax(shape, with_res):
    """dx, dres, dscale and dbias of sum(sin(y)) (the JAX test's loss)."""
    x, res, scale, bias = _inputs(shape, 1, with_res)

    def loss(x, scale, bias, res):
        return jnp.sum(jnp.sin(jax_fused_layer_norm(x, scale, bias, residual=res)))

    argnums = (0, 1, 2) if res is None else (0, 1, 2, 3)
    want = jax.grad(loss, argnums)(*(None if a is None else jnp.asarray(a)
                                     for a in (x, scale, bias, res)))
    tx, tscale, tbias, tres = _port(x, scale, bias, res)
    leaves = [tx, tscale, tbias] + ([tres] if tres is not None else [])
    for t in leaves:
        t.requires_grad_()
    before = fl.COUNTS["fused_ln_bwd_plain"]
    torch.sin(fl.fused_layer_norm(tx, tscale, tbias, residual=tres)).sum().backward()
    assert fl.COUNTS["fused_ln_bwd_plain"] == before + 1
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_plain_bf16_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    scale, bias = np.ones(64, np.float32), np.zeros(64, np.float32)
    want = jax_fused_layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                                jnp.asarray(bias))
    got = fl.fused_layer_norm(torch.tensor(x).bfloat16(), *_port(scale, bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    # and against the unfused float32 LayerNorm, as the JAX test holds it
    ref = gpt.layer_norm(torch.tensor(x), *_port(scale, bias))
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=2e-2, atol=2e-2)


# the widths of the card's path table (tests/test_torch_kernels_cuda.py,
# test_register_path_follows_dtype_width_and_alignment): register path
# boundaries and strided widths, in both dtypes
PATH_WIDTHS = [(torch.bfloat16, n) for n in (1024, 1000, 64, 256, 264, 2048, 2056, 1001, 1004)] \
    + [(torch.float32, n) for n in (1024, 1028, 1000, 128, 1022, 7)]


@pytest.mark.parametrize("dtype,n", PATH_WIDTHS)
def test_cpu_op_takes_the_plain_version_at_the_kernels_path_widths(dtype, n):
    """On CPU tensors the K1 op runs its plain version (never the
    library), at every width the kernels' path rule tells apart, and
    matches JAX's forward (bf16 at JAX's own bf16 bar)."""
    x, res, scale, bias = _inputs((3, n), 4, True)
    want = jax_fused_layer_norm(jnp.asarray(x, _JNP[dtype]), jnp.asarray(scale),
                                jnp.asarray(bias), residual=jnp.asarray(res, _JNP[dtype]))
    tx, tres = (torch.tensor(a).to(dtype) for a in (x, res))
    before = dict(fl.COUNTS)
    y, mean, rstd = torch.ops.pfx.fused_ln_fwd(tx, tres, *_port(scale, bias), 1e-5)
    assert fl.COUNTS["fused_ln_fwd_plain"] == before["fused_ln_fwd_plain"] + 1
    assert fl.COUNTS["fused_ln_fwd"] == before["fused_ln_fwd"]
    assert y.dtype == dtype and mean.dtype == rstd.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_plain_backward_returns_scale_dtype_and_dres_is_dx():
    x, res, scale, bias = _port(*_inputs((6, 32), 3, True))
    y, mean, rstd = fl.layer_norm_fwd_plain(x, res, scale, bias, 1e-5)
    g = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    dx, dscale, dbias = fl.layer_norm_bwd_plain(x, res, scale, mean, rstd, g)
    assert dscale.dtype == dbias.dtype == scale.dtype == torch.float32
    for t in (x, res, scale, bias):
        t.requires_grad_()
    fl.fused_layer_norm(x, scale, bias, residual=res).backward(g)
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(res.grad, dx, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The GPT loss and grads with use_fused_ln, against jax.value_and_grad
# ---------------------------------------------------------------------------

MODEL = {"vocab_size": 96, "hidden_size": 32, "num_layers": 2, "num_attention_heads": 4,
         "max_position_embeddings": 128, "dtype": "float32",
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
         "use_fused_ln": True}
SEQ = 64
ATTN = {"xla": ("xla", ""), "flash_split": ("flash", "split"), "flash_fused": ("flash", "fused")}
RECOMPUTE = ["off", "full", "selective", "full_attn", "core_attn"]
# K1 plain calls per forward + backward of the 2-layer model: ln_1, ln_2
# per layer and final_ln (5), plus the LayerNorms a recomputed segment
# re-runs: both of a layer under "full" and "selective" (the selective
# policy keeps only named values, as JAX's does, so K1 re-runs), ln_1
# under "full_attn", none under "core_attn".  K2: one per LayerNorm.
K1_CALLS = {"off": 5, "full": 9, "selective": 9, "full_attn": 7, "core_attn": 5}
K2_CALLS = 5


def _tree(seed=0):
    """TINY weights: the JAX init plus noise, so biases and LayerNorm
    parameters are not all 0 / 1."""
    rng = np.random.default_rng(seed)
    params = jax_model.init(JaxGPTConfig(**MODEL), jax.random.key(0))
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params
    )


def _batch(b, s=SEQ, seed=1):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, s)) > 0.25).astype(np.float32)
    return {"tokens": rng.integers(0, 96, (b, s)).astype(np.int64),
            "labels": rng.integers(0, 96, (b, s)).astype(np.int64),
            "loss_mask": mask, "position_ids": np.tile(np.arange(s), (b, 1))}


def _model_kw(attn, recompute):
    impl, bwd = ATTN[attn]
    return dict(MODEL, attn_impl=impl, flash_bwd=bwd, use_recompute=recompute != "off",
                recompute_granularity="full" if recompute == "off" else recompute)


@pytest.fixture(scope="module")
def jax_reference():
    """jax.value_and_grad(loss_fn) with the Pallas fused LayerNorm
    (interpret mode) per attention implementation."""
    tree, batch = _tree(), _batch(2)
    out = {}
    for attn in ATTN:
        cfg = JaxGPTConfig(**_model_kw(attn, "off"))
        loss, grads = jax.value_and_grad(jax_model.loss_fn)(
            jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}, cfg
        )
        out[attn] = (float(loss), jax.tree.map(np.asarray, grads))
    return tree, batch, out


@pytest.mark.parametrize("recompute", RECOMPUTE)
@pytest.mark.parametrize("attn", sorted(ATTN))
def test_fused_ln_loss_and_grads_match_jax(attn, recompute, jax_reference):
    tree, batch, ref = jax_reference
    cfg = GPTConfig(**_model_kw(attn, recompute))
    model = params_from_jax(cfg, tree, trainable=True)
    before = dict(fl.COUNTS)
    loss = gpt.loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    loss.backward()
    want_loss, want_grads = ref[attn]
    assert abs(loss.item() - want_loss) <= 1e-5
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads_to_jax(model)),
                            jax.tree.leaves(want_grads)):
        err = np.abs(np.asarray(g) - np.asarray(w)).max()
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)
    used = {k: fl.COUNTS[k] - before[k] for k in fl.COUNTS}
    assert used == {"fused_ln_fwd": 0, "fused_ln_bwd": 0,
                    "fused_ln_fwd_plain": K1_CALLS[recompute],
                    "fused_ln_bwd_plain": K2_CALLS}, used


def test_fused_ln_counts_per_train_step():
    """Engine.train_step at the slice's settings (flash fused, selective
    recompute, two micro-batches): K1 and K2 plain calls per step are the
    per-micro-batch counts twice; at 24 layers the same rule gives
    2 x (2 x 24 x 2 + 1) = 194 K1 and 2 x 49 = 98 K2 launches per step."""
    raw = {
        "Global": {"global_batch_size": 4, "micro_batch_size": 2, "seed": 7},
        "Engine": {"max_steps": 1, "mix_precision": {"enable": False}},
        "Model": dict(_model_kw("flash_fused", "selective"), module="GPTModule"),
        "Optimizer": {"name": "FusedAdamW", "lr": {"name": "Constant", "learning_rate": 1e-3}},
    }
    cfg = process_configs(AttrDict.from_nested(copy.deepcopy(raw)))
    engine = Engine(cfg, GPTModule(cfg), device="cpu")
    before = dict(fl.COUNTS)
    m = engine.train_step(_batch(4))
    used = {k: fl.COUNTS[k] - before[k] for k in fl.COUNTS}
    assert np.isfinite(m["loss"]) and m["found_inf"] == 0.0
    assert used == {"fused_ln_fwd": 0, "fused_ln_bwd": 0,
                    "fused_ln_fwd_plain": 2 * K1_CALLS["selective"],
                    "fused_ln_bwd_plain": 2 * K2_CALLS}, used
