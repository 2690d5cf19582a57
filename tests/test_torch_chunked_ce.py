"""PyTorch port, ops/chunked_ce.py, against the JAX package on the CPU:
the chunked softmax cross-entropy's loss and grads against JAX
``chunked_cross_entropy`` and against the port's materialized-logits CE
(``tests/test_chunked_ce.py``'s cases: chunks that divide the vocabulary
and that do not, a prime vocabulary, bfloat16 hidden), and the GPT loss
with ``use_chunked_ce`` against the plain loss and the JAX model's.

Tolerances: float32 loss 1e-6 relative and grads 1e-5 (summation order);
bfloat16 hidden: against JAX 1e-4 relative on the loss (XLA may keep a
bf16 product's float32 sum where the port rounds it to bf16 first; 2e-5
read) and one bf16 ulp of the largest grad (both round dlogits to bf16 for
the two products), against a float32 reference the JAX test's 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops.chunked_ce import chunked_cross_entropy as jax_chunked_ce
from paddlefleetx_tpu_torch.models.gpt import model as gpt
from paddlefleetx_tpu_torch.models.gpt.bridge import grads_to_jax, params_from_jax
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.ops.chunked_ce import chunked_cross_entropy

torch.set_num_threads(2)


def _inputs(b, s, h, v, seed):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(b, s, h)).astype(np.float32)
    word = (rng.normal(size=(v, h)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.float32)
    mask[-1, s // 2:] = 0.0
    return hidden, word, labels, mask


def _port(hidden, word, labels, mask, chunk, dtype=torch.float32):
    th = torch.tensor(hidden).to(dtype).requires_grad_()
    tw = torch.tensor(word).to(dtype).requires_grad_()
    loss = chunked_cross_entropy(th, tw, torch.tensor(labels), torch.tensor(mask), chunk=chunk)
    loss.backward()
    return loss.item(), th.grad, tw.grad


def _plain(hidden, word, labels, mask):
    """The port's materialized-logits loss (logits_from_hidden's product,
    then model.cross_entropy) and its grads."""
    th = torch.tensor(hidden).requires_grad_()
    tw = torch.tensor(word).requires_grad_()
    loss = gpt.cross_entropy(th @ tw.t(), torch.tensor(labels), torch.tensor(mask))
    loss.backward()
    return loss.item(), th.grad, tw.grad


def _jax(hidden, word, labels, mask, chunk, dtype=jnp.float32):
    def fn(hh, ww):
        return jax_chunked_ce(hh, ww, jnp.asarray(labels), jnp.asarray(mask), chunk=chunk)

    args = (jnp.asarray(hidden, dtype), jnp.asarray(word, dtype))
    loss, grads = jax.value_and_grad(fn, argnums=(0, 1))(*args)
    return float(loss), [np.asarray(g, np.float32) for g in grads]


# (b, s, h, vocab, chunk): dividing chunks, a chunk of the whole vocabulary,
# chunks that do not divide it, a prime vocabulary, a chunk above it
CASES = {"divides": (2, 8, 16, 96, 32), "whole": (2, 8, 16, 96, 96),
         "tail_48_of_96": (2, 8, 16, 96, 48), "tail_40_of_96": (2, 8, 16, 96, 40),
         "prime_97": (2, 4, 8, 97, 32), "chunk_above_vocab": (1, 4, 8, 60, 64)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_jax_and_plain(name):
    b, s, h, v, chunk = CASES[name]
    args = _inputs(b, s, h, v, seed=len(name))
    loss, dh, dw = _port(*args, chunk)
    want_loss, (want_dh, want_dw) = _jax(*args, chunk)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    np.testing.assert_allclose(dh.numpy(), want_dh, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=0, atol=1e-5)
    plain_loss, plain_dh, plain_dw = _plain(*args)
    assert loss == pytest.approx(plain_loss, rel=1e-6)
    np.testing.assert_allclose(dh.numpy(), plain_dh.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), plain_dw.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [64, 24])
def test_bf16_hidden_matches_jax(chunk):
    """bfloat16 hidden and word: the logits in bf16 products (float32
    sums), dlogits rounded to bf16 for the two products, dh carried in
    float32; the grads come back in bf16."""
    args = _inputs(1, 8, 8, 60, seed=3)
    loss, dh, dw = _port(*args, chunk, dtype=torch.bfloat16)
    assert dh.dtype == dw.dtype == torch.bfloat16
    want_loss, (want_dh, want_dw) = _jax(*args, chunk, dtype=jnp.bfloat16)
    assert loss == pytest.approx(want_loss, rel=1e-4)
    for got, want in ((dh, want_dh), (dw, want_dw)):
        assert np.abs(got.float().numpy() - want).max() <= 2.0**-8 * np.abs(want).max()
    ref_loss, _, _ = _plain(*args)
    assert loss == pytest.approx(ref_loss, rel=2e-2)


def test_gpt_loss_with_chunked_ce_matches_plain_and_jax():
    """use_chunked_ce (chunks of 40 over vocab 96: a partial tail) gives the
    plain path's loss and every grad, and the JAX model's with chunked CE."""
    base = dict(vocab_size=96, hidden_size=32, num_layers=2, num_attention_heads=4,
                max_position_embeddings=32, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, dtype="float32")
    tree = jax.tree.map(np.asarray, jax_model.init(JaxGPTConfig(**base), jax.random.key(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 96, (2, 16)), "labels": rng.integers(0, 96, (2, 16)),
             "loss_mask": (rng.random((2, 16)) > 0.3).astype(np.float32)}
    cfg = GPTConfig(**base)
    ccfg = dataclasses.replace(cfg, use_chunked_ce=True, ce_chunk_size=40)
    out = {}
    for name, c in (("plain", cfg), ("chunked", ccfg)):
        model = params_from_jax(c, tree, trainable=True)
        loss = gpt.loss_fn(model, {k: torch.as_tensor(x) for k, x in batch.items()}, c,
                           train=False)
        loss.backward()
        out[name] = (loss.item(), grads_to_jax(model))
    jcfg = JaxGPTConfig(**dict(base, use_chunked_ce=True, ce_chunk_size=40))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, {k: jnp.asarray(x) for k, x in batch.items()}, jcfg,
                                    train=False))(jax.tree.map(jnp.asarray, tree))
    assert out["chunked"][0] == pytest.approx(out["plain"][0], rel=1e-6)
    assert out["chunked"][0] == pytest.approx(float(jloss), rel=1e-6)
    for got, plain, want in zip(jax.tree.leaves(out["chunked"][1]),
                                jax.tree.leaves(out["plain"][1]), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(got, plain, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)
