"""PyTorch port, training in low precision, against the JAX package on the
CPU: the float16 plain versions of K1-K6 against the Pallas kernels in
interpret mode (float16 inputs), the engine's dynamic loss scaling
(trajectory, overflow skip), ``mix_precision.main_grad: False``,
``Optimizer.moment_dtype: bfloat16`` and ``Optimizer.multi_precision:
False`` against the JAX engine, and asynchronous checkpoint saves.

The TINY GPT of ``tests/test_torch_train_step.py`` (vocab 96, 2 layers,
hidden 32, 4 heads, dropout 0), the JAX engine's initial weights moved
through the bridge, the same seeded numpy batches.  Tolerances: the
float16 kernels within one float16 ulp of the largest output (2**-10 of
it); training losses against the JAX engine's over the same steps (one
batch, learned): float16 2e-4 relative, with the loss scale, found_inf and
the skipped step exact, the bfloat16 levers 1e-3 relative over 8 steps
(both ~10x the differences read: the two backends round the low-precision
activations and state in other orders), tighter than
``tests/test_engine.py``'s bars for the same levers (5e-2 between runs);
``main_grad: False``'s first step 1e-5 relative to the float32-grad run,
that test's own bar.
"""

import copy
import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.core.engine import Engine as JaxEngine
from paddlefleetx_tpu.core.module import build_module as jax_build_module
from paddlefleetx_tpu.ops import flash_attention as jfa
from paddlefleetx_tpu.ops.fused_layernorm import fused_layer_norm as jax_fused_layer_norm
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core import engine as engine_mod
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.ops import flash_attention as fa
from paddlefleetx_tpu_torch.ops import fused_layernorm as fl
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

MODEL = {"vocab_size": 96, "hidden_size": 32, "num_layers": 2, "num_attention_heads": 4,
         "max_position_embeddings": 128, "hidden_dropout_prob": 0.0,
         "attention_probs_dropout_prob": 0.0}
BASE = {
    "Global": {"global_batch_size": 4, "micro_batch_size": 2, "seed": 7},
    "Engine": {"max_steps": 8, "logging_freq": 1, "save_load": {"save_steps": 0}},
    "Model": dict(MODEL, module="GPTModule", attn_impl="flash", flash_bwd="fused",
                  use_fused_ln=True),
    "Distributed": {},
    "Optimizer": {"name": "FusedAdamW", "weight_decay": 0.01, "beta1": 0.9, "beta2": 0.95,
                  "lr": {"name": "Constant", "learning_rate": 3e-3},
                  "grad_clip": {"name": "ClipGradByGlobalNorm", "clip_norm": 1.0}},
}


def _fp16(init, incr_every=1000):
    return {"Engine": {"mix_precision": {
        "enable": True, "dtype": "float16",
        "scale_loss": {"init": init, "incr_every_n_steps": incr_every, "incr_ratio": 2.0,
                       "decr_ratio": 0.5}}},
        "Model": {"dtype": "float16"}}


BF16 = {"Engine": {"mix_precision": {"enable": True, "dtype": "bfloat16"}},
        "Model": {"dtype": "bfloat16"}}
LEVERS = {
    "main_grad_off": {"Engine": {"mix_precision": {"enable": True, "dtype": "bfloat16",
                                                   "main_grad": False}},
                      "Model": {"dtype": "bfloat16"}},
    "bf16_moments": dict(BF16, Optimizer={"moment_dtype": "bfloat16"}),
    "multi_precision_off": dict(BF16, Optimizer={"multi_precision": False}),
}


def _raw(overrides):
    raw = copy.deepcopy(BASE)
    for section, values in overrides.items():
        dst = raw.setdefault(section, {})
        for key, val in values.items():
            if isinstance(val, dict) and isinstance(dst.get(key), dict):
                dst[key] = dict(dst[key], **val)
            else:
                dst[key] = val
    return raw


def _batch(seed, b=4, s=64):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 96, (b, s)).astype(np.int64),
            "labels": rng.integers(0, 96, (b, s)).astype(np.int64),
            "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32),
            "position_ids": np.tile(np.arange(s), (b, 1))}


def _engines(overrides):
    """The JAX engine (one CPU device) and the port's engine on its initial
    weights, for one configuration."""
    raw = _raw(overrides)
    jcfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(raw)), num_devices=1)
    mesh = init_dist_env(jcfg, devices=jax.devices()[:1])
    with mesh:
        jengine = JaxEngine(jcfg, jax_build_module(jcfg), mesh)
    cfg = process_configs(AttrDict.from_nested(copy.deepcopy(raw)))
    module = GPTModule(cfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jengine.state.params)
    engine = Engine(cfg, module, device="cpu",
                    model=params_from_jax(module.config, tree, trainable=True))
    return jengine, mesh, engine


def _run(jengine, mesh, engine, steps, fixed=False):
    """Both engines over the same batches (``fixed``: one batch every
    step, which the model then learns): per step the port's metrics and
    the JAX engine's."""
    out = []
    for i in range(steps):
        batch = _batch(100 if fixed else 100 + i)
        with mesh:
            jengine.state, jm = jengine.train_step(jengine.state, jengine._put_batch(batch))
        out.append((engine.train_step(batch), {k: float(v) for k, v in jm.items()
                                               if not isinstance(v, dict) and np.ndim(v) == 0}))
    return out


# ---------------------------------------------------------------------------
# K1-K6 in float16: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _ulp_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() <= 2.0**-10 * np.abs(want).max()


@pytest.mark.parametrize("bh,s,d", [(2, 64, 16), (4, 40, 8), (2, 128, 16)])
def test_plain_flash_f16_matches_pallas(bh, s, d):
    """K3 (out, lse), K4 + K5 and K6 in float16: p rounded to v's type and
    ds to q's, as the Pallas kernels round them."""
    rng = np.random.default_rng(s)
    q, k, v, do = (rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(4))
    block, scale = jfa._block_sizes(s), float(1.0 / d**0.5)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.float16) for x in (q, k, v, do))
    out, lse = jfa._flash_fwd(jq, jk, jv, scale, block)
    tq, tk, tv, tdo = (torch.tensor(x).half() for x in (q, k, v, do))
    got_out, got_lse = fa.flash_forward(tq, tk, tv, scale, block)
    assert got_out.dtype == torch.float16 and out.dtype == jnp.float16
    _ulp_close(got_out, out)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0], rtol=0, atol=1e-5)
    tlse = torch.tensor(np.asarray(lse)[..., 0])
    delta = (tdo.float() * torch.tensor(np.asarray(out, np.float32)).half().float()).sum(-1)
    for mode, plain in (("split", fa.flash_bwd_split), ("fused", fa.flash_bwd_fused)):
        want = jfa._flash_bwd(scale, block, mode, (jq, jk, jv, out, lse), jdo)[:3]
        got = plain(tq, tk, tv, tdo, tlse, delta, scale, block)
        for g, w in zip(got, want):
            assert g.dtype == torch.float16
            _ulp_close(g, w)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape", [(5, 1000), (4, 16, 64), (3, 2048)])
def test_plain_fused_ln_f16_matches_pallas(shape, with_res):
    """K1's y and K2's dx, dres, dscale, dbias for float16 rows (float32
    scale and bias, float32 statistics)."""
    rng = np.random.default_rng(3)
    x, res = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    scale, bias = (rng.normal(size=shape[-1:]).astype(np.float32) for _ in range(2))
    jres = jnp.asarray(res, jnp.float16) if with_res else None
    want = jax_fused_layer_norm(jnp.asarray(x, jnp.float16), jnp.asarray(scale),
                                jnp.asarray(bias), residual=jres)
    tx = torch.tensor(x).half().requires_grad_()
    tres = torch.tensor(res).half().requires_grad_() if with_res else None
    tscale, tbias = (torch.tensor(a).requires_grad_() for a in (scale, bias))
    got = fl.fused_layer_norm(tx, tscale, tbias, residual=tres)
    assert got.dtype == torch.float16
    _ulp_close(got.detach(), want)

    def loss(x, scale, bias, res):
        y = jax_fused_layer_norm(x, scale, bias, residual=res)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    argnums = (0, 1, 2, 3) if with_res else (0, 1, 2)
    wants = jax.grad(loss, argnums)(jnp.asarray(x, jnp.float16), jnp.asarray(scale),
                                    jnp.asarray(bias), jres)
    torch.sin(got.float()).sum().backward()
    leaves = [tx, tscale, tbias] + ([tres] if with_res else [])
    for t, w in zip(leaves, wants):
        assert t.grad.dtype == t.dtype
        _ulp_close(t.grad, w)


# ---------------------------------------------------------------------------
# dynamic loss scaling against the JAX engine
# ---------------------------------------------------------------------------


def test_fp16_loss_scale_grows_as_in_jax():
    """init 1024, incr_every 2: five finite steps grow the scale twice, to
    4096, on the same steps as the JAX engine; the losses agree and fall."""
    jengine, mesh, engine = _engines(_fp16(1024.0, incr_every=2))
    assert engine.scaler == {"scale": 1024.0, "good_steps": 0}
    rows = _run(jengine, mesh, engine, 5, fixed=True)
    for m, jm in rows:
        assert m["found_inf"] == jm["found_inf"] == 0.0
        assert m["loss_scale"] == jm["loss_scale"]
        assert m["loss"] == pytest.approx(jm["loss"], rel=2e-4)
    assert [m["loss_scale"] for m, _ in rows] == [1024.0, 2048.0, 2048.0, 4096.0, 4096.0]
    assert float(jengine.state.scaler["scale"]) == engine.scaler["scale"] == 4096.0
    assert rows[-1][0]["loss"] < rows[0][0]["loss"]


def test_fp16_overflow_skips_and_halves_as_in_jax():
    """init 2**31 overflows the float16 grads: the step is skipped (params
    and optimizer state bitwise unchanged) and the scale halves, as in the
    JAX engine."""
    jengine, mesh, engine = _engines(_fp16(float(2.0**31)))
    before = {n: p.detach().clone() for n, p in engine.params.items()}
    (m, jm), = _run(jengine, mesh, engine, 1)
    assert m["found_inf"] == jm["found_inf"] == 1.0
    assert m["loss_scale"] == jm["loss_scale"] == 2.0**30
    assert engine.scaler == {"scale": 2.0**30, "good_steps": 0}
    assert all(torch.equal(p, before[n]) for n, p in engine.params.items())
    assert engine.opt_state[1]["count"] == 0


def test_fp16_scale_never_below_one():
    cfg = process_configs(AttrDict.from_nested(_raw(_fp16(1.0))))
    prec = engine_mod.resolve_precision(cfg, "float16")
    scaler = engine_mod.next_loss_scale({"scale": 1.0, "good_steps": 3}, False, prec)
    assert scaler == {"scale": 1.0, "good_steps": 0}


def test_precision_checks_match_jax():
    """The JAX engine's ValueErrors: a Model.dtype contradicting
    mix_precision.dtype, main_grad=False without AMP, multi_precision=False
    under float16."""
    cases = {
        "contradiction": {"Engine": {"mix_precision": {"enable": True, "dtype": "float16"}},
                          "Model": {"dtype": "bfloat16"}},
        "main_grad_without_amp": {"Engine": {"mix_precision": {"enable": False,
                                                               "main_grad": False}}},
        "fp16_without_masters": dict(_fp16(1024.0), Optimizer={"multi_precision": False}),
    }
    for name, overrides in cases.items():
        cfg = process_configs(AttrDict.from_nested(_raw(overrides)))
        with pytest.raises(ValueError):
            Engine(cfg, GPTModule(cfg), device="cpu")
        jcfg = jax_process_configs(JaxAttrDict.from_nested(_raw(overrides)), num_devices=1)
        with pytest.raises(ValueError):
            JaxEngine(jcfg, jax_build_module(jcfg), init_dist_env(jcfg, devices=jax.devices()[:1]))


# ---------------------------------------------------------------------------
# main_grad=False, bf16 moments, multi_precision=False against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LEVERS))
def test_low_precision_levers_match_jax(name):
    jengine, mesh, engine = _engines(LEVERS[name])
    rows = _run(jengine, mesh, engine, 8, fixed=True)
    losses = np.array([m["loss"] for m, _ in rows])
    want = np.array([jm["loss"] for _, jm in rows])
    assert all(m["found_inf"] == 0.0 for m, _ in rows)
    np.testing.assert_allclose(losses, want, rtol=1e-3)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.2
    params = {p.dtype for p in engine.params.values()}
    states = {t.dtype for part in engine.opt_state if isinstance(part, dict)
              for key in ("mu", "nu") if key in part for t in part[key].values()}
    jstates = {str(x.dtype) for x in jax.tree.leaves(jengine.state.opt_state)
               if x.dtype != jnp.int32}
    if name == "multi_precision_off":
        assert params == {torch.bfloat16} and states == {torch.bfloat16}
        assert jstates == {"bfloat16"}
    elif name == "bf16_moments":
        assert params == {torch.float32}
        mu = {t.dtype for t in engine.opt_state[1]["mu"].values()}
        nu = {t.dtype for t in engine.opt_state[1]["nu"].values()}
        assert mu == {torch.bfloat16} and nu == {torch.float32}
        assert jstates == {"bfloat16", "float32"}
    else:
        assert params == states == {torch.float32} and engine._grad_model is not None
        assert {p.dtype for p in engine._grad_model.parameters()} == {torch.bfloat16}


def test_main_grad_off_first_step_equals_float32_grads():
    """main_grad=False changes only where the grads accumulate: the first
    step's loss equals the float32-grad run's (tests/test_engine.py's
    1e-5), and its grads reach the optimizer in bfloat16."""
    runs = {}
    for name, overrides in (("on", BF16), ("off", LEVERS["main_grad_off"])):
        cfg = process_configs(AttrDict.from_nested(_raw(overrides)))
        engine = Engine(cfg, GPTModule(cfg), device="cpu")
        seen = []
        update = engine.tx.update
        engine.tx = engine.tx._replace(
            update=lambda g, s, p: (seen.append({x.dtype for x in g.values()}),
                                    update(g, s, p))[1])
        runs[name] = (engine.train_step(_batch(100))["loss"], seen[0])
    assert runs["off"][0] == pytest.approx(runs["on"][0], rel=1e-5)
    assert runs["on"][1] == {torch.float32} and runs["off"][1] == {torch.bfloat16}


# ---------------------------------------------------------------------------
# asynchronous saves
# ---------------------------------------------------------------------------


def _async_engine(tmp_path, overrides=None):
    raw = _raw(dict(overrides or {}))
    raw["Engine"]["save_load"] = {"save_steps": 0, "async_save": True,
                                  "output_dir": str(tmp_path / "out")}
    cfg = process_configs(AttrDict.from_nested(raw))
    return Engine(cfg, GPTModule(cfg), device="cpu")


def test_async_save_round_trip_restores_state_and_loss_scale(tmp_path):
    engine = _async_engine(tmp_path, _fp16(1024.0, incr_every=2))
    for i in range(3):
        engine.train_step(_batch(100 + i))
    path = engine.save()
    engine.train_step(_batch(200))  # the live state moves on while the write runs
    engine.wait_for_save()
    meta = json.loads(open(os.path.join(path, "meta.json")).read())
    assert meta["step"] == 3 and meta["loss_scale"] == 2048.0 and meta["scaler_good_steps"] == 1
    other = _async_engine(tmp_path / "b", _fp16(1024.0, incr_every=2))
    other.load(path)
    assert other.step == 3 and other.scaler == {"scale": 2048.0, "good_steps": 1}
    replay = _async_engine(tmp_path / "c", _fp16(1024.0, incr_every=2))
    for i in range(3):
        replay.train_step(_batch(100 + i))
    for n, p in other.params.items():
        assert torch.equal(p, replay.params[n]), n
    assert other.opt_state[1]["count"] == replay.opt_state[1]["count"] == 3


def test_async_save_write_error_surfaces(tmp_path, monkeypatch):
    """A write that fails in the background raises at the next wait (and
    leaves no meta.json, so the directory never looks complete)."""
    engine = _async_engine(tmp_path)
    engine.train_step(_batch(100))

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(engine_mod.torch, "save", broken)
    path = engine.save()
    with pytest.raises(OSError, match="disk full"):
        engine.wait_for_save()
    assert not os.path.exists(os.path.join(path, "meta.json"))
    engine.save(str(tmp_path / "again"))
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full"):
        engine.save()  # the failure in flight surfaces at the next save
    path = engine.save()
    engine.wait_for_save()
    assert os.path.exists(os.path.join(path, "meta.json"))
    assert not os.path.exists(os.path.join(tmp_path, "again", "meta.json"))


def test_async_save_joins_at_exit_over_a_weakref(tmp_path, monkeypatch):
    registered = []
    monkeypatch.setattr(engine_mod.atexit, "register", registered.append)
    engine = _async_engine(tmp_path)
    engine.train_step(_batch(100))
    assert not engine._atexit_registered
    path = engine.save()
    engine.save(str(tmp_path / "second"))
    assert engine._atexit_registered and len(registered) == 1
    registered[0]()  # what the interpreter runs at exit: joins the write
    assert engine._save_thread is None
    assert os.path.exists(os.path.join(path, "meta.json"))
    assert os.path.exists(os.path.join(tmp_path, "second", "meta.json"))
    del engine
    gc.collect()
    registered[0]()  # the hook does not keep the engine alive
