"""PyTorch port, the GPT pretraining step, against the JAX package on
the CPU: the model's loss and every parameter grad (``loss_fn``) for each
attention implementation and recompute granularity, the LR schedules,
the optimizer, and ``Engine.train_step`` with gradient accumulation and a
non-finite step.

The TINY GPT of ``tests/test_kv_tier.py`` (vocab 96, 2 layers, hidden 32,
4 heads), float32, dropout 0 (the dropout masks of the two packages come
from different generators).  Weights move through the bridge; inputs are
seeded numpy arrays.  Tolerances: loss and grads 1e-5 (float32, summation
order); schedules 1e-6 relative; optimizer params after 5 steps 1e-6
relative to each leaf's largest value; engine metrics and params 1e-5.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlefleetx_tpu.core.engine import Engine as JaxEngine
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.optims import optimizer as jax_opt
from paddlefleetx_tpu.optims.lr_scheduler import build_lr_scheduler as jax_build_lr
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import model as gpt
from paddlefleetx_tpu_torch.models.gpt.bridge import grads_to_jax, params_from_jax, params_to_jax
from paddlefleetx_tpu_torch.models.gpt.config import GPTConfig
from paddlefleetx_tpu_torch.ops import flash_attention as fa
from paddlefleetx_tpu_torch.optims import optimizer as opt
from paddlefleetx_tpu_torch.optims.lr_scheduler import build_lr_scheduler
from paddlefleetx_tpu_torch.tools import profile_train
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

MODEL = {"vocab_size": 96, "hidden_size": 32, "num_layers": 2, "num_attention_heads": 4,
         "max_position_embeddings": 128, "dtype": "float32",
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
SEQ = 64
ATTN = {"xla": ("xla", ""), "flash_split": ("flash", "split"), "flash_fused": ("flash", "fused")}
RECOMPUTE = ["off", "full", "selective", "full_attn", "core_attn"]


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


def _assert_trees_close(got, want, tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    for (path, g), w in zip(flat_got, jax.tree.leaves(want)):
        err = np.abs(np.asarray(g) - np.asarray(w)).max()
        assert err <= tol, (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# loss_fn: loss and every parameter grad
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reference():
    """jax.value_and_grad(loss_fn) per attention implementation."""
    tree, batch = _tree(), _batch(2)
    out = {}
    for attn in ATTN:
        cfg = JaxGPTConfig(**_model_kw(attn, "off"))
        loss, grads = jax.value_and_grad(jax_model.loss_fn)(
            jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}, cfg
        )
        out[attn] = (float(loss), jax.tree.map(np.asarray, grads))
    return tree, batch, out


# flash plain-version calls for the 2-layer model: one forward and one
# backward per layer, plus a second forward per layer where the recompute
# re-runs the attention core; "selective" keeps the flash op's outputs
FLASH_CALLS = {"off": 4, "full": 6, "selective": 4, "full_attn": 6, "core_attn": 6}


@pytest.mark.parametrize("recompute", RECOMPUTE)
@pytest.mark.parametrize("attn", sorted(ATTN))
def test_loss_and_grads_match_jax(attn, recompute, jax_reference):
    tree, batch, ref = jax_reference
    cfg = GPTConfig(**_model_kw(attn, recompute))
    model = params_from_jax(cfg, tree, trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    before = fa.COUNTS["flash_plain"]
    loss = gpt.loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    loss.backward()
    want_loss, want_grads = ref[attn]
    assert abs(loss.item() - want_loss) <= 1e-5
    _assert_trees_close(grads_to_jax(model), want_grads, 1e-5)
    calls = fa.COUNTS["flash_plain"] - before
    assert calls == (FLASH_CALLS[recompute] if attn != "xla" else 0), calls


# ---------------------------------------------------------------------------
# LR schedules and the optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {
    "cosine_warmup": {"name": "CosineAnnealingWithWarmupDecay", "max_lr": 1e-3,
                      "min_lr": 1e-5, "warmup_rate": 0.25, "decay_steps": 16},
    "linear_warmup": {"name": "LinearDecayWithWarmup", "learning_rate": 1e-3,
                      "total_steps": 15, "warmup": 0.2},
    "vit_cosine": {"name": "ViTLRScheduler", "learning_rate": 3e-3, "total_steps": 16,
                   "warmup_steps": 3},
    "vit_linear": {"name": "ViTLRScheduler", "learning_rate": 3e-3, "total_steps": 16,
                   "warmup_steps": 3, "decay_type": "linear"},
    "multi_step": {"name": "MultiStepDecay", "learning_rate": 0.1, "milestones": [3, 7, 12],
                   "gamma": 0.5},
    "cosine": {"name": "CosineDecay", "learning_rate": 1e-3, "total_steps": 12},
    "constant": {"name": "Constant", "learning_rate": 1e-4},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    ours, theirs = build_lr_scheduler(SCHEDULES[name]), jax_build_lr(SCHEDULES[name])
    got = np.array([float(ours(c)) for c in range(20)])
    want = np.array([float(theirs(c)) for c in range(20)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


OPTIMIZERS = {
    "adamw_clip_increments": {
        "name": "FusedAdamW", "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.95,
        "lr": {"name": "CosineAnnealingWithWarmupDecay", "max_lr": 1e-2, "min_lr": 1e-3,
               "warmup_rate": 0.1, "decay_steps": 40, "use_increments": True},
        "grad_clip": {"name": "ClipGradByGlobalNorm", "clip_norm": 1.0}},
    "adam_clip_shorthand": {"name": "Adam", "lr": {"name": "Constant", "learning_rate": 1e-3},
                            "grad_clip": 2.0},
    "momentum_decay": {"name": "Momentum", "momentum": 0.9, "weight_decay": 0.01,
                       "lr": {"name": "Constant", "learning_rate": 1e-2}},
}


def _port_named(tree, cfg):
    """A JAX-layout tree as {port parameter name: tensor}."""
    out = {}
    for group in ("embeddings", "final_ln"):
        for leaf, arr in tree[group].items():
            out[f"{group}.{leaf}"] = torch.tensor(np.asarray(arr))
    for group, leaves in tree["layers"].items():
        for leaf, arr in leaves.items():
            for i in range(cfg.num_layers):
                out[f"layers.{i}.{group}.{leaf}"] = torch.tensor(np.asarray(arr)[i])
    return out


def test_decay_mask_matches_jax_per_leaf():
    tree = _tree()
    model = params_from_jax(GPTConfig(**MODEL), tree, trainable=True)
    got = opt.decay_mask(dict(model.named_parameters()))
    jmask = jax_opt._no_decay_mask(tree)
    want = {f"{g}.{leaf}": bool(jmask[g][leaf]) for g in ("embeddings", "final_ln")
            for leaf in jmask[g]}
    want.update({f"layers.{i}.{g}.{leaf}": bool(m) for g, leaves in jmask["layers"].items()
                 for leaf, m in leaves.items() for i in range(MODEL["num_layers"])})
    assert got == want
    # stacked layers make every layer leaf 2-D or more in the JAX layout
    assert got["layers.0.attn.qkv_bias"] and got["layers.1.ln_2.scale"]
    assert not got["final_ln.scale"] and not got["final_ln.bias"]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    cfg = GPTConfig(**MODEL)
    tree = _tree()
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
             for _ in range(5)]
    jtx, _ = jax_opt.build_optimizer(copy.deepcopy(OPTIMIZERS[name]), count_scale=4)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    for g in grads:
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    tx, _ = opt.build_optimizer(copy.deepcopy(OPTIMIZERS[name]), count_scale=4)
    model = params_from_jax(cfg, tree, trainable=True)
    params = dict(model.named_parameters())
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(_port_named(g, cfg), state, params)
        opt.apply_updates(params, updates)
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(params_to_jax(model)),
                                 jax.tree.leaves(jparams)):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), jax.tree_util.keystr(path)


def test_optimizer_refuses_low_precision_state():
    for extra in ({"moment_dtype": "bfloat16"}, {"multi_precision": False}):
        with pytest.raises(NotImplementedError):
            opt.build_optimizer(dict(OPTIMIZERS["adamw_clip_increments"], **extra))


# ---------------------------------------------------------------------------
# Engine.train_step against the JAX engine
# ---------------------------------------------------------------------------

ENGINE_CFG = {
    "Global": {"global_batch_size": 4, "micro_batch_size": 2, "seed": 7},
    "Engine": {"max_steps": 3, "logging_freq": 1, "mix_precision": {"enable": False},
               "save_load": {"save_steps": 0}},
    "Model": dict(MODEL, module="GPTModule", attn_impl="flash", flash_bwd="fused",
                  use_recompute=True, recompute_granularity="selective"),
    "Distributed": {},
    "Optimizer": {"name": "FusedAdamW", "weight_decay": 0.01, "beta1": 0.9, "beta2": 0.95,
                  "lr": {"name": "CosineAnnealingWithWarmupDecay", "max_lr": 1e-3,
                         "min_lr": 1e-4, "warmup_steps": 2, "decay_steps": 10},
                  "grad_clip": {"name": "ClipGradByGlobalNorm", "clip_norm": 1.0}},
}


def _port_cfg(**overrides):
    raw = copy.deepcopy(ENGINE_CFG)
    for section, values in overrides.items():
        raw.setdefault(section, {}).update(values)
    return process_configs(AttrDict.from_nested(raw))


@pytest.fixture(scope="module")
def jax_engine():
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(ENGINE_CFG)),
                              num_devices=1)
    mesh = init_dist_env(cfg, devices=jax.devices()[:1])
    with mesh:
        engine = JaxEngine(cfg, build_module(cfg), mesh)
    return engine, mesh


def test_engine_train_step_matches_jax(jax_engine):
    """Three steps with accumulate_steps 2; the second is non-finite (an
    inf in loss_mask): it is skipped whole (params and optimizer state,
    step counts included), so the third step applies the learning rate of
    optimizer count 1 while its lr metric reads engine step 2."""
    jengine, mesh = jax_engine
    cfg = _port_cfg()
    assert cfg.Engine.accumulate_steps == 2
    module = GPTModule(cfg)
    tree = jax.tree.map(np.asarray, jengine.state.params)
    engine = Engine(cfg, module, device="cpu",
                    model=params_from_jax(module.config, tree, trainable=True))
    batches = [_batch(4, seed=s) for s in (11, 12, 13)]
    batches[1]["loss_mask"][0, 3] = np.inf
    for i, batch in enumerate(batches):
        with mesh:
            jengine.state, jm = jengine.train_step(jengine.state, jengine._put_batch(batch))
        m = engine.train_step(batch)
        want = {k: float(jm[k]) for k in ("loss", "grad_norm", "lr", "found_inf")}
        assert m["found_inf"] == want["found_inf"] == (1.0 if i == 1 else 0.0)
        assert m["lr"] == pytest.approx(want["lr"], rel=1e-6)
        for key in ("loss", "grad_norm"):
            if i == 1:
                assert not np.isfinite(m[key]) and not np.isfinite(want[key])
            else:
                assert m[key] == pytest.approx(want[key], rel=1e-5), key
        _assert_trees_close(params_to_jax(engine.model),
                            jax.tree.map(np.asarray, jengine.state.params), 1e-5)
    assert engine.step == 3 and engine.opt_state[1]["count"] == 2


REFUSED = {
    "chunked_ce": {"Model": {"use_chunked_ce": True}},
    "ring_attention": {"Model": {"attn_impl": "ring"}},
    "sequence_parallel": {"Distributed": {"sequence_parallel": True}},
    "fp16_loss_scaling": {"Engine": {"mix_precision": {"enable": True, "dtype": "float16"}},
                          "Model": {"dtype": "bfloat16"}},
    "main_grad_off": {"Engine": {"mix_precision": {"enable": True, "dtype": "bfloat16",
                                                   "main_grad": False}},
                      "Model": {"dtype": "bfloat16"}},
    "qat": {"Compress": {"Quantization": {"enable": True}}},
    "offload": {"Distributed": {"sharding": {"sharding_degree": 1, "offload": True}}},
    "model_stats": {"Engine": {"logging": {"model_stats_every": 5}}},
    "bf16_moments": {"Optimizer": {"moment_dtype": "bfloat16"}},
    "parallel_degree": {"Distributed": {"mp_degree": 2}},
}


# refused until its port landed; its case now holds the step against the
# unfused one (the same math: equal on the CPU to float32 rounding)
PORTED = {"fused_ln": {"Model": {"use_fused_ln": True}}}


@pytest.mark.parametrize("name", sorted(REFUSED) + sorted(PORTED))
def test_training_refuses_what_is_not_ported(name):
    if name in PORTED:
        metrics = []
        for overrides in ({}, PORTED[name]):
            cfg = _port_cfg(**overrides)
            engine = Engine(cfg, GPTModule(cfg), device="cpu")
            metrics.append(engine.train_step(_batch(4)))
        for key in ("loss", "grad_norm"):
            assert metrics[1][key] == pytest.approx(metrics[0][key], rel=1e-6), key
        return
    with pytest.raises(NotImplementedError):
        cfg = _port_cfg(**REFUSED[name])
        Engine(cfg, GPTModule(cfg), device="cpu").train_step(_batch(4))


def test_serving_still_takes_a_training_only_config():
    """use_fused_ln is a training setting: the serving path runs a config
    that sets it with the plain LayerNorm (as JAX's generation does), and
    the training loss through K1/K2's plain versions equals the unfused
    loss."""
    cfg = _port_cfg(Model={"use_fused_ln": True},
                    Generation={"max_dec_len": 4, "decode_strategy": "greedy_search",
                                "eos_token_id": 95, "pad_token_id": 0})
    module = GPTModule(cfg)
    assert module.config.use_fused_ln
    server = GenerationServer(cfg, module, module.init_model(7, "cpu"), torch.device("cpu"))
    out = server.generate_ids([[5, 6, 7]], max_dec_len=4)
    assert len(out) == 1 and 0 < len(out[0]) <= 4
    model, batch = module.init_params(7, "cpu"), {k: torch.as_tensor(v)
                                                   for k, v in _batch(1).items()}
    fused = gpt.loss_fn(model, batch, module.config)
    unfused = gpt.loss_fn(model, batch, dataclasses.replace(module.config, use_fused_ln=False))
    assert fused.item() == pytest.approx(unfused.item(), rel=1e-6)


def test_profile_train_runs_on_cpu(tmp_path):
    """tools/profile_train at a tiny width on the CPU: step timings and the
    host operator table (no card: no device time)."""
    out = tmp_path / "prof.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["-c", os.path.join(repo, "configs/gpt/pretrain_gpt_345M_single.yaml"),
            "--device", "cpu", "--batch", "4", "--seq", "32", "--steps", "2", "--out", str(out)]
    for o in ("Model.num_layers=2", "Model.hidden_size=32", "Model.num_attention_heads=4",
              "Model.vocab_size=96", "Model.attn_impl=flash", "Global.global_batch_size=4",
              "Global.local_batch_size=4", "Global.micro_batch_size=2"):
        argv += ["-o", o]
    assert profile_train.main(argv) == 0
    res = json.loads(out.read_text())
    assert res["accumulate_steps"] == 2 and len(res["step_ms"]) == 2
    assert res["host_us_per_step"] > 0 and len(res["host_ops"]) > 3
    assert res["device_us_per_step"] == 0 and sum(res["groups_us_per_step"].values()) == 0
