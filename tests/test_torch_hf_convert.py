"""PyTorch port: the HF GPT-2 converter, its CLI (safetensors and .bin,
without ``transformers``), the params-only checkpoint and the
``pretrained_params`` warm start, against the JAX converter on the CPU.

The HF-layout state dicts are built here from a seed (nothing is
downloaded).  Converted leaves are compared bitwise; logits against
``transformers.GPT2LMHeadModel`` at atol 2e-5 / rtol 1e-5, as
tests/test_hf_convert.py, where ``transformers`` is importable (the port
itself never imports it).
"""

import copy
import json
import os
import types

import numpy as np
import pytest
import torch

from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.models.gpt.convert import convert_hf_gpt2_state_dict as jax_convert
from paddlefleetx_tpu.models.gpt.convert import hf_gpt2_config as jax_hf_config
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.models import convert_common
from paddlefleetx_tpu_torch.models.gpt import model as pt_model
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.models.gpt.convert import convert_hf_gpt2_state_dict, hf_gpt2_config
from paddlefleetx_tpu_torch.tools import convert_hf_gpt2 as cli
from paddlefleetx_tpu_torch.utils.checkpoint import (
    CorruptCheckpoint,
    load_params_into,
    restore_params,
)
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

HF_CFG = {"vocab_size": 96, "n_positions": 32, "n_embd": 32, "n_layer": 2, "n_head": 4,
          "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5, "n_inner": None,
          "model_type": "gpt2"}


def _hf_state_dict(seed=0, prefix="transformer.", buffers=True, cfg=HF_CFG):
    """A GPT2LMHeadModel-layout state dict of seeded float32 tensors (the
    LayerNorm affines and biases non-trivial), with the mask buffers."""
    rng = np.random.default_rng(seed)
    h, v, L, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_layer"], cfg["n_positions"]

    def t(*shape, scale=0.05, mean=0.0):
        return torch.from_numpy((mean + scale * rng.standard_normal(shape)).astype(np.float32))

    sd = {"wte.weight": t(v, h, scale=0.2), "wpe.weight": t(P, h, scale=0.1),
          "ln_f.weight": t(h, mean=1.0), "ln_f.bias": t(h)}
    for i in range(L):
        p = f"h.{i}."
        sd.update({
            p + "ln_1.weight": t(h, mean=1.0), p + "ln_1.bias": t(h),
            p + "attn.c_attn.weight": t(h, 3 * h), p + "attn.c_attn.bias": t(3 * h),
            p + "attn.c_proj.weight": t(h, h), p + "attn.c_proj.bias": t(h),
            p + "ln_2.weight": t(h, mean=1.0), p + "ln_2.bias": t(h),
            p + "mlp.c_fc.weight": t(h, 4 * h), p + "mlp.c_fc.bias": t(4 * h),
            p + "mlp.c_proj.weight": t(4 * h, h), p + "mlp.c_proj.bias": t(h),
        })
        if buffers:
            sd[p + "attn.bias"] = torch.tril(torch.ones(P, P)).view(1, 1, P, P)
            sd[p + "attn.masked_bias"] = torch.tensor(-1e4)
    out = {prefix + k: val for k, val in sd.items()}
    out["lm_head.weight"] = sd["wte.weight"]
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_trees_bitwise(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys() and len(g) == 16
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


@pytest.mark.parametrize("pad", [None, 128])
@pytest.mark.parametrize("spelling", ["transformer.", "bare"])
def test_converter_matches_jax_bitwise(pad, spelling):
    over = {"vocab_size": pad} if pad else {}
    jcfg = jax_hf_config(types.SimpleNamespace(**HF_CFG), **over)
    want = jax_convert(_hf_state_dict(buffers=False), jcfg, pad_vocab_to=pad)
    sd = _hf_state_dict(prefix="" if spelling == "bare" else "transformer.")
    got = convert_hf_gpt2_state_dict(sd, hf_gpt2_config(HF_CFG, **over), pad_vocab_to=pad)
    _assert_trees_bitwise(got, want)
    if pad:
        assert got["embeddings"]["word"].shape == (128, 32)
        assert not got["embeddings"]["word"][96:].any()


def test_converter_refuses_bad_vocab_padding():
    with pytest.raises(ValueError, match="pad_vocab_to 64 < vocab 96"):
        convert_hf_gpt2_state_dict(_hf_state_dict(), hf_gpt2_config(HF_CFG), pad_vocab_to=64)
    with pytest.raises(ValueError, match="config vocab_size 128 != embedding rows 96"):
        convert_hf_gpt2_state_dict(_hf_state_dict(), hf_gpt2_config(HF_CFG, vocab_size=128))


BAD_VARIANTS = {
    "activation_function": {"activation_function": "gelu"},
    "layer_norm_epsilon": {"layer_norm_epsilon": 1e-6},
    "n_inner": {"n_inner": 100},
    "scale_attn_by_inverse_layer_idx": {"scale_attn_by_inverse_layer_idx": True},
    "reorder_and_upcast_attn": {"reorder_and_upcast_attn": True},
}


@pytest.mark.parametrize("name", sorted(BAD_VARIANTS))
def test_variant_refusals_match_jax(name):
    bad = {**HF_CFG, **BAD_VARIANTS[name]}
    with pytest.raises(ValueError) as want:
        jax_hf_config(types.SimpleNamespace(**bad))
    for form in (bad, types.SimpleNamespace(**bad)):
        with pytest.raises(ValueError) as got:
            hf_gpt2_config(form)
        assert str(got.value) == str(want.value) and name in str(got.value)


def test_config_matches_jax():
    want = jax_hf_config(types.SimpleNamespace(**HF_CFG), dtype="float32")
    got = hf_gpt2_config(HF_CFG, dtype="float32")
    for f in ("vocab_size", "hidden_size", "num_layers", "num_attention_heads",
              "max_position_embeddings", "ffn_hidden_size", "dtype"):
        assert getattr(got, f) == getattr(want, f), f


def test_to_numpy_widens_bf16_exactly():
    x = torch.randn(5, 3).to(torch.bfloat16)
    np.testing.assert_array_equal(convert_common.to_numpy(x), x.float().numpy())
    assert convert_common.detect_prefix({"a.x": 1, "b": 2}, ("z.", "a.")) == "a."


def _write_hf_dir(path, fmt, sd):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(HF_CFG, f)
    if fmt == "safetensors":
        cli.write_safetensors(os.path.join(path, "model.safetensors"),
                              {k: v.numpy() for k, v in sd.items()})
    else:
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return str(path)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("spelling", ["transformer.", "bare"])
def test_cli_writes_the_params_only_directory(tmp_path, fmt, spelling):
    sd = _hf_state_dict(seed=1, prefix="" if spelling == "bare" else "transformer.")
    src = _write_hf_dir(tmp_path / "hf", fmt, sd)
    out = tmp_path / "conv"
    assert cli.main(["--model", src, "-o", str(out), "--pad-vocab-to", "128"]) == 0
    assert sorted(os.listdir(out)) == ["meta.json", "model.yaml", "params.pt"]
    meta = json.loads((out / "meta.json").read_text())
    assert meta == {"format": "params-only", "source": f"hf-gpt2:{src}"}
    assert "vocab_size: 128" in (out / "model.yaml").read_text()
    got = restore_params(str(out))
    cfg = hf_gpt2_config(HF_CFG, vocab_size=128)
    jcfg = jax_hf_config(types.SimpleNamespace(**HF_CFG), vocab_size=128)
    want = params_from_jax(cfg, jax_convert(_hf_state_dict(seed=1, buffers=False), jcfg,
                                            pad_vocab_to=128), trainable=True)
    named = dict(want.named_parameters())
    assert got.keys() == named.keys()
    for n, p in named.items():
        assert got[n].dtype == torch.float32
        assert torch.equal(got[n], p.detach()), n


def test_safetensors_reader_and_writer_against_the_library(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(2)
    tensors = {"a": rng.standard_normal((3, 5)).astype(np.float32),
               "b.c": rng.standard_normal((7,)).astype(np.float16),
               "s": np.array(1.5, np.float32)}
    st.save_file(tensors, str(tmp_path / "lib.safetensors"), metadata={"format": "np"})
    got = cli.read_safetensors(str(tmp_path / "lib.safetensors"))
    assert got.keys() == tensors.keys()
    for k in tensors:
        assert got[k].dtype == tensors[k].dtype
        np.testing.assert_array_equal(got[k], tensors[k])
    cli.write_safetensors(str(tmp_path / "ours.safetensors"), tensors)
    back = st.load_file(str(tmp_path / "ours.safetensors"))
    for k in tensors:
        np.testing.assert_array_equal(back[k], tensors[k])
    # BF16 payloads widen exactly
    import safetensors.torch as stt

    x = torch.randn(4, 6).to(torch.bfloat16)
    stt.save_file({"x": x}, str(tmp_path / "bf16.safetensors"))
    np.testing.assert_array_equal(cli.read_safetensors(str(tmp_path / "bf16.safetensors"))["x"],
                                  x.float().numpy())


def test_converted_logits_match_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(vocab_size=96, n_positions=32, n_embd=32, n_layer=2,
                                     n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = hf_gpt2_config(hf_cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                         dtype="float32")
    model = params_from_jax(cfg, convert_hf_gpt2_state_dict(hf.state_dict(), cfg))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 96, (2, 16)))
    with torch.no_grad():
        ref = hf(tokens).logits.numpy()
        ours = pt_model.forward(model, tokens, cfg, train=False).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-5)


ENGINE_RAW = {
    "Global": {"global_batch_size": 4, "micro_batch_size": 2, "seed": 5},
    "Engine": {"max_steps": 1, "eval_freq": 0, "logging_freq": 100,
               "mix_precision": {"enable": False}, "save_load": {"save_steps": 0}},
    "Model": {"module": "GPTModule", "vocab_size": 128, "hidden_size": 32, "num_layers": 2,
              "num_attention_heads": 4, "max_position_embeddings": 32,
              "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "dtype": "float32"},
    "Distributed": {},
    "Optimizer": {"name": "FusedAdamW", "lr": {"name": "Constant", "learning_rate": 1e-3}},
}


def _engine(save_load, vocab=128):
    raw = copy.deepcopy(ENGINE_RAW)
    raw["Engine"]["save_load"].update(save_load)
    raw["Model"]["vocab_size"] = vocab
    cfg = process_configs(AttrDict.from_nested(raw))
    return Engine(cfg, GPTModule(cfg), device="cpu")


def _fresh(tree):
    if isinstance(tree, dict):
        return all(_fresh(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return all(_fresh(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return not tree.any()
    return tree == 0


def test_engine_warm_start_from_converted_params(tmp_path):
    src = _write_hf_dir(tmp_path / "hf", "safetensors", _hf_state_dict(seed=3))
    conv = str(tmp_path / "conv")
    cli.main(["--model", src, "-o", conv, "--pad-vocab-to", "128"])
    want = restore_params(conv)
    engine = _engine({"pretrained_params": conv})
    assert engine.params.keys() == want.keys()
    for n, p in engine.params.items():
        assert torch.equal(p.detach(), want[n]), n
    assert _fresh(engine.opt_state) and engine.step == 0
    # the model trains from there, and ckpt_dir takes over the warm start
    engine.train_step({"tokens": np.ones((4, 16), np.int64), "labels": np.ones((4, 16), np.int64),
                       "loss_mask": np.ones((4, 16), np.float32)})
    seeded = _engine({})
    skipped = _engine({"pretrained_params": conv, "ckpt_dir": str(tmp_path / "elsewhere")})
    for n, p in skipped.params.items():
        assert torch.equal(p, seeded.params[n]), n


def test_loading_another_config_names_the_leaf_and_the_hint(tmp_path):
    src = _write_hf_dir(tmp_path / "hf", "bin", _hf_state_dict(seed=4))
    conv = str(tmp_path / "conv")
    cli.main(["--model", src, "-o", conv])  # vocab 96, unpadded
    with pytest.raises(ValueError, match=r"embeddings\.word: model \(128, 32\) vs checkpoint "
                                         r"\(96, 32\) \(hint: --pad-vocab-to"):
        _engine({"pretrained_params": conv})
    model = pt_model.GPTModel(hf_gpt2_config(HF_CFG, num_layers=1))
    with pytest.raises(ValueError, match="layers.1.ln_1.scale is not in the model"):
        load_params_into(model, restore_params(conv), "x")
    with open(os.path.join(conv, "params.pt"), "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(CorruptCheckpoint, match="unreadable"):
        restore_params(conv)
    with pytest.raises(FileNotFoundError):
        restore_params(str(tmp_path / "hf"))


def test_serving_dtype_rounds_as_the_bridge(tmp_path):
    """A bf16 serving model loaded from float32 params holds what the
    bridge gives from the same tree: weights rounded once, LayerNorms
    float32."""
    cfg = hf_gpt2_config(HF_CFG)
    tree = convert_hf_gpt2_state_dict(_hf_state_dict(seed=6), cfg)
    masters = dict(params_from_jax(cfg, tree, trainable=True).named_parameters())
    served = load_params_into(pt_model.GPTModel(cfg), {n: p.detach() for n, p in masters.items()},
                              "x")
    want = dict(params_from_jax(cfg, tree).named_parameters())
    for n, p in served.named_parameters():
        assert p.dtype == want[n].dtype and torch.equal(p, want[n]), n
    assert served.layers[0].ln_1.scale.dtype == torch.float32
    assert served.layers[0].attn.qkv_kernel.dtype == torch.bfloat16
    assert JaxGPTConfig(**{"dtype": "bfloat16"}).dtype == cfg.dtype
