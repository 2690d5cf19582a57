"""PyTorch port: from a trained checkpoint to served text, on the CPU.

The port's train CLI trains the TINY model (tests/test_kv_tier.py: vocab
96, 2 layers, hidden 32, 4 heads, float32) for a few steps; its
``step_<N>`` directory is then loaded as params
(``utils/checkpoint.load_pretrained_params``) and served by the serve CLI
with a GPT BPE tokenizer built here (43 byte symbols, learned merges up
to id 94, ``<|endoftext|>`` at the config's EOS id 95, so every id the
model can emit decodes).  Held against the JAX package on the bridged
params: greedy and beam tokens identical, the served completion text
equal to the JAX ``GenerationServer.generate_text``.
"""

import copy
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.core.continuous_batching import PagedDecodeEngine as JaxEngine
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.data.tokenizers.gpt_tokenizer import GPTTokenizer as JaxTokenizer
from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core.continuous_batching import PagedDecodeEngine
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.data import gpt_dataset as gd
from paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer, bytes_to_unicode
from paddlefleetx_tpu_torch.models.gpt import generation as pt_gen
from paddlefleetx_tpu_torch.models.gpt.bridge import params_to_jax
from paddlefleetx_tpu_torch.models.gpt.model import GPTModel
from paddlefleetx_tpu_torch.tools.serve import build_server
from paddlefleetx_tpu_torch.utils.checkpoint import (
    CorruptCheckpoint,
    load_params_into,
    load_pretrained_params,
    restore_params,
)
from paddlefleetx_tpu_torch.utils.config import get_config
from test_torch_tokenizer import _learn_merges

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "gpt", "pretrain_gpt_345M_single.yaml")
STEPS = 4
MODEL_OVERRIDES = ["Model.num_layers=2", "Model.hidden_size=32", "Model.num_attention_heads=4",
                   "Model.vocab_size=96", "Model.max_position_embeddings=128",
                   "Engine.mix_precision.enable=False"]
GEN_OVERRIDES = ["Generation.decode_strategy=greedy_search", "Generation.max_dec_len=8",
                 "Generation.pad_to_multiple=8", "Generation.eos_token_id=95",
                 "Generation.pad_token_id=0"]
TRAIN_OVERRIDES = ["Global.global_batch_size=4", "Global.local_batch_size=4",
                   "Global.micro_batch_size=2",
                   'Optimizer.lr={"name": "Constant", "learning_rate": 1.0e-4}']
ALPHABET = " abcdefghijklmnopqrstuvwxyz0123456789.,!?'\n"
TEXTS = ["the cat sat on the mat", "hello world, it's me", "abc 123", "one more prompt here!"]


def _seeded_text(seed, n_words=2000):
    rnd = random.Random(seed)
    syl = ["th", "e", "an", "in", "er", "on", "re", "at", "st", "ou", "ing", "ch", "s", "a"]
    words = ["".join(rnd.choice(syl) for _ in range(rnd.randint(1, 3))) for _ in range(n_words)]
    return " ".join(words)


def _write_tokenizer(path):
    """The byte symbols of ``ALPHABET`` (ids 0-42), the merges of a short
    BPE pass over a seeded text (ids 43-94), ``<|endoftext|>`` at 95."""
    b2u = bytes_to_unicode()
    symbols = [b2u[b] for b in ALPHABET.encode()]
    merges = _learn_merges(_seeded_text(0), 95 - len(symbols))
    vocab = {s: i for i, s in enumerate(symbols + [a + b for a, b in merges])}
    vocab["<|endoftext|>"] = 95
    assert len(vocab) == 96 and sorted(vocab.values()) == list(range(96))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(path)


def _spawn(module, args):
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES=""))
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    return proc, lines, reader


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(step_<STEPS> directory, tokenizer directory) of a train CLI run."""
    root = tmp_path_factory.mktemp("serve_text")
    data = root / "data"
    gd.write_synthetic_corpus(str(data / "tiny"), vocab_size=96, num_docs=60, mean_len=80,
                              seed=3)
    out = root / "out"
    args = ["-c", CONFIG, "--device", "cpu"]
    for o in MODEL_OVERRIDES + TRAIN_OVERRIDES + [
            f"Data.Train.dataset.input_dir={data}",
            f"Data.Eval.dataset.input_dir={data}", "Data.Train.dataset.max_seq_len=64",
            "Data.Eval.dataset.max_seq_len=64", f"Engine.max_steps={STEPS}",
            "Engine.eval_freq=0", "Engine.logging_freq=1", f"Engine.save_load.save_steps={STEPS}",
            f"Engine.save_load.output_dir={out}"]:
        args += ["-o", o]
    proc, lines, reader = _spawn("paddlefleetx_tpu_torch.tools.train", args)
    rc = proc.wait(timeout=300)
    reader.join(timeout=30)
    assert rc == 0, "".join(lines)[-3000:]
    return str(out / f"step_{STEPS}"), _write_tokenizer(root / "tok")


def _overrides(ckpt, tok=None, extra=()):
    out = MODEL_OVERRIDES + GEN_OVERRIDES + [f"Engine.save_load.ckpt_dir={ckpt}"]
    return out + ([f"Generation.tokenizer_dir={tok}"] if tok else []) + list(extra)


def _jax_params(model):
    return jax.tree.map(jnp.asarray, params_to_jax(model))


def _jax_cfg():
    return JaxGPTConfig(vocab_size=96, hidden_size=32, num_layers=2, num_attention_heads=4,
                        max_position_embeddings=128, dtype="float32")


def test_tokenizer_vocab_covers_every_model_id(trained):
    _, tok_dir = trained
    tok = GPTTokenizer.from_pretrained(tok_dir)
    assert tok.vocab_size == 96 and tok.eos_token_id == 95
    for text in TEXTS:
        assert tok.decode(tok.encode(text)) == text
        assert tok.encode(text) == JaxTokenizer.from_pretrained(tok_dir).encode(text)
    assert all(tok.decode([i]) for i in range(96))


def test_loaded_step_serves_the_engine_params(trained):
    """The step's params through load_pretrained_params are the engine's;
    the server built on them answers what ``generate`` gives on the
    engine's own params, and what JAX gives on them (greedy and beam)."""
    ckpt, _ = trained
    cfg = get_config(CONFIG, overrides=_overrides(ckpt))
    params = load_pretrained_params(cfg)
    assert params.keys() == restore_params(ckpt).keys()
    engine = Engine(get_config(CONFIG, overrides=MODEL_OVERRIDES + TRAIN_OVERRIDES),
                    GPTModule(cfg), device="cpu")
    engine.load(ckpt)
    assert engine.step == STEPS
    for n, p in engine.params.items():
        assert torch.equal(p, params[n]), n
    served = build_server(CONFIG, _overrides(ckpt), device="cpu")
    own = load_params_into(GPTModel(served.module.config),
                           {n: p.detach() for n, p in engine.params.items()}, "engine")
    prompts = [[5, 17, 33, 2, 8], [40, 41, 42, 43], [3, 9, 27, 60, 61, 62, 70, 71, 72]]
    ids, lens = pt_gen.pad_prompts(prompts, 0, 8)
    jids, jlens = jax_gen.pad_prompts(prompts, 0, multiple=8)
    for strategy in ("greedy_search", "beam_search"):
        gen = pt_gen.GenerationConfig(max_dec_len=8, decode_strategy=strategy, eos_token_id=95,
                                      pad_token_id=0)
        want = pt_gen.generate(own, ids, gen, prompt_lens=lens)
        got = pt_gen.generate(served.model, ids, gen, prompt_lens=lens)
        assert torch.equal(got, want), strategy
        ref = jax_gen.generate(_jax_params(served.model), jids, _jax_cfg(),
                               jax_gen.GenerationConfig(max_dec_len=8, decode_strategy=strategy,
                                                        eos_token_id=95, pad_token_id=0),
                               prompt_lens=jlens)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the server pads the batch to 4 rows and cuts each answer at EOS
    greedy = pt_gen.GenerationConfig(max_dec_len=8, decode_strategy="greedy_search",
                                     eos_token_id=95, pad_token_id=0)
    ids4, lens4 = pt_gen.pad_prompts(prompts + prompts[-1:], 0, 8)
    want = pt_gen.generate(own, ids4, greedy, prompt_lens=lens4).tolist()[:3]
    assert served.generate_ids(prompts, max_dec_len=8) == [
        w[:w.index(95)] if 95 in w else w for w in want]


def test_a_checkpoint_of_another_config_fails_with_the_hint(trained, tmp_path):
    ckpt, _ = trained
    with pytest.raises(ValueError, match=r"embeddings\.word: model \(128, 32\) vs checkpoint "
                                         r"\(96, 32\) \(hint: --pad-vocab-to"):
        build_server(CONFIG, _overrides(ckpt, extra=["Model.vocab_size=128"]), device="cpu")
    with pytest.raises(ValueError, match="layers.2.ln_1.scale is missing"):
        build_server(CONFIG, _overrides(ckpt, extra=["Model.num_layers=3"]), device="cpu")
    bad = tmp_path / "step_1"
    bad.mkdir()
    (bad / "meta.json").write_text(json.dumps({"step": 1}))
    (bad / "state.pt").write_bytes(b"\x00" * 64)
    with pytest.raises(CorruptCheckpoint, match="unreadable"):
        build_server(CONFIG, _overrides(str(bad)), device="cpu")


def _jax_text_server(served, tok_dir):
    raw = {"Global": {"global_batch_size": 8, "seed": 7}, "Engine": {"mix_precision": {"enable": False}},
           "Model": {"module": "GPTModule", "vocab_size": 96, "hidden_size": 32,
                     "num_layers": 2, "num_attention_heads": 4,
                     "max_position_embeddings": 128, "dtype": "float32"},
           "Distributed": {},
           "Generation": {"max_dec_len": 8, "decode_strategy": "greedy_search",
                          "pad_to_multiple": 8, "eos_token_id": 95, "pad_token_id": 0}}
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(raw)),
                              num_devices=jax.device_count())
    return JaxServer(cfg, init_dist_env(cfg), build_module(cfg), params=_jax_params(served.model),
                     tokenizer=JaxTokenizer.from_pretrained(tok_dir))


def _post(port, body, stream=False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate" + ("?stream=1" if stream else ""),
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if not stream:
            return json.load(r)
        text = r.read().decode()
    frames = []
    for block in text.strip().split("\n\n"):
        fields = dict(line.split(": ", 1) for line in block.splitlines())
        frames.append((fields["event"], json.loads(fields["data"])))
    return frames


@pytest.mark.parametrize("scheduler", ["coalesce", "continuous"])
def test_serve_cli_answers_text_like_jax(trained, scheduler):
    """``tools.serve --device cpu`` with ckpt_dir and tokenizer_dir answers
    {"prompt": ...} with the JAX server's ``generate_text`` on the same
    params (beside the request's ``trace_id``); streamed frames carry their
    tokens' text, which joins to the completion."""
    ckpt, tok_dir = trained
    served = build_server(CONFIG, _overrides(ckpt, tok_dir), device="cpu")
    want = _jax_text_server(served, tok_dir).generate_text(TEXTS, max_dec_len=8)
    assert served.generate_text(TEXTS, max_dec_len=8) == want
    assert len(set("".join(want))) > 4  # not one repeated token
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["-c", CONFIG, "--port", str(port), "--device", "cpu", "--warmup-batches", "1",
            "--scheduler", scheduler]
    for o in _overrides(ckpt, tok_dir):
        args += ["-o", o]
    proc, lines, reader = _spawn("paddlefleetx_tpu_torch.tools.serve", args)
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, "".join(lines)[-3000:]
            assert time.time() < deadline, "server never healthy"
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.3)
        # each 200 also carries its sampled trace's id (PFX_TRACE_SAMPLE: 1)
        for text, completion in zip(TEXTS, want):
            body = _post(port, {"prompt": text, "max_tokens": 8})
            assert body.pop("trace_id") and body == {"completion": completion}
        body = _post(port, {"prompts": TEXTS[:2], "max_tokens": 8})
        assert body.pop("trace_id") and body == {"completions": want[:2]}
        frames = _post(port, {"prompt": TEXTS[0], "max_tokens": 8}, stream=True)
        tok = GPTTokenizer.from_pretrained(tok_dir)
        assert frames[-1][0] == "summary"
        tokens = [f for e, f in frames if e == "token"]
        assert tokens and all(f["text"] == tok.decode(f["tokens"]) for f in tokens)
        assert "".join(f["text"] for f in tokens) == want[0]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"prompt": ""})
        assert err.value.code == 400
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=10)
    assert "serving the params of" in "".join(lines)


def test_continuous_engine_treats_beam_as_the_jax_engine_does(trained):
    """The JAX continuous engine takes the server's GenerationConfig and
    argmaxes only greedy_search: a beam_search config samples.  The
    port's engine does the same (top_k=1 makes the draw the argmax, so
    the two sides agree token for token)."""
    ckpt, tok_dir = trained
    served = build_server(CONFIG, _overrides(ckpt, extra=[
        "Generation.decode_strategy=beam_search", "Generation.top_k=1"]), device="cpu")
    jserver = _jax_text_server(served, tok_dir)
    jserver.gen = jax_gen.GenerationConfig(**{**jserver.gen.__dict__,
                                              "decode_strategy": "beam_search", "top_k": 1})
    prompts = [[5, 17, 33, 2, 8], [40, 41, 42, 43], [3, 9, 27]]
    outs = []
    for eng in (JaxEngine(jserver, max_batch=4, block=8), PagedDecodeEngine(served, max_batch=4,
                                                                             block=8)):
        slots = [eng.admit(p, 6) for p in prompts]
        done = {}
        while len(done) < len(prompts):
            for slot in eng.step():
                done[slots.index(slot)] = list(eng.slots[slot].tokens)
                eng.release(slot)
        outs.append(done)
    assert outs[1] == outs[0] and served.gen.decode_strategy == "beam_search"
