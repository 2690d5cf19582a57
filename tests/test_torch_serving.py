"""PyTorch port: GenerationServer against the JAX greedy outputs, the
single-tenant RequestQueue (coalescing, 429, 503, drain), and one HTTP
round trip through ``python -m paddlefleetx_tpu_torch.tools.serve
--device cpu``, all on the CPU with the TINY serving config of
tests/test_kv_tier.py."""

import copy
import json
import os
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
import yaml

from paddlefleetx_tpu.models.gpt import generation as jax_gen
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.request_queue import (
    DeadlineExceeded,
    QueueClosed,
    QueueFull,
    RequestQueue,
)
from paddlefleetx_tpu_torch.core.serving import GenerationServer, plan_decode
from paddlefleetx_tpu_torch.models.gpt.bridge import params_to_jax
from paddlefleetx_tpu_torch.ops import decode_attention
from paddlefleetx_tpu_torch.tools.serve import clamp_max_tokens, plan_request
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_kv_tier.py TINY, minus the training-only sections
TINY = {
    "Global": {"seed": 7},
    "Engine": {"mix_precision": {"enable": False}},
    "Model": {
        "module": "GPTModule", "vocab_size": 96, "hidden_size": 32, "num_layers": 2,
        "num_attention_heads": 4, "max_position_embeddings": 128, "dtype": "float32",
    },
    "Generation": {"max_dec_len": 8, "decode_strategy": "greedy_search",
                   "pad_to_multiple": 8, "eos_token_id": 95, "pad_token_id": 0},
}


def _server(overrides=None, tokenizer=None):
    cfg = process_configs(AttrDict.from_nested(copy.deepcopy(TINY)))
    for key, val in (overrides or {}).items():
        cfg.Generation[key] = val
    module = GPTModule(cfg)
    model = module.init_model(cfg.Global.seed, "cpu")
    return GenerationServer(cfg, module, model, torch.device("cpu"), tokenizer=tokenizer)


@pytest.fixture(scope="module")
def server():
    return _server()


class _ByteTokenizer:
    """Ids 0-95 as one character each (the TINY vocab), for the text API."""

    def encode(self, text):
        return [ord(c) for c in text]

    def decode(self, ids):
        return "".join(chr(i) for i in ids)


def _jax_serve(server, prompts, max_dec_len, strategy="greedy_search"):
    """What the JAX GenerationServer returns for these prompts: pow2 batch
    padding, prompt buckets, 32-token decode buckets, trim, EOS cut."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k not in ("module", "dtype")}
    cfg = JaxGPTConfig(**model_kw, dtype=server.module.config.dtype)
    params = jax.tree.map(jnp.asarray, params_to_jax(server.model))
    target = 1
    while target < len(prompts):
        target *= 2
    batch = list(prompts) + [prompts[-1]] * (target - len(prompts))
    ids, lens = jax_gen.pad_prompts(batch, 0, multiple=server.bucket)
    if max_dec_len is None:
        trim = run = server.gen.max_dec_len
    else:
        trim, run = plan_decode(ids.shape[1], max_dec_len, context=128)
    gen = jax_gen.GenerationConfig(max_dec_len=run, decode_strategy=strategy,
                                   eos_token_id=95, pad_token_id=0)
    out = np.asarray(jax_gen.generate(params, ids, cfg, gen, prompt_lens=lens))
    rows = []
    for row in out[:len(prompts)].tolist():
        row = row[:trim]
        rows.append(row[: row.index(95)] if 95 in row else row)
    return rows


@pytest.mark.parametrize("prompts,max_dec_len", [
    ([[1, 2, 3]], None),
    ([[4, 5, 6, 7, 8, 9, 10, 11, 12], [9, 10], [30, 31, 32]], 5),
])
def test_generate_ids_matches_jax_greedy(server, prompts, max_dec_len):
    got = server.generate_ids(prompts, max_dec_len=max_dec_len)
    assert got == _jax_serve(server, prompts, max_dec_len)


def test_cache_pool_reuse_is_stable_and_lru_bounded():
    srv = _server({"cache_pool_size": 2})
    a = srv.generate_ids([[4, 5, 6, 7, 8]])
    assert srv.generate_ids([[4, 5, 6, 7, 8]]) == a  # reused cache, same tokens
    srv.generate_ids([[1] * 9])
    srv.generate_ids([[1, 2]], max_dec_len=40)
    assert len(srv._cache_pool) == 2
    assert srv.stats["requests"] == 4 and srv.stats["tokens_out"] > 0


def test_int8_kv_server_runs():
    srv = _server({"speculative": {"kv_dtype": "int8"}})
    assert srv.kv_dtype == "int8"
    out = srv.generate_ids([[3, 4, 5], [6, 7]], max_dec_len=4)
    assert len(out) == 2 and all(len(r) <= 4 for r in out)


def test_warmup_validates_buckets(server):
    per = server.warmup([3], batch_sizes=[1, 2])
    assert set(per) == {"3", "3x2"}
    with pytest.raises(ValueError):
        server.warmup([200])


def test_unported_features_fail_loudly():
    # speculative decoding is ported: the section parses and is served
    spec = _server({"speculative": {"draft_k": 4}})
    assert spec.spec.draft_k == 4 and spec.spec.drafter == "ngram"
    assert spec.generate_ids([[1, 2, 3]], max_dec_len=4) == _server().generate_ids(
        [[1, 2, 3]], max_dec_len=4)
    assert spec.stats["spec_proposed"] > 0
    with pytest.raises(ValueError):  # an unknown drafter stays loud
        _server({"speculative": {"draft_k": 4, "drafter": "medusa"}})
    # beam search is ported: the coalescing server decodes with it, beam for
    # beam the JAX server's answer (no cache pool, no speculation)
    beam = _server({"decode_strategy": "beam_search", "speculative": {"draft_k": 2}})
    prompts = [[4, 5, 6, 7, 8, 9, 10, 11, 12], [9, 10], [30, 31, 32]]
    assert beam.gen.num_beams == 4 and beam.spec.draft_k == 2
    got = beam.generate_ids(prompts, max_dec_len=5)
    assert got == _jax_serve(beam, prompts, 5, strategy="beam_search")
    assert not beam._cache_pool and beam.stats["spec_proposed"] == 0
    # the tokenizer is ported: a server given one answers text prompts
    # (build_server loads it from Generation.tokenizer_dir)
    with pytest.raises(ValueError, match="no tokenizer configured"):
        _server().generate_text(["hi"])
    tok = _ByteTokenizer()
    texts = _server(tokenizer=tok).generate_text(["\x04\x05\x06", "\x09\x0a"],
                                                       max_dec_len=5)
    want = _server().generate_ids([[4, 5, 6], [9, 10]], max_dec_len=5)
    assert texts == [tok.decode(r) for r in want]
    # float16 is served (K7-K9's float16 routes on the card): a float16
    # server answers the JAX server's tokens on the same float16 weights
    raw = copy.deepcopy(TINY)
    raw["Model"]["dtype"] = "float16"
    cfg = process_configs(AttrDict.from_nested(raw))
    module = GPTModule(cfg)
    f16 = GenerationServer(cfg, module, module.init_model(7, "cpu"), torch.device("cpu"))
    assert f16.model.embeddings.word.dtype == torch.float16
    assert f16.generate_ids(prompts, max_dec_len=5) == _jax_serve(f16, prompts, 5)


def test_plan_request_and_clamp():
    assert clamp_max_tokens(None, 8, 0) == 8
    assert clamp_max_tokens(500, 8, 16) == 16
    assert clamp_max_tokens(0, 8, 0) == 1
    trim, key = plan_request([[1] * 9, [2]], 40, bucket=8, context=128)
    assert (trim, key) == (40, (16, 64))
    with pytest.raises(ValueError):
        plan_request([[1] * 130], 4, bucket=8, context=128)


# ---------------------------------------------------------------------------
# RequestQueue
# ---------------------------------------------------------------------------


def test_queue_coalesces_same_key_and_splits_rows():
    calls = []
    gate = threading.Event()

    def runner(prompts, max_new):
        gate.wait(5)
        calls.append((list(prompts), max_new))
        return [[p[0]] * max_new for p in prompts]

    q = RequestQueue(runner, max_depth=8, max_coalesce=4)
    f0 = q.submit([[9]], 2, coalesce_key="k0")
    f1 = q.submit([[1]], 3, coalesce_key="k")
    f2 = q.submit([[2], [3]], 5, coalesce_key="k")
    f3 = q.submit([[4]], 1, coalesce_key="other")
    q.start()
    gate.set()
    assert f1.result(5) == [[1, 1, 1]]
    assert f2.result(5) == [[2] * 5, [3] * 5]
    assert f0.result(5) == [[9, 9]] and f3.result(5) == [[4]]
    assert ([[1], [2], [3]], 5) in calls and len(calls) == 3
    assert q.stats["coalesced_batches"] == 1 and q.stats["coalesced_requests"] == 2
    q.shutdown(timeout=5)


def test_queue_full_is_429_and_expired_is_503():
    q = RequestQueue(lambda p, n: [[0]] * len(p), max_depth=2)
    q.submit([[1]], 1, deadline_s=0.01)
    q.submit([[2]], 1)
    with pytest.raises(QueueFull):
        q.submit([[3]], 1)
    time.sleep(0.05)
    expired = q._entries[0].future
    q.start()
    with pytest.raises(DeadlineExceeded):
        expired.result(5)
    assert q.stats["shed_deadline"] == 1 and q.stats["rejected_full"] == 1
    q.shutdown(timeout=5)


def test_queue_drain_answers_admitted_then_rejects():
    q = RequestQueue(lambda p, n: [[7]] * len(p))
    futs = [q.submit([[i]], 1) for i in range(3)]
    q.start()
    q.close()
    assert q.join(timeout=5)
    assert [f.result(1) for f in futs] == [[[7]]] * 3
    with pytest.raises(QueueClosed):
        q.submit([[1]], 1)


def test_queue_runner_error_fans_out():
    def runner(prompts, max_new):
        raise RuntimeError("boom")

    q = RequestQueue(runner).start()
    fut = q.submit([[1]], 1)
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(5)
    assert q.stats["gen_errors"] == 1
    q.shutdown(timeout=5)


# ---------------------------------------------------------------------------
# HTTP round trip
# ---------------------------------------------------------------------------


def _post(port, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
        return json.load(r)


def test_http_round_trip_cpu(tmp_path, server):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(TINY))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", str(cfg_path),
         "--port", str(port), "--device", "cpu", "--warmup-batches", "1"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 120
        health = None
        while time.time() < deadline and health is None:
            try:
                health = _healthz(port)
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"server died: {proc.stdout.read()[-2000:]}")
                time.sleep(0.5)
        assert health and health["ok"] and health["kernels"]["plain"] == 0, health

        out = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 4})
        assert out["completion_ids"] == server.generate_ids([[1, 2, 3]], max_dec_len=4)[0]
        out = _post(port, {"prompts_ids": [[1, 2], [3, 4, 5]], "max_tokens": 4})
        assert len(out["completions_ids"]) == 2
        for body in ({"prompt_ids": []}, {"prompt": "text"}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, body)
            assert err.value.code == 400
        health = _healthz(port)
        assert health["kernels"]["plain"] > 0 and health["kernels"]["flash_decode"] == 0
        assert health["serving"]["requests"] == 3  # the warmup request and two posts
        assert decode_attention.COUNTS["flash_decode"] == 0  # nothing launched here

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "drained cleanly" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
