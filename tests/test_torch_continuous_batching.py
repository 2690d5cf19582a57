"""PyTorch port: the paged KV bookkeeping, the continuous-batching engine
and scheduler, and ``--scheduler continuous`` of the serve CLI, against
the JAX package on the CPU.

The model is the TINY serving config of tests/test_kv_tier.py (vocab 96,
2 layers, hidden 32, 4 heads, float32, dropout off); weights come from
the JAX initializer, perturbed so biases and LayerNorms are not at their
ones/zeros, and cross to the port through the bridge.  Tolerances: block
ids and greedy tokens identical; first-step logits 1e-4 (float32, the
two sides sum in different orders).
"""

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

from paddlefleetx_tpu.core import paged_cache as jax_pc
from paddlefleetx_tpu.core.continuous_batching import PagedDecodeEngine as JaxEngine
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core import paged_cache as pt_pc
from paddlefleetx_tpu_torch.core.continuous_batching import (
    ArenaReset,
    ContinuousScheduler,
    PagedDecodeEngine,
)
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.request_queue import DeadlineExceeded, QueueClosed, QueueFull
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.ops import decode_attention
from paddlefleetx_tpu_torch.tools.serve import build_scheduler
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_kv_tier.py TINY, dropout off
TINY = {
    "Global": {"global_batch_size": 8, "seed": 7},
    "Engine": {"mix_precision": {"enable": False}, "save_load": {"save_steps": 0}},
    "Model": {
        "module": "GPTModule", "vocab_size": 96, "hidden_size": 32, "num_layers": 2,
        "num_attention_heads": 4, "max_position_embeddings": 128, "dtype": "float32",
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    },
    "Distributed": {},
    "Optimizer": {"name": "FusedAdamW", "lr": {"name": "Constant", "learning_rate": 1e-3}},
    "Generation": {"max_dec_len": 8, "decode_strategy": "greedy_search",
                   "pad_to_multiple": 8, "eos_token_id": 95, "pad_token_id": 0},
}
PORT_SECTIONS = ("Global", "Engine", "Model", "Generation")
PROMPTS = [[5, 17, 33, 2, 8], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50],
           [3, 9, 27], [70, 71, 72, 73, 74, 75, 76, 77, 78]]
MAX_NEW = 6


def _port_cfg():
    return process_configs(AttrDict.from_nested(
        {k: v for k, v in copy.deepcopy(TINY).items() if k in PORT_SECTIONS}
    ))


def _server_with(generation):
    cfg = _port_cfg()
    cfg.Generation.update(generation)
    module = GPTModule(cfg)
    return GenerationServer(cfg, module, module.init_model(cfg.Global.seed, "cpu"),
                            torch.device("cpu"))


@pytest.fixture(scope="module")
def servers():
    """(JAX GenerationServer, port GenerationServer) on the same weights."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k != "module"}
    jparams = jax_model.init(JaxGPTConfig(**model_kw), jax.random.key(0))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), jparams
    )
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(TINY)),
                              num_devices=jax.device_count())
    jserver = JaxServer(cfg, init_dist_env(cfg), build_module(cfg),
                        params=jax.tree.map(jnp.asarray, tree))
    pcfg = _port_cfg()
    module = GPTModule(pcfg)
    model = params_from_jax(module.config, tree)
    return jserver, GenerationServer(pcfg, module, model, torch.device("cpu"))


@pytest.fixture(scope="module")
def sequential(servers):
    """Each prompt served alone on the port's coalescing path."""
    return [servers[1].generate_ids([p], max_dec_len=MAX_NEW)[0] for p in PROMPTS]


# ---------------------------------------------------------------------------
# paged_cache: the port's copy against the JAX module
# ---------------------------------------------------------------------------


def _replay(mod):
    """One admit/release sequence through a manager; returns every table
    and the stats along the way."""
    m = mod.PagedCacheManager(10, block=8)
    out = [m.admit(1, 17), m.admit(2, 8), m.admit(3, 30)]
    m.release(2)
    out.append(m.admit(4, 12))  # reuses block 4 first, then the lowest free
    m.release(1)
    out.append(m.admit(5, 9))
    try:
        m.admit(6, 80)
    except mod.BlockPoolExhausted as e:
        out.append(str(e))
    stats = m.stats()
    out.append({k: stats[k] for k in ("kv_blocks_used", "kv_blocks_free", "live_sequences",
                                      "fragmentation")})
    return out


def test_manager_gives_the_jax_block_ids():
    assert _replay(pt_pc) == _replay(jax_pc)


def test_allocator_is_loud():
    a = pt_pc.BlockAllocator(4)
    blocks = a.alloc(2)
    assert blocks == [1, 2] and a.used_count() == 2
    for bad in ([0], [9], [blocks[0], blocks[0]]):
        with pytest.raises(ValueError):
            a.free(bad)
    a.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        a.free([1])
    with pytest.raises(pt_pc.BlockPoolExhausted):
        a.alloc(4)
    with pytest.raises(ValueError):
        pt_pc.BlockAllocator(1)


def test_kv_block_size_is_loud(monkeypatch):
    assert pt_pc.kv_block_size() == 16
    monkeypatch.setenv("PFX_KV_BLOCK", "24")
    assert pt_pc.kv_block_size() == 24 == jax_pc.kv_block_size()
    for bad in ("12", "x"):
        monkeypatch.setenv("PFX_KV_BLOCK", bad)
        with pytest.raises(ValueError):
            pt_pc.kv_block_size()
    assert pt_pc.blocks_for(17, 8) == 3 == jax_pc.blocks_for(17, 8)


# ---------------------------------------------------------------------------
# PagedDecodeEngine against the JAX engine
# ---------------------------------------------------------------------------


def _drive(eng):
    """Rows 0/1 admitted together, row 2 mid-decode, row 3 into the blocks
    of the first row to finish (the pool holds three rows, not four).
    Returns (tokens per request, tables per request, first-step logits)."""
    slots = {0: eng.admit(PROMPTS[0], MAX_NEW), 1: eng.admit(PROMPTS[1], MAX_NEW)}
    logits = [np.asarray(eng._logits)[[slots[0], slots[1]]]]
    eng.step()
    logits.append(np.asarray(eng._logits)[[slots[0], slots[1]]])
    eng.step()
    slots[2] = eng.admit(PROMPTS[2], MAX_NEW)
    tables = {k: list(eng.slots[s].table) for k, s in slots.items()}
    assert not eng.can_admit(len(PROMPTS[3]), MAX_NEW)
    done = {}
    for _ in range(4 * MAX_NEW):
        for slot in eng.step():
            rid = next(k for k, s in slots.items() if s == slot and k not in done)
            done[rid] = list(eng.slots[slot].tokens)
            eng.release(slot)
        if 3 not in slots and eng.can_admit(len(PROMPTS[3]), MAX_NEW):
            slots[3] = eng.admit(PROMPTS[3], MAX_NEW)
            tables[3] = list(eng.slots[slots[3]].table)
        if len(done) == len(PROMPTS):
            break
    return done, tables, logits


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_matches_jax_engine(servers, sequential, kv_dtype):
    """Greedy tokens, block tables (incl. reuse after a release) and
    first-step logits of the port's engine equal the JAX engine's, with a
    row admitted mid-decode; the float32 tokens also equal the sequential
    coalescing path."""
    jserver, pserver = servers
    kw = dict(max_batch=4, block=8, num_blocks=8, kv_dtype=kv_dtype)
    want_tokens, want_tables, want_logits = _drive(JaxEngine(jserver, **kw))
    before = decode_attention.COUNTS["paged_plain"]
    eng = PagedDecodeEngine(pserver, **kw)
    got_tokens, got_tables, got_logits = _drive(eng)
    assert got_tables == want_tables
    assert set(got_tables[3]) <= set(got_tables[0]) | set(got_tables[1]) | set(got_tables[2])
    assert got_tokens == want_tokens
    for got, want in zip(got_logits, want_logits):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if kv_dtype == "bf16":  # the model dtype: float32 here
        assert [got_tokens[i] for i in range(len(PROMPTS))] == sequential
    assert decode_attention.COUNTS["paged_plain"] > before
    assert eng.stats["mid_decode_admits"] >= 2 and eng.stats["prefills"] == 4
    assert eng.cache.stats()["kv_blocks_used"] == 0


def test_engine_refuses_what_is_not_ported(servers):
    jserver, pserver = servers
    # the prefix cache, its spill tier and chunked prefill are ported: the
    # engine and the manager build with them, and refuse what the JAX
    # engine refuses with the same ValueError
    eng = PagedDecodeEngine(pserver, prefix_cache_blocks=8, prefix_spill_bytes=1,
                            prefill_chunk=16)
    assert (eng.cache.prefix.budget, eng.cache.spill.budget, eng.prefill_chunk) == (8, 1, 16)
    assert eng.cache.prefix.spill_hook == eng._spill_block
    assert pt_pc.PagedCacheManager(8, prefix_blocks=4).prefix.enabled
    for kw in ({"prefix_spill_bytes": 1}, {"prefill_chunk": 24}, {"prefix_cache_blocks": -1}):
        with pytest.raises(ValueError) as want:
            JaxEngine(jserver, **kw)
        with pytest.raises(ValueError) as got:
            PagedDecodeEngine(pserver, **kw)
        assert str(got.value) == str(want.value)
    # preemption is ported: preempt_row frees a decode-active row and
    # returns its committed tokens, as the JAX engine does, and refuses an
    # empty slot and a row mid-chunked-prefill with the JAX errors
    preempted = []
    for make in (JaxEngine, PagedDecodeEngine):
        pe = make(jserver if make is JaxEngine else pserver, max_batch=2, block=8,
                  prefill_chunk=8)
        s0 = pe.admit(PROMPTS[1], MAX_NEW)  # 11 tokens: one chunk runs, one waits
        errors = []
        for slot in (s0, 1):
            with pytest.raises(ValueError) as err:
                pe.preempt_row(slot)
            errors.append(str(err.value))
        while not pe.slots[s0].prefill_done or len(pe.slots[s0].tokens) < 2:
            pe.step()
        got = pe.preempt_row(s0)
        preempted.append((got, errors, all(r is None for r in pe.slots),
                          pe.cache.stats()["kv_blocks_used"]))
    assert preempted[1] == preempted[0]
    assert len(preempted[1][0]) >= 2 and preempted[1][2:] == (True, 0)
    # the KV handoff stays unported
    for call in (lambda: eng.prefill_export([1, 2], 4),
                 lambda: eng.adopt({}, {}), lambda: eng.export_hot_prefixes(),
                 lambda: eng.adopt_prefixes({}, {})):
        with pytest.raises(NotImplementedError):
            call()
    # speculation is ported: Generation.speculative.draft_k reaches the engine
    # (spec="auto"), which reserves draft_k slack slots a row; a spec that is
    # not a SpecConfig is refused
    spec_server = _server_with({"speculative": {"draft_k": 2}})
    eng = PagedDecodeEngine(spec_server, max_batch=2, block=8)
    assert eng.spec is spec_server.spec and eng.spec.draft_k == 2
    assert eng.row_capacity_tokens(5, 6) == PagedDecodeEngine(
        pserver, max_batch=2, block=8).row_capacity_tokens(5, 6) + 2
    assert PagedDecodeEngine(spec_server, max_batch=2, block=8, spec=None).spec is None
    with pytest.raises(ValueError, match="SpecConfig"):
        PagedDecodeEngine(pserver, spec=object())
    sched = build_scheduler(pserver, "continuous", queue_depth=4, max_coalesce=4)
    assert isinstance(sched, ContinuousScheduler) and sched.engine.capacity == 8
    with pytest.raises(ValueError):
        build_scheduler(pserver, "beam", queue_depth=4, max_coalesce=4)


def test_engine_exhaustion_and_trace_shapes(servers):
    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=2, block=16, num_blocks=3)
    eng.admit([1, 2], MAX_NEW)
    eng.admit([3, 4], MAX_NEW)
    assert not eng.can_admit(2, MAX_NEW)
    with pytest.raises((pt_pc.BlockPoolExhausted, RuntimeError)):
        eng.admit([5, 6], MAX_NEW)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.validate_request(100, 100)
    eng.step()
    eng.step()
    # one prompt bucket and one table width: one prefill and one step shape
    assert eng.stats["traces"] == 2 and eng.table_width_bucket() == 1


def test_engine_step_failure_resets_the_arena(servers, monkeypatch):
    from paddlefleetx_tpu_torch.core import continuous_batching as cb

    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=2, block=8)
    s0 = eng.admit(PROMPTS[0], MAX_NEW)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(cb, "decode_step", boom)
    with pytest.raises(ArenaReset) as err:
        eng.step()
    assert [r.prompt_len for r in err.value.dead_rows] == [len(PROMPTS[0])]
    assert eng.slots == [None, None] and eng.cache.stats()["kv_blocks_used"] == 0
    monkeypatch.undo()
    s0 = eng.admit(PROMPTS[0], MAX_NEW)
    while eng.active.any():
        eng.step()
    assert eng.slots[s0].tokens == pserver.generate_ids([PROMPTS[0]], max_dec_len=MAX_NEW)[0]


def test_engine_refuses_a_table_entry_outside_the_arena(servers):
    """The paged kernel trusts its tables, so the engine checks them on
    the host before each upload: a corrupt entry fails the step loudly
    (and resets the arena) instead of reading outside the pools."""
    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=2, block=8)
    s0 = eng.admit(PROMPTS[0], MAX_NEW)
    eng.slots[s0].table[0] = eng.cache.allocator.num_blocks
    with pytest.raises(ArenaReset) as err:
        eng.step()
    assert "outside" in str(err.value.__cause__)
    assert eng.slots == [None, None] and eng.cache.stats()["kv_blocks_used"] == 0


# ---------------------------------------------------------------------------
# ContinuousScheduler
# ---------------------------------------------------------------------------


def test_schedulers_share_the_http_surface(servers):
    """Both schedulers name their kind and report their own serving
    stats, so the HTTP layer needs no type test."""
    _, pserver = servers
    coalesce = build_scheduler(pserver, "coalesce", queue_depth=4, max_coalesce=4)
    cont = build_scheduler(pserver, "continuous", queue_depth=4, max_coalesce=4,
                           cb_batch=2)
    assert (coalesce.kind, cont.kind) == ("coalesce", "continuous")
    assert coalesce.serving_stats() == dict(pserver.stats)
    served = cont.serving_stats()
    assert served["steps"] == 0 and served["active_rows"] == 0
    assert served["kv_blocks_used"] == 0 and "traces" in served
    assert not any(k.startswith("coalesced") for k in cont.stats_snapshot())


def test_scheduler_futures_resolve_with_sequential_tokens(servers, sequential):
    _, pserver = servers
    sched = ContinuousScheduler(PagedDecodeEngine(pserver, max_batch=2, block=8),
                                max_depth=8)
    futs = [sched.submit([p], MAX_NEW, deadline_s=120) for p in PROMPTS]
    multi = sched.submit(PROMPTS[:3], MAX_NEW, deadline_s=120)  # more rows than slots
    sched.start()
    assert [f.result(timeout=120)[0] for f in futs] == sequential
    assert multi.result(timeout=120) == sequential[:3]
    assert sched.stats["completed"] == 5 and sched.stats["prefill_admits"] == 7
    assert sched.stats["gen_errors"] == 0 and sched.depth() == 0
    assert sched.shutdown(timeout=30)
    with pytest.raises(QueueClosed):
        sched.submit([[1]], 2)


def test_scheduler_admission_bounds_deadlines_and_eviction(servers):
    """Driven one iteration at a time (no thread): bounded submit, a
    waiting entry shed at its deadline, an admitted row evicted
    mid-decode at its deadline with its blocks freed in the same
    iteration that admits the next entry, and try_remove."""
    _, pserver = servers
    eng = PagedDecodeEngine(pserver, max_batch=1, block=8)
    sched = ContinuousScheduler(eng, max_depth=2)
    with pytest.raises(ValueError):
        sched.submit([[1] * 200], 4)  # can never fit the context
    long_row = sched.submit([[1, 2, 3]], 100, deadline_s=60)
    queued = sched.submit([[4, 5]], 4, deadline_s=60)
    with pytest.raises(QueueFull):
        sched.submit([[6]], 4)
    sched._iterate()  # admits long_row (one slot) and steps it
    assert eng.slots[0].entry.future is long_row and sched.depth() == 1
    eng.slots[0].entry.deadline = time.monotonic() - 1.0
    sched._iterate()  # evicts long_row mid-decode, admits queued into its blocks
    with pytest.raises(DeadlineExceeded):
        long_row.result(timeout=1)
    assert sched.stats["evictions"] == 1 and eng.slots[0].entry.future is queued
    expired = sched.submit([[7]], 4, deadline_s=1e-4)
    waiting = sched.submit([[8]], 4, deadline_s=60)
    time.sleep(0.01)
    sched._iterate()  # the expired waiting entry is shed before admission
    with pytest.raises(DeadlineExceeded):
        expired.result(timeout=1)
    assert sched.try_remove(waiting)
    with pytest.raises(DeadlineExceeded):
        waiting.result(timeout=1)
    while not queued.done():
        sched._iterate()
    assert len(queued.result(timeout=1)[0]) <= 4
    assert sched.stats["shed_deadline"] == 3  # eviction, expired, try_remove
    assert eng.cache.stats()["kv_blocks_used"] == 0


# ---------------------------------------------------------------------------
# HTTP round trip: --scheduler continuous --device cpu
# ---------------------------------------------------------------------------


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
        return json.load(r)


def test_http_round_trip_continuous_cpu(tmp_path):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({k: TINY[k] for k in PORT_SECTIONS}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", str(cfg_path),
         "--port", str(port), "--device", "cpu", "--scheduler", "continuous",
         "--cb-batch", "2"],
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
                time.sleep(0.3)
        assert health and health["ok"], health
        assert all(v == 0 for v in health["kernels"].values()), health["kernels"]

        # the server's own weights come from Global.seed, not the bridge:
        # compare with an in-process port server built the same way
        ref = _server_with({})
        results = {}

        def post(i):
            results[i] = _post(port, {"prompt_ids": PROMPTS[i], "max_tokens": MAX_NEW})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(PROMPTS))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        for i, p in enumerate(PROMPTS):
            want = ref.generate_ids([p], max_dec_len=MAX_NEW)[0]
            assert results[i]["completion_ids"] == want
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {"prompt_ids": [1] * 200, "max_tokens": 4})
        assert err.value.code == 400
        health = _healthz(port)
        kernels = health["kernels"]
        assert kernels["paged_plain"] > 0 and kernels["paged_decode"] == 0, kernels
        assert kernels["plain"] > 0  # the prefill runs the contiguous forward
        assert health["queue"]["completed"] == len(PROMPTS)
        assert health["serving"]["prefills"] >= len(PROMPTS)
        assert health["serving"]["kv_blocks_used"] == 0

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        out = proc.stdout.read()
        assert "scheduler continuous" in out and "drained cleanly" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.parametrize("mode", ["step", "traffic"])
def test_profile_engine_runs_on_cpu(tmp_path, mode):
    """tools/profile_engine at a tiny width on the CPU: one result per KV
    dtype, with step and admission timings (and, in step mode, operator
    tables)."""
    from paddlefleetx_tpu_torch.tools import profile_engine

    out = tmp_path / "prof.json"
    tiny = ["Model.num_layers=2", "Model.hidden_size=32", "Model.num_attention_heads=4",
            "Model.vocab_size=96", "Model.max_position_embeddings=128",
            "Model.dtype=float32"]
    argv = ["-c", os.path.join(REPO, "configs/gpt/pretrain_gpt_345M_single.yaml"),
            "--device", "cpu", "--batch", "2", "--steps", "2", "--mode", mode,
            "--out", str(out)]
    for o in tiny:
        argv += ["-o", o]
    assert profile_engine.main(argv) == 0
    res = json.loads(out.read_text())
    assert [r["kv_dtype"] for r in res] == ["bf16", "int8"]
    for r in res:
        if mode == "traffic":  # 32 new tokens per row, the second admitted mid-decode
            assert len(r["admit_ms"]) == 2 and len(r["step_ms"]) >= 32
            assert r["mid_decode_admits"] == 1 and r["wall_s"] > 0
            continue
        assert len(r["step_ms"]) == 2 and len(r["admit_ms"]) == 1
        assert r["step"]["host_us_per_step"] > 0 and len(r["step"]["host_ops"]) > 3
        assert r["step"]["device_us_per_step"] == 0  # no card: host times only
