"""PyTorch port: the continuous scheduler's dispatch path against the JAX
package on the CPU.

The port's ``ContinuousScheduler`` with dispatch-ahead on is driven one
``_iterate()`` at a time beside the JAX scheduler with dispatch-ahead on,
on the same seeded traffic and the same script of arrivals, deadline
expiries and a ``preempt_storm`` fire that lands while a step is in
flight: a pre-expired shed, mid-decode admissions, speculation on a
repetitive prompt, and chunked prefill with prefix hits, each at
scheduling quantum 1 and 3.  Both give the same greedy tokens, the same
admission, completion, eviction and shed counts, the same engine step
and host-gap step counts and the same preemption victims; the port with
dispatch-ahead off gives the same tokens and counts.  Also held: the
``cb_commit_crash`` drill of tests/test_decode_overlap.py against the
JAX engine, warmup forced synchronous, contiguous stream offsets with
overlap on, the two environment knobs' parsing, and the static-buffer
decode and verify steps bit for bit against their functional forms.

The model is the TINY serving config of tests/test_kv_tier.py (float32,
dropout off) with JAX-initialised weights, perturbed, crossing to the
port through the bridge; KV blocks of 8 tokens.
"""

import copy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.core import continuous_batching as jax_cb
from paddlefleetx_tpu.core import request_queue as jax_rq
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops import speculative as jax_spec
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils import resilience as jax_res
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core import continuous_batching as pt_cb
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.request_queue import DeadlineExceeded
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt import generation as pt_gen
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.ops import speculative as pt_spec
from paddlefleetx_tpu_torch.utils import resilience as pt_res
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

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
BLK = 8
PROMPTS = [[1, 2, 3], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [9, 10],
           [11, 12, 13, 14]]
# the n-gram self-draft's best case: speculation accepts drafts
REP = [5, 6] * 8
# prompts sharing a two-block prefix (hits once the first publishes)
PFX = list(range(20, 36))
SHARED = [PFX + [60, 61, 62], PFX + [70, 71], PFX + [80, 81, 82, 83]]
MAX_NEW = 8


@pytest.fixture(scope="module")
def servers():
    """(JAX GenerationServer, port GenerationServer) on the same weights."""
    model_kw = {k: v for k, v in TINY["Model"].items() if k != "module"}
    jparams = jax_model.init(JaxGPTConfig(**model_kw), jax.random.key(0))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), jparams)
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(TINY)),
                              num_devices=jax.device_count())
    jserver = JaxServer(cfg, init_dist_env(cfg), build_module(cfg),
                        params=jax.tree.map(jnp.asarray, tree))
    pcfg = process_configs(AttrDict.from_nested(
        {k: v for k, v in copy.deepcopy(TINY).items() if k in PORT_SECTIONS}))
    module = GPTModule(pcfg)
    return jserver, GenerationServer(pcfg, module, params_from_jax(module.config, tree),
                                     torch.device("cpu"))


# the traffic scenarios: engine options and a script of actions keyed by
# the iteration they run before ("submit", name, prompt, max_new,
# deadline_s) / ("expire", name): the named request's deadline passes
SCENARIOS = {
    "mixed": ({}, {
        0: [("submit", "doomed", PROMPTS[0], MAX_NEW, 1e-4), ("submit", "a", PROMPTS[0],
                                                              MAX_NEW, 120),
            ("submit", "b", PROMPTS[1], 16, 120)],
        2: [("submit", "c", PROMPTS[2], MAX_NEW, 120)],
        5: [("submit", "d", PROMPTS[3], MAX_NEW, 120)],
        7: [("expire", "b")],
    }),
    "speculative": ({"draft_k": 3}, {
        0: [("submit", "doomed", PROMPTS[0], MAX_NEW, 1e-4), ("submit", "rep", REP, 12, 120),
            ("submit", "a", PROMPTS[1], 16, 120)],
        3: [("submit", "b", PROMPTS[1], MAX_NEW, 120)],
        4: [("submit", "c", PROMPTS[3], MAX_NEW, 120)],
    }),
    "chunked_prefix": ({"prefill_chunk": 8, "prefix_cache_blocks": 16}, {
        0: [("submit", "s0", SHARED[0], MAX_NEW, 120), ("submit", "a", PROMPTS[2], 12, 120)],
        12: [("submit", "s1", SHARED[1], MAX_NEW, 120)],
        14: [("submit", "s2", SHARED[2], MAX_NEW, 120), ("submit", "b", PROMPTS[1], MAX_NEW,
                                                          120)],
    }),
}
STORM = "preempt_storm:5"


def _engines(servers, opts):
    """A JAX engine and two port engines of the same geometry (the JAX
    batch pads to the data-parallel world: the port takes its capacity)."""
    jserver, pserver = servers
    opts = dict(opts)
    k = opts.pop("draft_k", 0)
    jeng = jax_cb.PagedDecodeEngine(
        jserver, block=BLK, spec=jax_spec.SpecConfig(draft_k=k) if k else None, **opts)
    ports = [pt_cb.PagedDecodeEngine(pserver, block=BLK, max_batch=jeng.capacity,
                                     spec=pt_spec.SpecConfig(draft_k=k) if k else None, **opts)
             for _ in range(2)]
    return jeng, ports


def _drive(mod, res, eng, script, quantum, ahead, monkeypatch):
    """Run ``script`` through a fresh scheduler of ``mod`` one iteration at
    a time under the storm fault; returns what the comparison reads."""
    res.reset_fault_state()
    monkeypatch.setenv("PFX_FAULT", STORM)
    sched = mod.ContinuousScheduler(eng, max_depth=16, dispatch_ahead=ahead, quantum=quantum,
                                    preempt_min_tokens=2)
    victims = []
    inner = sched._preempt_slot
    sched._preempt_slot = lambda slot: (victims.append(slot), inner(slot))[1]
    futs = {}
    try:
        for it in range(400):
            for act in script.get(it, ()):
                if act[0] == "submit":
                    futs[act[1]] = sched.submit([act[2]], act[3], deadline_s=act[4])
                    if act[4] < 1:
                        time.sleep(0.01)  # expired before the next scan
                else:
                    for r in eng.slots:
                        if r is not None and r.entry is not None and \
                                r.entry.future is futs[act[1]]:
                            r.entry.deadline = time.monotonic() - 1.0
            if it > max(script) and all(f.done() for f in futs.values()):
                break
            sched._iterate()
        else:
            raise AssertionError("scheduler never finished")
    finally:
        monkeypatch.delenv("PFX_FAULT")
        res.reset_fault_state()
    answers = {}
    for name, f in futs.items():
        try:
            answers[name] = f.result(0)[0]
        except (DeadlineExceeded, jax_rq.DeadlineExceeded):
            answers[name] = "DeadlineExceeded"
    counts = {k: int(sched.stats[k]) for k in ("prefill_admits", "completed", "evictions",
                                               "shed_deadline", "preemptions")}
    return answers, counts, victims, eng


@pytest.mark.parametrize("quantum", [1, 3])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dispatch_ahead_matches_jax(servers, monkeypatch, scenario, quantum):
    opts, script = SCENARIOS[scenario]
    jeng, (pahead, psync) = _engines(servers, opts)
    want = _drive(jax_cb, jax_res, jeng, script, quantum, True, monkeypatch)
    got = _drive(pt_cb, pt_res, pahead, script, quantum, True, monkeypatch)
    sync = _drive(pt_cb, pt_res, psync, script, quantum, False, monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    # the port commits the row-less step in flight when its batch empties;
    # the JAX engine at its next flush: compare the engines flushed
    assert not pahead.has_inflight
    jeng.flush()
    for key in ("steps", "gap_steps", "spec_proposed", "spec_accepted", "prefill_chunks",
                "prefill_tokens"):
        assert pahead.stats[key] == jeng.stats[key], key
    assert pahead.cache.prefix.stats == jeng.cache.prefix.stats
    # the synchronous port: the same answers and counts, one commit per dispatch
    assert sync[0] == got[0] and sync[1] == got[1] and sync[2] == got[2]
    assert psync.stats["mid_decode_admits"] == pahead.stats["mid_decode_admits"] >= 1
    # what each scenario must have exercised
    assert got[1]["preemptions"] == len(got[2]) == 1
    if scenario != "chunked_prefix":
        assert got[0]["doomed"] == "DeadlineExceeded" and got[1]["shed_deadline"] >= 1
    if scenario == "mixed":
        assert got[0]["b"] == "DeadlineExceeded" and got[1]["evictions"] == 1
    if scenario == "speculative":
        assert pahead.stats["spec_accepted"] > 0
    if scenario == "chunked_prefix":
        assert pahead.cache.prefix.stats["hits"] >= 2 and pahead.stats["prefill_chunks"] > 3
    # the chained dispatches pay no host gap: fewer gap steps than dispatches
    if scenario == "mixed":
        assert pahead.stats["gap_steps"] < psync.stats["gap_steps"]


def _crash_drill(mod, res, eng, monkeypatch):
    """tests/test_decode_overlap.py's drill on ``eng``: returns (the dead
    seq_ids, the live seq_ids before, has_inflight after, the rebuilt
    arena's tokens)."""
    eng.dispatch_ahead = True
    s0 = eng.admit(PROMPTS[0], 6)
    s1 = eng.admit(PROMPTS[1], 6)
    eng.step()  # dispatches step 1 and leaves it in flight
    assert eng.has_inflight
    live = {eng.slots[s].seq_id for s in (s0, s1)}
    res.reset_fault_state()
    monkeypatch.setenv("PFX_FAULT", "cb_commit_crash:1")
    try:
        # chains step 2 on the in-flight step, then commits step 1: the crash
        with pytest.raises(mod.ArenaReset) as ei:
            eng.step()
    finally:
        monkeypatch.delenv("PFX_FAULT")
        res.reset_fault_state()
    dead = {r.seq_id for r in ei.value.dead_rows}
    inflight = eng.has_inflight
    assert not eng.active.any()
    assert "cb_commit_crash at step 1" in str(ei.value.__cause__)
    s2 = eng.admit(PROMPTS[0], 6)
    for _ in range(96):
        eng.step()
        if not eng.active.any():
            break
    eng.flush()
    return dead, live, inflight, eng.slots[s2].tokens


def test_cb_commit_crash_drill_matches_jax(servers, monkeypatch):
    """An injected crash in the commit of an in-flight step resets the
    arena: exactly the live rows die, the chained step is dropped, and the
    rebuilt arena decodes token-identically, on both engines."""
    jserver, pserver = servers
    want = _crash_drill(jax_cb, jax_res, jax_cb.PagedDecodeEngine(jserver, max_batch=4),
                        monkeypatch)
    got = _crash_drill(pt_cb, pt_res, pt_cb.PagedDecodeEngine(pserver, max_batch=4),
                       monkeypatch)
    ref = pserver.generate_ids([PROMPTS[0]], max_dec_len=6)[0]
    assert got[0] == got[1] and want[0] == want[1]
    assert got[2] is False and want[2] is False
    assert got[3] == want[3] == ref


def test_cb_commit_crash_is_a_wired_serving_site(monkeypatch):
    monkeypatch.setenv("PFX_FAULT", "cb_commit_crash:3")
    assert pt_res.serving_fault_spec() == ("cb_commit_crash", 3, 1)


def test_warmup_runs_synchronous(servers):
    """Warmup steps with dispatch-ahead off whatever the knob (it inspects
    and releases one slot at a time), restores the knob and leaves no step
    in flight."""
    _, pserver = servers
    eng = pt_cb.PagedDecodeEngine(pserver, max_batch=2, block=BLK)
    eng.dispatch_ahead = True
    seen = []
    inner = eng._dispatch
    eng._dispatch = lambda chained: (seen.append((eng.dispatch_ahead, chained)),
                                     inner(chained))[1]
    eng.warmup([8, 16])
    assert seen and all(s == (False, False) for s in seen)
    assert eng.dispatch_ahead and not eng.has_inflight
    assert eng.stats["steps"] == len(seen) and eng.cache.stats()["kv_blocks_used"] == 0


def test_stream_offsets_stay_contiguous_with_overlap(servers, monkeypatch):
    """Streams fire at commit: with dispatch-ahead on (and a preemption
    storm rebasing one row) each row's pushes reassemble its answer with
    no hole and no overlap."""
    _, pserver = servers
    pt_res.reset_fault_state()
    monkeypatch.setenv("PFX_FAULT", "preempt_storm:4")
    eng = pt_cb.PagedDecodeEngine(pserver, max_batch=4, block=BLK)
    sched = pt_cb.ContinuousScheduler(eng, max_depth=8, dispatch_ahead=True, quantum=2,
                                      preempt_min_tokens=2)
    streams = {i: [] for i in range(len(PROMPTS))}
    futs = [sched.submit([p], 12, deadline_s=120,
                         stream=(lambda i: lambda r, s, t: streams[i].append((s, list(t))))(i))
            for i, p in enumerate(PROMPTS)]
    try:
        for _ in range(200):
            if all(f.done() for f in futs):
                break
            sched._iterate()
    finally:
        monkeypatch.delenv("PFX_FAULT")
        pt_res.reset_fault_state()
    got = [f.result(0)[0] for f in futs]
    assert sched.stats["preemptions"] == 1
    for i, pushes in streams.items():
        acc = []
        for start, toks in pushes:
            assert start == len(acc), f"row {i}: hole or overlap at {start}"
            acc.extend(toks)
        assert acc == got[i]
    assert got == [pserver.generate_ids([p], max_dec_len=12)[0] for p in PROMPTS]
    st = sched.serving_stats()
    assert (st["dispatch_ahead"], st["quantum"], st["graphs"], st["graph_replays"]) == (
        True, 2, 0, 0)
    # the one non-chained dispatch after the preemption's flush paid a gap
    assert st["steps"] > st["gap_steps"] >= 1 and st["host_gap_s"] > 0.0


def _warnings(mod, monkeypatch):
    said = []
    monkeypatch.setattr(mod.logger, "warning", lambda msg, *a, **k: said.append(msg))
    return said


def test_dispatch_ahead_env_off_warns_as_jax(servers, monkeypatch):
    """``PFX_DISPATCH_AHEAD=0`` steps synchronously with the JAX
    scheduler's warning (the JAX parse refuses 0 from the environment, so
    the JAX side takes it as the argument); unset, both dispatch ahead."""
    jserver, pserver = servers
    jsaid, psaid = _warnings(jax_cb, monkeypatch), _warnings(pt_cb, monkeypatch)
    jeng = jax_cb.PagedDecodeEngine(jserver, block=BLK)
    peng = pt_cb.PagedDecodeEngine(pserver, block=BLK, max_batch=jeng.capacity)
    monkeypatch.delenv("PFX_DISPATCH_AHEAD", raising=False)
    monkeypatch.delenv("PFX_SCHED_QUANTUM", raising=False)
    assert pt_cb.ContinuousScheduler(peng).dispatch_ahead and peng.dispatch_ahead
    assert jax_cb.ContinuousScheduler(jeng).dispatch_ahead and not psaid and not jsaid
    jax_cb.ContinuousScheduler(jeng, name="serve", dispatch_ahead=False)
    monkeypatch.setenv("PFX_DISPATCH_AHEAD", "0")
    sched = pt_cb.ContinuousScheduler(peng, name="serve")
    assert not sched.dispatch_ahead and not peng.dispatch_ahead
    assert psaid == jsaid and "PFX_DISPATCH_AHEAD=0" in psaid[0]
    assert sched.serving_stats()["dispatch_ahead"] is False


@pytest.mark.parametrize("raw", ["0", "-2", "x"])
def test_sched_quantum_is_loud_as_jax(servers, monkeypatch, raw):
    jserver, pserver = servers
    jeng = jax_cb.PagedDecodeEngine(jserver, block=BLK)
    peng = pt_cb.PagedDecodeEngine(pserver, block=BLK, max_batch=jeng.capacity)
    monkeypatch.setenv("PFX_SCHED_QUANTUM", raw)
    errs = []
    for mod, eng in ((jax_cb, jeng), (pt_cb, peng)):
        with pytest.raises(ValueError) as err:
            mod.ContinuousScheduler(eng)
        errs.append(str(err.value))
    assert errs[0] == errs[1] and "PFX_SCHED_QUANTUM" in errs[1]
    monkeypatch.delenv("PFX_SCHED_QUANTUM")
    errs = []
    for mod, eng in ((jax_cb, jeng), (pt_cb, peng)):
        with pytest.raises(ValueError) as err:
            mod.ContinuousScheduler(eng, quantum=0)
        errs.append(str(err.value))
    assert errs[0] == errs[1] == "PFX_SCHED_QUANTUM must be >= 1, got 0"
    assert pt_cb.ContinuousScheduler(peng, quantum=3).serving_stats()["quantum"] == 3


def _rows(rng, B, vocab, k):
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    return pt_gen.PagedRows(
        logits=torch.randn((B, vocab), generator=g),
        counts=torch.from_numpy(rng.integers(0, 3, (B, vocab)).astype(np.int32)),
        positions=torch.tensor([5, 9, 0, 13], dtype=torch.int32),
        gen_steps=torch.tensor([1, 4, 0, 7], dtype=torch.int32),
        max_news=torch.tensor([8, 8, 8, 9], dtype=torch.int32),
        active=torch.tensor([True, True, False, True]),
        forced_steps=torch.tensor([31, 31, 31, 7], dtype=torch.int32),
        reject=torch.tensor([-1, 3, -1, -1], dtype=torch.int32) if k else None)


def _clone(rows):
    return pt_gen.PagedRows(**{f: (None if getattr(rows, f) is None else getattr(rows, f).clone())
                               for f in ("logits", "counts", "positions", "gen_steps",
                                         "max_news", "active", "forced_steps", "reject")})


@pytest.mark.parametrize("strategy", ["greedy_search", "sampling"])
@pytest.mark.parametrize("k", [0, 3])
def test_static_buffer_step_is_bitwise_the_functional_step(servers, strategy, k):
    """``decode_step`` / ``decode_step_spec`` with ``inplace`` (the form
    the engine runs and the card captures) write exactly the functional
    form's next state into the rows' own tensors, at float32 on the CPU,
    greedy and sampled (the same generator seed), and leave the arena
    identical."""
    _, pserver = servers
    model, cfg = pserver.model, pserver.module.config
    rng = np.random.default_rng(5)
    B, vocab, nb = 4, int(cfg.vocab_size), 12
    gen = pt_gen.GenerationConfig(max_dec_len=8, decode_strategy=strategy, eos_token_id=95,
                                  pad_token_id=0, top_p=0.9 if strategy == "sampling" else 1.0,
                                  repetition_penalty=1.2)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))[:8].reshape(B, 2)
                              .astype(np.int32))
    drafts = torch.from_numpy(rng.integers(1, vocab, (B, k)).astype(np.int32))
    base = _rows(rng, B, vocab, k)
    pools = pt_gen.init_paged_pools(cfg, nb, BLK, torch.device("cpu"))
    pools.k.normal_(generator=torch.Generator().manual_seed(1))
    pools.v.normal_(generator=torch.Generator().manual_seed(2))
    outs = []
    for inplace in (False, True):
        rows = _clone(base)
        arena = pt_gen.PagedPools(pools.k.clone(), pools.v.clone())
        gen_rng = torch.Generator().manual_seed(11)
        with torch.inference_mode():
            if k:
                window, ncommit, nxt = pt_gen.decode_step_spec(
                    model, arena, tables, rows, drafts, gen, generator=gen_rng, inplace=inplace)
            else:
                tok, nxt = pt_gen.decode_step(model, arena, tables, rows, gen,
                                              generator=gen_rng, inplace=inplace)
                window, ncommit = tok[:, None], base.active.long()
        if inplace:
            assert nxt is rows
        outs.append((window, ncommit, nxt, arena))
    (w0, n0, r0, a0), (w1, n1, r1, a1) = outs
    assert torch.equal(w0, w1) and torch.equal(n0, n1)
    for f in ("logits", "counts", "positions", "gen_steps", "active", "reject"):
        if getattr(r0, f) is not None:
            assert torch.equal(getattr(r0, f), getattr(r1, f)), f
    assert torch.equal(a0.k, a1.k) and torch.equal(a0.v, a1.v)
