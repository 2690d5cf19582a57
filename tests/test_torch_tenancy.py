"""PyTorch port: multi-tenant serving against the JAX package on the CPU.

The host vocabulary of ``core/tenancy.py`` (labels, loud config parsing,
token buckets, the deficit round-robin pick), the metrics registry of
``utils/telemetry.py`` and the fault harness of ``utils/resilience.py``
are held against the JAX modules on the same inputs: same outputs, same
error messages, the same pick sequences.  The schedulers (the coalescing
``RequestQueue`` and the ``ContinuousScheduler``) are driven through the
sequences of tests/test_tenant_sched.py next to the JAX schedulers, one
iteration at a time (the JAX scheduler synchronous, the port's with its
default dispatch-ahead, whose commits land one iteration later):
same batch order, same victim slots, the same preemption and admission
counts and identical greedy tokens (float32).  The serve CLI runs as a
``--device cpu`` subprocess: SSE frames reassemble the non-streamed
answer, the tenant headers are read, ``/metrics`` parses and agrees with
``/healthz``, and ``PFX_FAULT`` is refused at boot unless the serving
path wires its site.

The model is the TINY serving config of tests/test_kv_tier.py (float32,
dropout off) with JAX-initialised weights, perturbed, crossing to the
port through the bridge; KV blocks of 8 tokens.
"""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from paddlefleetx_tpu.core import continuous_batching as jax_cb
from paddlefleetx_tpu.core import paged_cache as jax_pc
from paddlefleetx_tpu.core import request_queue as jax_rq
from paddlefleetx_tpu.core import tenancy as jax_ten
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.core.serving import GenerationServer as JaxServer
from paddlefleetx_tpu.models.gpt import model as jax_model
from paddlefleetx_tpu.models.gpt.config import GPTConfig as JaxGPTConfig
from paddlefleetx_tpu.ops import speculative as jax_spec
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils import resilience as jax_res
from paddlefleetx_tpu.utils import telemetry as jax_tel
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core import continuous_batching as pt_cb
from paddlefleetx_tpu_torch.core import request_queue as pt_rq
from paddlefleetx_tpu_torch.core import tenancy as pt_ten
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.core.serving import GenerationServer
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.ops import speculative as pt_spec
from paddlefleetx_tpu_torch.utils import resilience as pt_res
from paddlefleetx_tpu_torch.utils import telemetry as pt_tel
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
BLK = 8
# the second prompt spans a full block, so a preempted row of it resumes
# as a prefix hit with the cache on
PROMPTS = [[1, 2, 3], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [9, 10],
           [11, 12, 13, 14]]
MAX_NEW = 6


def _both(fn):
    """``fn(module)`` on the JAX and the port module: (value or the
    exception's type name and message) for each."""
    out = []
    for mod in (jax_ten, pt_ten):
        try:
            out.append(("ok", fn(mod)))
        except Exception as exc:  # noqa: BLE001 — compared below
            out.append((type(exc).__name__, str(exc)))
    return out


# ---------------------------------------------------------------------------
# core/tenancy.py: the host cases of tests/test_tenancy.py, both modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "", "  ", "gold", "team:alpha-1.2_x", "a b\nc{d}",
                                 "x" * 5000])
def test_normalize_tenant_matches_jax(raw):
    want, got = _both(lambda m: m.normalize_tenant(raw))
    assert got == want and len(got[1]) <= 64


@pytest.mark.parametrize("raw", [None, "", "not-a-number", "7", "  -3 ", "9999", "-9999"])
def test_parse_priority_matches_jax(raw):
    want, got = _both(lambda m: m.parse_priority(raw))
    assert got == want


def test_label_cap_matches_jax(monkeypatch):
    def run(m):
        cap = m.TenantLabelCap(topk=2)
        seq = [cap.label(t) for t in ("a", "b", "c", "a", "c")] + [cap.labels()]
        seeded = m.TenantLabelCap(topk=2, seed=["gold", "silver", "bronze"])
        return seq + [seeded.label(t) for t in ("flood", "gold", "silver")]

    want, got = _both(run)
    assert got == want and got[1][2] == pt_ten.OVERFLOW_TENANT
    for raw in ("3", "zero", "0"):
        monkeypatch.setenv("PFX_TENANT_LABEL_TOPK", raw)
        want, got = _both(lambda m: m.TenantLabelCap().topk)
        assert got == want


@pytest.mark.parametrize("obj", [
    [], {"defualt": {}}, {"default": {"wieght": 2}}, {"default": {"weight": 0}},
    {"tenants": {"a": {"rps": -1}}}, {"tenants": {"a": {"burst": 0.5}}},
    {"tenants": {"a": {"max_inflight": 0}}}, {"tenants": {"bad name": {}}},
    {"default": {"weight": 1}, "tenants": {"gold": {"weight": 4, "rps": 50, "burst": 100,
                                                    "max_inflight": 32}}},
])
def test_tenant_config_from_obj_matches_jax(obj):
    def run(m):
        cfg = m.TenantConfig.from_obj(copy.deepcopy(obj))
        return (cfg.weight("gold"), cfg.weight("stranger"), cfg.known_tenants(),
                [(p.weight, p.rps, p.burst, p.max_inflight)
                 for p in (cfg.default, *cfg.tenants.values())])

    want, got = _both(run)
    assert got == want


def test_tenant_config_from_file_matches_jax(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"tenants": {"gold": {"weight": 2}}}))
    for path in (tmp_path / "absent.json", bad, good):
        want, got = _both(lambda m: m.TenantConfig.from_file(str(path)).weight("gold"))
        assert got == want
    assert got == ("ok", 2)


def test_token_bucket_and_admission_match_jax():
    def run(m):
        b = m.TokenBucket(rate=2.0, burst=1.0)
        seq = [b.try_acquire(now=t) for t in (100.0, 100.0, 100.25, 100.5)]
        burst = m.TokenBucket(rate=10.0, burst=3.0)
        burst.try_acquire(now=0.0)
        seq.append(sum(1 for _ in range(100) if burst.try_acquire(now=3600.0)[0]))
        adm = m.TenantAdmission(m.TenantConfig.from_obj({"tenants": {"a": {"max_inflight": 2}}}))
        seq += [adm.admit("a"), adm.admit("a"), adm.admit("a"), adm.admit("b")]
        adm.release("a")
        seq += [adm.admit("a"), adm.inflight_snapshot()]
        clock = [1000.0]
        rate = m.TenantAdmission(m.TenantConfig.from_obj({"tenants": {"a": {"rps": 1, "burst": 1}}}),
                                 clock=lambda: clock[0])
        seq.append(rate.admit("a"))
        rate.release("a")
        seq.append(rate.admit("a"))
        clock[0] += 1.0
        seq += [rate.admit("a"), rate.bucket_snapshot()]
        return seq

    want, got = _both(run)
    assert got == want
    assert got[1][1] == (False, pytest.approx(0.5))


@pytest.mark.parametrize("weights,backlog,picks", [
    ({"gold": 4.0, "brz": 1.0}, {"gold": 10, "brz": 10}, 100),
    ({"flood": 99.0, "tiny": 1.0}, {"flood": 1000, "tiny": 1000}, 500),
    ({"a": 3.0, "b": 1.0, "c": 0.5}, {"a": 2, "b": 5, "c": 1}, 60),
    ({}, {"only": 5}, 10),
])
def test_drr_pick_sequences_match_jax(weights, backlog, picks):
    """The same pick sequence, pick for pick, under a sustained backlog,
    and a returning idle tenant banks no credit."""
    def run(m):
        drr = m.DeficitRoundRobin(weight_fn=lambda t: weights.get(t, 1.0))
        first = next(iter(backlog))
        idle = {t: (0 if t == first else n) for t, n in backlog.items()}
        seq = []
        for b in [backlog] * picks + [idle] * (picks // 4) + [backlog] * (picks // 4):
            t = drr.pick(b)
            drr.charge(t)
            seq.append(t)
        return seq + [drr.pick({})]

    want, got = _both(run)
    assert got == want and got[1][-1] is None


# ---------------------------------------------------------------------------
# utils/telemetry.py: the registry, both modules
# ---------------------------------------------------------------------------


def test_metrics_table_is_the_jax_table():
    """Every name the port declares is declared by the JAX table, with
    the same kind and help text (no new pfx_ name)."""
    assert pt_tel.METRICS
    for name, entry in pt_tel.METRICS.items():
        assert jax_tel.METRICS.get(name) == entry, name


def _fill(reg):
    reg.counter("pfx_queue_submitted_total").inc(3)
    reg.counter("pfx_tenant_preemptions_total", tenant="gold").inc()
    reg.counter("pfx_http_responses_total", code="200").inc(2)
    reg.gauge("pfx_tenant_queue_depth", tenant='we"ird\\na,me').set(4)
    reg.gauge("pfx_http_requests_in_flight").add(-1.5)
    for v in (0.004, 0.2, 7.0, 500.0):
        reg.histogram("pfx_tenant_ttft_seconds", tenant="brz").observe(v)


class _Collector:
    def collect(self):
        return [("pfx_queue_submitted_total", {}, 2.0), ("pfx_queue_depth", {}, 5.0)]


def test_registry_renders_and_parses_like_jax():
    """The same operations render the same Prometheus text on both
    registries; the port's ``parse_exposition`` reads it back as the JAX
    one does (labels unescaped), collectors sum into counters, and
    ``value`` reads one snapshot."""
    regs = (jax_tel.Registry(), pt_tel.Registry())
    keep = [_Collector(), _Collector()]
    for reg, col in zip(regs, keep):
        _fill(reg)
        reg.register_collector(col)
    texts = [reg.render_prometheus() for reg in regs]
    assert texts[1] == texts[0]
    rows = pt_tel.parse_exposition(texts[1])
    assert rows == jax_tel.parse_exposition(texts[0])
    got = {(n, tuple(sorted(lab.items()))): v for n, lab, v in rows}
    assert got[("pfx_queue_submitted_total", ())] == 5.0
    assert got[("pfx_tenant_queue_depth", (("tenant", 'we"ird\\na,me'),))] == 4.0
    assert got[("pfx_tenant_ttft_seconds_count", (("tenant", "brz"),))] == 4.0
    assert got[("pfx_tenant_ttft_seconds_bucket", (("le", "+Inf"), ("tenant", "brz")))] == 4.0
    snap = regs[1].snapshot()
    assert regs[1].value("pfx_tenant_preemptions_total", snap=snap, tenant="gold") == 1.0
    assert regs[1].value("pfx_tenant_ttft_seconds", snap=snap, tenant="brz")["count"] == 4
    with pytest.raises(ValueError, match="not declared"):
        regs[1].counter("pfx_serving_traces_total")
    with pytest.raises(ValueError, match="not declared"):
        regs[1].gauge("pfx_queue_submitted_total")  # declared as a counter
    regs[1].reset()
    assert regs[1].snapshot() == {}


def test_stats_view_exports_numeric_keys():
    reg = pt_tel.Registry()
    view = pt_tel.StatsView({"requests": "pfx_serving_requests_total", "note": None},
                            init={"last_error": ""}, registry=reg)
    view["requests"] += 2
    view["note"] = 7
    view["last_error"] = "boom"
    assert dict(view) == {"requests": 2, "note": 7, "last_error": "boom"}
    assert reg.value("pfx_serving_requests_total") == 2.0
    assert set(reg.snapshot()) == {"pfx_serving_requests_total"}


# ---------------------------------------------------------------------------
# utils/resilience.py: the fault harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", ["", "preempt_storm:3", "spill_corrupt:1:2", "io_stall:2:0.5",
                                 "bogus:1", "preempt_storm", "preempt_storm:x",
                                 "preempt_storm:1:0", "a:b:c:d", "io_stall:1:x"])
def test_fault_spec_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("PFX_FAULT", raw)
    out = []
    for mod in (jax_res, pt_res):
        try:
            out.append(mod.fault_spec())
        except ValueError as exc:
            out.append(str(exc))
    assert out[1] == out[0]
    assert pt_res.FAULT_SITES == jax_res.FAULT_SITES


def test_maybe_fire_counts_like_jax(monkeypatch):
    monkeypatch.setenv("PFX_FAULT", "preempt_storm:3:2")
    fired = []
    for mod in (jax_res, pt_res):
        mod.reset_fault_state()
        fired.append([mod.maybe_fire("preempt_storm", s) for s in range(1, 7)]
                     + [mod.maybe_fire("spill_corrupt", 9)])
        mod.reset_fault_state()
    assert fired[1] == fired[0] == [False, False, True, True, False, False, False]
    assert pt_res.serving_fault_spec() == ("preempt_storm", 3, 2)
    # the fleet's sites are wired and count as the JAX harness counts
    monkeypatch.setenv("PFX_FAULT", "handoff_drop:2:2")
    fired = []
    for mod in (jax_res, pt_res):
        mod.reset_fault_state()
        fired.append([mod.maybe_fire("handoff_drop", s) for s in range(1, 5)])
        mod.reset_fault_state()
    assert fired[1] == fired[0] == [False, True, True, False]
    assert pt_res.serving_fault_spec() == ("handoff_drop", 2, 2)
    # a training site stays refused by the serving path
    monkeypatch.setenv("PFX_FAULT", "nan_grads:1")
    with pytest.raises(NotImplementedError, match="not wired"):
        pt_res.serving_fault_spec()


# ---------------------------------------------------------------------------
# RequestQueue: the weighted-fair pick and tenant-pure coalescing
# ---------------------------------------------------------------------------


def _queue_order(mod, tenant_config, submits, max_coalesce):
    batches = []

    def runner(prompts, max_new):
        batches.append([p[0] for p in prompts])
        return [list(p) for p in prompts]

    q = mod.RequestQueue(runner, max_depth=32, max_coalesce=max_coalesce,
                         tenant_config=tenant_config)
    futs = [q.submit([[x]], 2, coalesce_key=key, tenant=tn) for x, key, tn in submits]
    q.start()  # everything queued first: the picks are pure DRR
    for f in futs:
        f.result(timeout=10)
    assert q.shutdown(timeout=5)
    return batches


@pytest.mark.parametrize("case", ["drr", "coalesce", "one_tenant"])
def test_request_queue_batch_order_matches_jax(case):
    if case == "drr":
        submits = [(10 + i, None, "gold") for i in range(6)] + [(20 + i, None, "brz")
                                                               for i in range(2)]
        weights, max_coalesce = {"gold": 3, "brz": 1}, 1
    elif case == "coalesce":
        submits = [(1, ("k",), "a"), (2, ("k",), "b"), (3, ("k",), "a"), (4, ("j",), "a"),
                   (5, ("k",), "b")]
        weights, max_coalesce = None, 4
    else:
        submits = [(1, ("k",), None), (2, ("j",), None), (3, ("k",), None), (4, None, None)]
        weights, max_coalesce = None, 4
    got = []
    for mod, ten in ((jax_rq, jax_ten), (pt_rq, pt_ten)):
        cfg = (ten.TenantConfig.from_obj({"tenants": {t: {"weight": w}
                                                      for t, w in weights.items()}})
               if weights else None)
        got.append(_queue_order(mod, cfg, submits, max_coalesce))
    assert got[1] == got[0]
    if case == "drr":  # weighted fair, FCFS within a tenant
        order = [x for b in got[1] for x in b]
        assert order.index(20) < order.index(15)
    if case == "coalesce":  # one tenant's batch never takes another's entries
        assert sorted(sorted(b) for b in got[1]) == [[1, 3], [2, 5], [4]]
    if case == "one_tenant":  # exactly FCFS with same-key coalescing
        assert got[1] == [[1, 3], [2], [4]]


def test_request_queue_exports_tenant_depth():
    reg = pt_tel.get_registry()
    q = pt_rq.RequestQueue(lambda p, m: [list(x) for x in p], max_depth=8)
    q.submit([[1]], 2, tenant="gold")
    q.submit([[2]], 2, tenant="gold")
    q.submit([[3]], 2)
    rows = {(n, tuple(lab.items())): v for n, lab, v in q.collect()}
    assert rows[("pfx_tenant_queue_depth", (("tenant", "gold"),))] == 2.0
    assert rows[("pfx_tenant_queue_depth", (("tenant", "anon"),))] == 1.0
    assert rows[("pfx_queue_depth", ())] == 3.0
    assert reg.value("pfx_tenant_queue_depth", tenant="gold") >= 2.0
    q.start()
    assert q.shutdown(timeout=5)


def test_entry_stream_rebase_and_finished_tokens():
    got = []
    for mod in (jax_cb, pt_cb):
        pushes = []
        e = mod._CBEntry(prompts=[[1, 2]], max_new=8, deadline=1e9, future=None,
                         enqueued_at=0.0, stream=lambda r, s, t: pushes.append((r, s, list(t))))
        e.emit_stream(0, 0, [5, 6])
        e.row_prefill[0] = [5, 6]
        e.emit_stream(0, 0, [7])
        got.append((pushes, e.finished_tokens(0, [7, 8]), e.finished_tokens(1, [9])))
    assert got[1] == got[0] == ([(0, 0, [5, 6]), (0, 2, [7])], [5, 6, 7, 8], [9])


# ---------------------------------------------------------------------------
# ContinuousScheduler against the JAX scheduler
# ---------------------------------------------------------------------------


def _port_cfg():
    return process_configs(AttrDict.from_nested(
        {k: v for k, v in copy.deepcopy(TINY).items() if k in PORT_SECTIONS}))


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
    pcfg = _port_cfg()
    module = GPTModule(pcfg)
    return jserver, GenerationServer(pcfg, module, params_from_jax(module.config, tree),
                                     torch.device("cpu"))


def _pair(servers, draft_k=0, **kw):
    """A JAX engine and a port engine of the same geometry (the JAX batch
    pads to the data-parallel world: the port takes its capacity)."""
    jserver, pserver = servers
    kw.setdefault("block", BLK)
    jspec = jax_spec.SpecConfig(draft_k=draft_k) if draft_k else None
    pspec = pt_spec.SpecConfig(draft_k=draft_k) if draft_k else None
    jeng = jax_cb.PagedDecodeEngine(jserver, spec=jspec, **kw)
    kw["max_batch"] = jeng.capacity
    return jeng, pt_cb.PagedDecodeEngine(pserver, spec=pspec, **kw)


def _sched(eng, **kw):
    if isinstance(eng, jax_cb.PagedDecodeEngine):
        sched = jax_cb.ContinuousScheduler(eng, max_depth=16, dispatch_ahead=False, quantum=1,
                                           **kw)
    else:
        sched = pt_cb.ContinuousScheduler(eng, max_depth=16, **kw)
    victims = []
    inner = sched._preempt_slot
    sched._preempt_slot = lambda slot: (victims.append(slot), inner(slot))[1]
    return sched, victims


def _iterate_until(sched, done, limit=400):
    for _ in range(limit):
        if done():
            return
        sched._iterate()
    raise AssertionError("scheduler never finished")


def _ctr(tel, name, **labels):
    return tel.get_registry().value(name, **labels) or 0


def _tenant_cfg(ten, **weights):
    return ten.TenantConfig.from_obj({"tenants": {t: {"weight": w} for t, w in weights.items()}})


def test_scheduler_drr_parity_and_counters(servers):
    """Two tenants at 4:1 through a block-constrained arena: the same
    tokens, admission counts and per-tenant counters on both schedulers,
    and every answer equal to the request served alone."""
    out = []
    for eng, (ten, tel) in zip(_pair(servers, num_blocks=5), ((jax_ten, jax_tel),
                                                              (pt_ten, pt_tel))):
        sched, _ = _sched(eng, tenant_config=_tenant_cfg(ten, gold=4, brz=1))
        c0 = [_ctr(tel, "pfx_tenant_admitted_total", tenant=t) for t in ("gold", "brz")]
        futs = [sched.submit([p], MAX_NEW, deadline_s=120, tenant="gold" if i % 2 == 0 else "brz")
                for i, p in enumerate(PROMPTS)]
        _iterate_until(sched, lambda: all(f.done() for f in futs))
        out.append(([f.result(0)[0] for f in futs], int(sched.stats["prefill_admits"]),
                    [_ctr(tel, "pfx_tenant_admitted_total", tenant=t) - c
                     for t, c in zip(("gold", "brz"), c0)]))
    assert out[1] == out[0]
    assert out[1][2] == [2, 2]
    alone = [servers[1].generate_ids([p], max_dec_len=MAX_NEW)[0] for p in PROMPTS]
    assert out[1][0] == alone


def _storm_run(eng, sched, tel, streams):
    futs = [sched.submit([p], MAX_NEW, deadline_s=120,
                         stream=(lambda i: lambda r, s, t: streams[i].append((s, list(t))))(i))
            for i, p in enumerate(PROMPTS)]
    p0 = _ctr(tel, "pfx_tenant_preemptions_total", tenant="anon")
    a0 = _ctr(tel, "pfx_tenant_admitted_total", tenant="anon")
    _iterate_until(sched, lambda: all(f.done() for f in futs))
    return ([f.result(0)[0] for f in futs],
            _ctr(tel, "pfx_tenant_preemptions_total", tenant="anon") - p0,
            _ctr(tel, "pfx_tenant_admitted_total", tenant="anon") - a0)


@pytest.mark.parametrize("mode", ["cache_off", "cache_on", "draft_k2"])
def test_preempt_storm_resume_is_token_identical(servers, monkeypatch, mode):
    """``PFX_FAULT=preempt_storm:3`` force-preempts the lowest-priority
    eligible row at iteration 3; the victim resumes as a continuation
    (with the prefix cache on: a prefix hit whose suffix runs as a
    chunk) and every output equals the undisturbed run's.  Same victim
    slot, counts and tokens on both schedulers; each row's stream pushes
    reassemble its answer with contiguous offsets."""
    kw = {"prefix_cache_blocks": 16} if mode == "cache_on" else {}
    draft_k = 2 if mode == "draft_k2" else 0
    undisturbed = None
    out = []
    for storm in (False, True):
        for eng, tel, res in zip(_pair(servers, draft_k=draft_k, **kw), (jax_tel, pt_tel),
                                 (jax_res, pt_res)):
            res.reset_fault_state()
            if storm:
                monkeypatch.setenv("PFX_FAULT", "preempt_storm:3")
            sched, victims = _sched(eng, preempt_min_tokens=2)
            streams = {i: [] for i in range(len(PROMPTS))}
            got, preempted, admitted = _storm_run(eng, sched, tel, streams)
            monkeypatch.delenv("PFX_FAULT", raising=False)
            res.reset_fault_state()
            hits = eng.cache.prefix.stats["hits"]
            if not storm:
                undisturbed = got
                continue
            for i, pushes in streams.items():
                acc = []
                for start, toks in pushes:
                    assert start == len(acc), f"row {i}: hole or overlap at {start}"
                    acc.extend(toks)
                assert acc == got[i]
            out.append((got, victims, int(sched.stats["preemptions"]), preempted, admitted,
                        hits))
    assert out[1] == out[0]
    got, victims, preemptions, preempted, admitted, hits = out[1]
    assert got == undisturbed
    assert len(victims) == preemptions == preempted == 1
    assert admitted == len(PROMPTS) + 1  # a resume is an admission
    assert (hits >= 1) == (mode == "cache_on")


def test_priority_arrival_preempts_lowest_past_threshold(servers):
    """With 5 usable blocks of 16, two 20-token bulk rows leave 1 free, so a
    priority-10 arrival asking 2 blocks preempts the lowest bulk row once
    both have committed 2 tokens; every row still finishes with the
    tokens it would have had alone."""
    out = []
    for eng, tel in zip(_pair(servers, block=16, num_blocks=6), (jax_tel, pt_tel)):
        sched, victims = _sched(eng, preempt_min_tokens=2)
        futs = [sched.submit([PROMPTS[i]], 20, deadline_s=120, tenant="bulk", priority=-1)
                for i in (0, 2)]
        _iterate_until(sched, lambda: sum(len(r.tokens) >= 2 for r in eng.slots
                                          if r is not None) == 2)
        p0 = _ctr(tel, "pfx_tenant_preemptions_total", tenant="bulk")
        futs.append(sched.submit([PROMPTS[3]], 20, deadline_s=120, tenant="vip", priority=10))
        _iterate_until(sched, lambda: all(f.done() for f in futs))
        out.append(([f.result(0)[0] for f in futs], victims, int(sched.stats["preemptions"]),
                    _ctr(tel, "pfx_tenant_preemptions_total", tenant="bulk") - p0))
    assert out[1] == out[0]
    assert out[1][2] >= 1 and out[1][3] == out[1][2]
    alone = [servers[1].generate_ids([PROMPTS[i]], max_dec_len=20)[0] for i in (0, 2, 3)]
    assert out[1][0] == alone


def test_equal_priority_never_preempts(servers):
    out = []
    for eng in _pair(servers, block=16, num_blocks=6):
        sched, victims = _sched(eng, preempt_min_tokens=2)
        futs = [sched.submit([p], 20, deadline_s=120, priority=5) for p in PROMPTS]
        _iterate_until(sched, lambda: all(f.done() for f in futs))
        out.append(([f.result(0)[0] for f in futs], victims, int(sched.stats["preemptions"])))
    assert out[1] == out[0]
    assert out[1][1:] == ([], 0)


def test_preempt_min_tokens_is_loud(servers):
    for mod, eng in zip((jax_cb, pt_cb), _pair(servers)):
        with pytest.raises(ValueError, match="preempt_min_tokens"):
            mod.ContinuousScheduler(eng, preempt_min_tokens=0)


# ---------------------------------------------------------------------------
# the spill_corrupt drill
# ---------------------------------------------------------------------------

PFX_A = list(range(1, 9))
PFX_B = list(range(10, 18))
A1, A2, B1 = PFX_A + [40, 41, 42], PFX_A + [50, 51], PFX_B + [60, 61, 62]


def _serve_release(eng, prompt):
    slot = eng.admit(prompt, MAX_NEW)
    for _ in range(64):
        eng.step()
        if not eng.active.any():
            break
    tokens = list(eng.slots[slot].tokens)
    eng.release(slot)
    return tokens


def test_spill_corrupt_drill_matches_jax(servers, monkeypatch):
    """``PFX_FAULT=spill_corrupt:1``: the first readmit probe finds A's
    spilled block torn, the checksum discards it, and A2 recomputes in
    full with the tokens it has without the fault.  Every count equals
    the JAX engine's on the same sequence."""
    out = []
    for eng, res in zip(_pair(servers, max_batch=4, prefix_cache_blocks=1,
                              prefix_spill_bytes=64 << 20), (jax_res, pt_res)):
        toks = [_serve_release(eng, A1), _serve_release(eng, B1)]
        spilled = (eng.cache.spill.stats["spills"], len(eng.cache.spill))
        monkeypatch.setenv("PFX_FAULT", "spill_corrupt:1")
        res.reset_fault_state()
        before = (dict(eng.cache.spill.stats), dict(eng.cache.prefix.stats),
                  eng.stats["prefill_tokens"])
        toks.append(_serve_release(eng, A2))
        monkeypatch.delenv("PFX_FAULT")
        res.reset_fault_state()
        out.append((toks, spilled, dict(eng.cache.spill.stats), dict(eng.cache.prefix.stats),
                    eng.stats["prefill_tokens"] - before[2], before[0]["discards"]))
    assert out[1] == out[0]
    toks, spilled, spill, prefix, computed, discards0 = out[1]
    assert spilled[0] >= 1 and spill["readmits"] == 0 and spill["discards"] == discards0 + 1
    assert computed == len(A2)
    alone = [servers[1].generate_ids([p], max_dec_len=MAX_NEW)[0] for p in (A1, B1, A2)]
    assert toks == alone


# ---------------------------------------------------------------------------
# the serve CLI: --device cpu subprocesses
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, path, body=None, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers, r.read().decode()


def _sse(text):
    """(event, data) frames of a server-sent-events body."""
    frames = []
    for block in text.strip().split("\n\n"):
        fields = dict(line.split(": ", 1) for line in block.splitlines())
        frames.append((fields["event"], json.loads(fields["data"])))
    return frames


def _reassemble(frames, n_rows):
    rows = [[] for _ in range(n_rows)]
    for event, data in frames:
        if event == "token":
            assert data["index"] == len(rows[data["row"]]), frames
            rows[data["row"]].extend(data["tokens"])
    return rows


class _Server:
    """A serve CLI subprocess, its output in a file (never a pipe that
    could fill)."""

    def __init__(self, tmp_path, args, env_extra=None):
        cfg_path = tmp_path / "tiny.yaml"
        cfg_path.write_text(yaml.safe_dump({k: TINY[k] for k in PORT_SECTIONS}))
        self.port = _free_port()
        self.log = tmp_path / f"serve_{self.port}.log"
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", PFX_KV_BLOCK=str(BLK))
        env.pop("PFX_FAULT", None)
        env.update(env_extra or {})
        self.fh = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", str(cfg_path),
             "--port", str(self.port), "--device", "cpu", *args],
            env=env, cwd=REPO, stdout=self.fh, stderr=subprocess.STDOUT, text=True)

    def output(self):
        return self.log.read_text()

    def wait_healthy(self):
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                return json.loads(_request(self.port, "/healthz", timeout=5)[2])
            except OSError:
                assert self.proc.poll() is None, f"server died: {self.output()[-3000:]}"
                time.sleep(0.3)
        raise AssertionError(f"never healthy: {self.output()[-3000:]}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                rc = self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                rc = self.proc.wait(timeout=10)
        else:
            rc = self.proc.returncode
        self.fh.close()
        return rc


def _metrics(port):
    status, headers, text = _request(port, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    rows = pt_tel.parse_exposition(text)
    assert rows == jax_tel.parse_exposition(text)
    types = {line.split()[2]: line.split()[3] for line in text.splitlines()
             if line.startswith("# TYPE")}
    for name, kind in types.items():  # every emitted name is a JAX-declared one
        assert jax_tel.METRICS[name][0] == kind, name
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in rows}


def test_serve_cli_continuous_tenancy_stream_metrics(tmp_path):
    """--scheduler continuous with a --tenants file: tenant headers are
    read, SSE token frames reassemble the non-streamed answer with
    contiguous indices, /metrics parses (every name JAX-declared, same
    kind) and agrees with /healthz, /debug/state answers,
    /admin/adopt_prefixes refuses a body that is not a KV-handoff payload
    with the JAX codec's 400, /admin/drain drains with exit 0, and an armed
    PFX_FAULT drill on a wired site boots."""
    tenants = tmp_path / "tenants.json"
    tenants.write_text(json.dumps({"tenants": {"gold": {"weight": 4}, "brz": {"weight": 1}}}))
    srv = _Server(tmp_path, ["--scheduler", "continuous", "--cb-batch", "2", "--tenants",
                             str(tenants), "--prefix-cache-blocks", "8"],
                  {"PFX_FAULT": "spill_corrupt:1"})
    try:
        health = srv.wait_healthy()
        assert health["ok"] and "PFX_FAULT drill armed: spill_corrupt" in srv.output()
        prompt = PROMPTS[1]
        body = {"prompt_ids": prompt, "max_tokens": MAX_NEW}
        plain = json.loads(_request(srv.port, "/generate", body,
                                    {"X-Tenant": "gold", "X-Priority": "5"})[2])
        status, headers, text = _request(srv.port, "/generate?stream=1", body,
                                         {"X-Tenant": "brz"})
        assert status == 200 and headers["Content-Type"] == "text/event-stream"
        frames = _sse(text)
        assert frames[-1][0] == "summary" and frames[-1][1]["usage"]["tokens"] == MAX_NEW
        assert frames[-1][1]["flushes"] == MAX_NEW  # one frame a step
        assert _reassemble(frames, 1) == [plain["completion_ids"]]
        multi = {"prompts_ids": PROMPTS[:3], "max_tokens": MAX_NEW}
        want = json.loads(_request(srv.port, "/generate", multi)[2])["completions_ids"]
        text = _request(srv.port, "/generate", multi, {"Accept": "text/event-stream"})[2]
        assert _reassemble(_sse(text), 3) == want
        status, _, text = _request(srv.port, "/debug/state")
        dbg = json.loads(text)
        assert status == 200 and dbg["scheduler"] == "continuous" and dbg["depth"] == 0
        assert dbg["tenants"]["gold"]["admitted_rows"] == 1
        with pytest.raises(urllib.error.HTTPError) as err:
            _request(srv.port, "/admin/adopt_prefixes", {})
        with pytest.raises(ValueError) as refusal:
            jax_pc.unpack_handoff(b"{}")
        assert err.value.code == 400
        assert json.loads(err.value.read())["error"] == str(refusal.value)
        health = json.loads(_request(srv.port, "/healthz")[2])
        got = _metrics(srv.port)
        assert health["queue"]["completed"] == got[("pfx_queue_completed_total", ())] == 4
        assert health["queue"]["submitted"] == got[("pfx_queue_submitted_total", ())] == 4
        assert health["serving"]["requests"] == got[("pfx_serving_requests_total", ())] == 4
        assert (health["serving"]["tokens_out"] == got[("pfx_serving_tokens_out_total", ())]
                == 2 * MAX_NEW + 2 * sum(len(r) for r in want))
        assert health["tenants"]["gold"]["admitted"] == got[
            ("pfx_tenant_admitted_total", (("tenant", "gold"),))] == 1
        assert health["tenants"]["anon"]["admitted"] == 6
        assert health["queue"]["preemptions"] == 0
        assert got[("pfx_tenant_ttft_seconds_count", (("tenant", "brz"),))] == 1
        assert got[("pfx_request_ttft_seconds_count", ())] == 4
        assert got[("pfx_http_responses_total", (("code", "200"),))] >= 4
        assert got[("pfx_prefix_hits_total", ())] == health["serving"]["prefix"]["hits"] >= 1
        assert got[("pfx_queue_depth", ())] == health["queue_depth"] == 0
        status, _, text = _request(srv.port, "/admin/drain", {})
        assert status == 200 and json.loads(text)["state"] == "draining"
        assert srv.proc.wait(timeout=60) == 0
        assert srv.stop() == 0
        assert "drained cleanly" in srv.output()
    finally:
        srv.stop()


def test_serve_cli_coalesce_stream_is_one_flush(tmp_path):
    """On the coalescing scheduler a stream degrades to one flush at
    completion, in the same frames; the tenant headers are accepted."""
    srv = _Server(tmp_path, ["--warmup-batches", "1"])
    try:
        srv.wait_healthy()
        body = {"prompts_ids": [[1, 2, 3], [4, 5]], "max_tokens": 4}
        want = json.loads(_request(srv.port, "/generate", body, {"X-Tenant": "gold"})[2])
        text = _request(srv.port, "/generate?stream=1", body,
                        {"X-Tenant": "brz", "X-Priority": "junk"})[2]
        frames = _sse(text)
        assert [e for e, _ in frames] == ["token", "token", "summary"]
        assert _reassemble(frames, 2) == want["completions_ids"]
        got = _metrics(srv.port)
        assert got[("pfx_queue_completed_total", ())] == 2
        assert got[("pfx_tenant_ttft_seconds_count", (("tenant", "gold"),))] == 1
        assert srv.stop() == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("fault,want", [
    ("preempt_storm:x", "step/count must be integers"),
    ("no_such_site:1", "PFX_FAULT site 'no_such_site' unknown"),
    ("handoff_drop:1", "PFX_FAULT drill armed: handoff_drop at step 1"),
    ("nan_grads:1", "NotImplementedError: PFX_FAULT site 'nan_grads' is not wired"),
])
def test_serve_cli_refuses_pfx_fault_at_boot(tmp_path, fault, want):
    """A PFX_FAULT value that does not parse fails the boot with the JAX
    parser's message; a site the serving path does not wire (a training
    site) fails it with NotImplementedError.  The fleet's sites are wired:
    ``handoff_drop`` arms at boot as the JAX serve CLI arms it, and the
    replica serves and drains with exit 0."""
    srv = _Server(tmp_path, ["--scheduler", "continuous"], {"PFX_FAULT": fault})
    if "armed" in want:
        try:
            srv.wait_healthy()
            assert want in srv.output()
            assert srv.stop() == 0
        finally:
            srv.stop()
        assert fault.split(":")[0] in pt_res.SERVING_FAULT_SITES
        return
    rc = srv.proc.wait(timeout=120)
    out = srv.output()
    srv.stop()
    assert rc != 0 and want in out, out[-2000:]
    if "unknown" in want or "integers" in want:
        os.environ["PFX_FAULT"] = fault
        try:
            with pytest.raises(ValueError) as err:
                jax_res.fault_spec()
        finally:
            del os.environ["PFX_FAULT"]
        assert str(err.value) in out
