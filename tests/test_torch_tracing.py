"""PyTorch port: the tracing primitives, the SLO tracker, the flight
recorder, the continuous scheduler's decision log and both schedulers'
``debug_state`` against the JAX package on the CPU.

The primitives (``utils/tracing.py``: ``TraceContext.timeline``,
``TraceBuffer`` sampling and eviction, ``chrome_trace``,
``span_summary``, ``parse_span_summaries``, ``replay_decision_log``; and
``utils/telemetry.py``: ``Span``, ``SLOTracker``) are fed the same events
on the same injected clock on both sides and give equal results.  The
decision log: the port's ``ContinuousScheduler`` and the JAX one are
driven one ``_iterate()`` at a time on the seeded traffic of
tests/test_torch_dispatch_ahead.py (a pre-expired shed, mid-decode
admissions, an eviction, speculation, chunked prefill with prefix hits
and a ``preempt_storm`` fire), at quantum 1 and 3, with dispatch-ahead on
and off: the rows are equal column by column (the timestamp aside), and
their replay reproduces the admission, eviction, speculation, token-ledger
and tenant counters exactly.
"""

import json
import sys
import threading
import time

import pytest

from paddlefleetx_tpu.core import continuous_batching as jax_cb
from paddlefleetx_tpu.core import request_queue as jax_rq
from paddlefleetx_tpu.core import router as jax_router
from paddlefleetx_tpu.utils import resilience as jax_res
from paddlefleetx_tpu.utils import telemetry as jax_tel
from paddlefleetx_tpu.utils import tracing as jax_tr
from paddlefleetx_tpu_torch.core import continuous_batching as pt_cb
from paddlefleetx_tpu_torch.core import request_queue as pt_rq
from paddlefleetx_tpu_torch.core import router as pt_router
from paddlefleetx_tpu_torch.utils import resilience as pt_res
from paddlefleetx_tpu_torch.utils import telemetry as pt_tel
from paddlefleetx_tpu_torch.utils import tracing as pt_tr
from test_torch_dispatch_ahead import (  # noqa: F401 — servers is a fixture
    PROMPTS,
    SCENARIOS,
    STORM,
    _engines,
    servers,
)

ANCHOR = (1000.0, 1.7e9)


@pytest.fixture
def anchored(monkeypatch):
    """Both tracing modules on one monotonic-to-epoch anchor and one
    process identity, so wall-clock exports compare."""
    for mod in (jax_tr, pt_tr):
        monkeypatch.setattr(mod, "_anchor", ANCHOR)
        monkeypatch.setattr(mod, "_proc_identity", {"replica_id": "r0", "role": "monolith"})


def _fill(mod, t0=1000.0):
    """The same trace on either module: spans, instants, a negative span
    clamped to 0, and a stitched remote hop."""
    tc = mod.TraceContext("t-1", "request", t0=t0, scheduler="serve")
    tc.span("queue_wait", t0=t0, t1=t0 + 0.25)
    tc.span("prefill", t0=t0 + 0.25, t1=t0 + 0.4, prompt_len=11, bucket=16)
    for i in range(6):
        tc.event("decode_chunk", t=t0 + 0.41 + 0.01 * i, slot=0, committed=1, accepted=0)
    tc.span("clamped", t0=t0 + 0.5, t1=t0 + 0.45)
    summary = {"trace_id": "t-2", "proc": {"pid": 7, "replica_id": "peer"},
               "spans": [{"name": "remote_decode", "t0": ANCHOR[1] + 0.3, "dur": 0.05,
                          "args": {"n": 2}}], "dropped": 0}
    skew = tc.add_remote_summary(summary, t_send=t0 + 0.35, t_recv=t0 + 0.5)
    tc.event("respond", t=t0 + 0.6, code=200, tokens=6)
    tc.finish(t=t0 + 0.6)
    return tc, skew


def test_trace_context_timeline_matches_jax(anchored):
    (jt, jskew), (pt, pskew) = _fill(jax_tr), _fill(pt_tr)
    assert pskew == jskew
    assert pt.timeline() == jt.timeline()
    assert pt.total_s() == jt.total_s() == pytest.approx(0.6)
    assert [e["dur_s"] for e in pt.timeline()["events"] if e["name"] == "clamped"] == [0.0]


def test_chrome_trace_and_span_summary_match_jax(anchored):
    jt, pt = _fill(jax_tr)[0], _fill(pt_tr)[0]
    assert pt_tr.chrome_trace([pt, pt]) == jax_tr.chrome_trace([jt, jt])
    for cap in (48, 3):
        assert pt_tr.span_summary(pt, cap=cap) == jax_tr.span_summary(jt, cap=cap)
    raws = [json.dumps([pt_tr.span_summary(pt)]), json.dumps(pt_tr.span_summary(pt)),
            "not json", "[1, {\"a\": 2}]", "null"]
    for raw in raws:
        assert pt_tr.parse_span_summaries(raw) == jax_tr.parse_span_summaries(raw)


@pytest.mark.parametrize("sample", [1.0, 0.5, 0.3, 0.0])
def test_trace_buffer_sampling_and_cap_match_jax(sample):
    jb, pb = jax_tr.TraceBuffer(sample=sample, cap=4), pt_tr.TraceBuffer(sample=sample, cap=4)
    picks = []
    for buf in (jb, pb):
        picks.append([buf.maybe_start("request", t0=float(i)) is not None for i in range(10)])
    assert picks[0] == picks[1]
    assert [t.trace_id for t in pb.traces()] == [t.trace_id for t in jb.traces()]
    assert pb.enabled == jb.enabled == (sample > 0)
    forced = (jb.start("request"), pb.start("request"))
    assert (forced[1] is None) == (forced[0] is None) == (sample == 0)


def test_trace_knobs_parse_like_jax(monkeypatch):
    for raw in ("2", "-0.5", "x"):
        monkeypatch.setenv("PFX_TRACE_SAMPLE", raw)
        with pytest.raises(ValueError) as jerr:
            jax_tr.TraceBuffer()
        with pytest.raises(ValueError) as perr:
            pt_tr.TraceBuffer()
        assert str(perr.value) == str(jerr.value)
    monkeypatch.setenv("PFX_TRACE_SAMPLE", "0.25")
    monkeypatch.setenv("PFX_TRACE_CAP", "9")
    assert (pt_tr.TraceBuffer().sample, pt_tr.TraceBuffer().cap) == (0.25, 9)


def test_attach_discard_and_remote_parent_match_jax(monkeypatch):
    for mod in (jax_tr, pt_tr):
        monkeypatch.setattr(mod, "_buffer", mod.TraceBuffer(sample=0.5))
    out = []
    for tr, rq in ((jax_tr, jax_rq), (pt_tr, pt_rq)):
        futs = [rq.RequestFuture() for _ in range(4)]
        for f in futs[:3]:
            tr.attach_request_trace(f, t0=5.0, scheduler="s", prompts=1, max_new=4)
        with tr.remote_parent(tr.remote_parent_from_headers(
                {tr.TRACE_ID_HEADER: "abc", tr.PARENT_SPAN_HEADER: "hop"})):
            tr.attach_request_trace(futs[3], t0=6.0, scheduler="s", prompts=2, max_new=4)
        tr.discard_request_trace(futs[1])
        out.append(([None if f.trace is None else f.trace.timeline() for f in futs],
                    [t.trace_id for t in tr.get_trace_buffer().traces()],
                    tr.outbound_trace_headers(futs[3].trace, "next")))
    assert out[1] == out[0]
    assert out[1][0][3]["meta"]["parent_trace"] == "abc"  # force-sampled


def test_export_chrome_trace_lands_in_flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PFX_FLIGHT_DIR", str(tmp_path))
    buf = pt_tr.TraceBuffer(sample=1.0)
    buf.maybe_start("request").event("respond", code=200)
    path = pt_tr.export_chrome_trace(buffer=buf)
    assert path == str(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


def test_replay_decision_log_matches_jax():
    rows = [
        {"admitted": 2, "evicted": 0, "shed": 1, "finished": 0, "spec_proposed": 8,
         "spec_accepted": 3, "prefix_hits": 1, "prefix_hit_tokens": 16, "chunks": 2,
         "tok_admitted": 5, "tenants": {"gold": 2}},
        {"evicted": 1, "preempted": 1, "preempted_tenants": {"anon": 1}, "spills": 2,
         "readmits": 1, "spill_discards": 1, "tok_delivered": 3, "tok_preempt_refunded": 2},
        {},
    ]
    assert pt_tr.replay_decision_log(rows) == jax_tr.replay_decision_log(rows)


def test_span_matches_jax():
    js, ps = jax_tel.Span("request", t0=10.0), pt_tel.Span("request", t0=10.0)
    for s in (js, ps):
        s.mark("decode", t=10.9)
        s.mark("queue_wait", t=10.2)  # injected out of order: slots in by time
        s.mark("respond", t=11.0)
    assert list(ps.phases().items()) == list(js.phases().items())
    assert ps.event(code=200) == js.event(code=200)


def _slo_run(mod, now):
    labels = {}
    slo = mod.SLOTracker(ttft_p99_s=0.5, error_rate=0.1, windows_s=(30.0, 120.0),
                         tenant_label_fn=lambda t: labels.setdefault(t, t))
    seq = [(0.2, True, "gold"), (0.9, True, "gold"), (None, False, "brz"), (0.1, True, None),
           (2.0, True, "brz"), (None, True, "gold"), (0.3, True, "brz")]
    evals = []
    for i, (ttft, ok, tenant) in enumerate(seq):
        slo.observe_request(ttft_s=ttft, ok=ok, t=now - 100.0 + 15.0 * i, tenant=tenant)
        evals.append(slo.evaluate(now=now - 100.0 + 15.0 * i + 1.0))
    evals.append(slo.evaluate(now=now + 500.0))  # every window empty: recovered
    return evals, slo.collect()


def test_slo_tracker_matches_jax():
    now = time.monotonic()
    (jev, jrows), (pev, prows) = _slo_run(jax_tel, now), _slo_run(pt_tel, now)
    assert pev == jev
    assert any(e["breach"] for e in pev) and not pev[-1]["breach"]
    assert sorted(prows, key=repr) == sorted(jrows, key=repr)
    assert {n for n, _, _ in prows} <= set(pt_tel.METRICS)
    off = pt_tel.SLOTracker()
    assert not off.enabled and off.evaluate(now=1.0) == jax_tel.SLOTracker().evaluate(now=1.0)
    for bad in ({"ttft_p99_s": -1}, {"windows_s": ()}, {"windows_s": (0.0,)}):
        with pytest.raises(ValueError):
            pt_tel.SLOTracker(**bad)


def test_check_admin_matches_jax(monkeypatch):
    cases = [({}, ("127.0.0.1", 1)), ({}, ("::ffff:127.0.0.1", 1)), ({}, ("10.1.2.3", 1)),
             ({"Authorization": "Bearer tok"}, ("10.1.2.3", 1)),
             ({"Authorization": "Bearer nope"}, ("127.0.0.1", 1)), ({}, ("::1", 1))]
    for token in ("", "tok"):
        monkeypatch.setenv("PFX_ADMIN_TOKEN", token)
        for headers, addr in cases:
            got = pt_router.check_admin(headers, addr, what="/debug")
            assert got == jax_router.check_admin(headers, addr, what="/debug")
    monkeypatch.setenv("PFX_ADMIN_TOKEN", "tok")
    assert pt_router.check_admin({}, ("127.0.0.1", 1))[1] == 401
    monkeypatch.delenv("PFX_ADMIN_TOKEN")
    assert pt_router.check_admin({}, ("10.1.2.3", 1))[1] == 403
    assert pt_router.admin_token() == jax_router.admin_token() == ""


def test_flight_recorder_ring_dump_and_thread_hook(tmp_path, monkeypatch):
    """The ring keeps the newest events; the dump is a header line and the
    events, as the JAX recorder writes it; the excepthook dumps a crash on
    a worker thread and on the main thread, then chains to the prior
    hooks."""
    monkeypatch.delenv("PFX_FLIGHT_RECORDER", raising=False)
    monkeypatch.setenv("PFX_FLIGHT_DIR", str(tmp_path))
    dumps = []
    for mod in (jax_tel, pt_tel):
        rec = mod.FlightRecorder(capacity=3)
        for i in range(5):
            rec.record({"event": "step", "i": i})
        path = rec.dump(path=str(tmp_path / f"{mod.__name__}.jsonl"), reason="test")
        lines = [json.loads(x) for x in open(path).read().splitlines()]
        dumps.append([(sorted(x), x.get("event"), x.get("i"), x.get("reason"), x.get("events"))
                      for x in lines])
    assert dumps[1] == dumps[0]
    assert [x[2] for x in dumps[1][1:]] == [2, 3, 4]
    assert pt_tel.flight_dir() == str(tmp_path)
    assert pt_tel.get_flight_recorder() is pt_tel.get_flight_recorder()

    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(args.thread.name))
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0].__name__))
    rec = pt_tel.FlightRecorder()
    rec.install_excepthook()
    rec.install_excepthook()  # idempotent: one chain

    def boom():
        raise KeyError("worker died")

    th = threading.Thread(target=boom, name="sched-worker")
    th.start()
    th.join()
    dump = [json.loads(x) for x in (tmp_path / "flight_recorder.jsonl").read_text().splitlines()]
    assert dump[0]["reason"] == "uncaught KeyError in thread sched-worker"
    assert dump[-1]["event"] == "crash" and dump[-1]["thread"] == "sched-worker"
    try:
        raise ValueError("main died")
    except ValueError:
        sys.excepthook(*sys.exc_info())
    dump = [json.loads(x) for x in (tmp_path / "flight_recorder.jsonl").read_text().splitlines()]
    assert dump[0]["reason"] == "uncaught ValueError" and dump[0]["events"] == 2
    assert seen == ["sched-worker", "ValueError"]
    # an unwritable target is logged, never raised (crash paths)
    (tmp_path / "blocker").write_text("")
    assert rec.dump(path=str(tmp_path / "blocker" / "x.jsonl")) is None


# ---------------------------------------------------------------------------
# the decision log against the JAX scheduler
# ---------------------------------------------------------------------------


def _drive(mod, res, eng, script, quantum, ahead, monkeypatch):
    """tests/test_torch_dispatch_ahead.py's drive under the storm fault;
    returns the scheduler."""
    res.reset_fault_state()
    monkeypatch.setenv("PFX_FAULT", STORM)
    sched = mod.ContinuousScheduler(eng, max_depth=16, dispatch_ahead=ahead, quantum=quantum,
                                    preempt_min_tokens=2)
    futs = {}
    try:
        for it in range(400):
            for act in script.get(it, ()):
                if act[0] == "submit":
                    futs[act[1]] = sched.submit([act[2]], act[3], deadline_s=act[4],
                                                tenant="gold" if act[1] == "a" else None)
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
    return sched


@pytest.mark.parametrize("ahead", [True, False])
@pytest.mark.parametrize("quantum", [1, 3])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decision_log_matches_jax(servers, monkeypatch, scenario, quantum, ahead):
    for mod in (jax_tr, pt_tr):
        monkeypatch.setattr(mod, "_buffer", mod.TraceBuffer(sample=1.0))
    opts, script = SCENARIOS[scenario]
    jeng, (peng, _) = _engines(servers, opts)
    want = _drive(jax_cb, jax_res, jeng, script, quantum, ahead, monkeypatch)
    got = _drive(pt_cb, pt_res, peng, script, quantum, ahead, monkeypatch)
    jrows = [{k: v for k, v in r.items() if k != "t"} for r in want.decision_log]
    prows = [{k: v for k, v in r.items() if k != "t"} for r in got.decision_log]
    assert len(prows) == len(jrows) > 0
    for i, (p, j) in enumerate(zip(prows, jrows)):
        assert sorted(p) == sorted(j), i
        for col in j:
            assert p[col] == j[col], (i, col, p, j)
    # the replay reproduces the counters exactly
    rep = pt_tr.replay_decision_log(got.decision_log)
    assert rep["prefill_admits"] == got.stats["prefill_admits"]
    assert rep["evictions"] == got.stats["evictions"]
    assert rep["spec_accepted"] == peng.stats["spec_accepted"]
    assert rep["spec_proposed"] == peng.stats["spec_proposed"]
    assert rep["prefix_hits"] == peng.cache.prefix.stats["hits"]
    assert rep["chunks"] == peng.stats["prefill_chunks"]
    assert rep["preempted"] == got.stats["preemptions"] == 1
    assert rep["tenants"] == got._tenant_admitted
    assert rep["preempted_tenants"] == got._tenant_preempted
    ledger = got.token_ledger()
    assert ledger == want.token_ledger()
    for d in ("admitted", "delivered", "evicted_lost", "preempt_refunded", "shed_after_admit"):
        assert rep[f"tok_{d}"] == ledger[d], d
    assert ledger["in_flight"] == 0 and ledger["preempt_refunded"] >= 1
    assert rep == jax_tr.replay_decision_log(want.decision_log)


def test_scheduler_does_no_tracing_work_when_sampled_out(servers, monkeypatch):
    """At sample 0 futures carry no trace, the decision log stays empty and
    the per-iteration debug publish is skipped until a debug reader asks
    (tests/test_tracing.py's contract)."""
    monkeypatch.setattr(pt_tr, "_buffer", pt_tr.TraceBuffer(sample=0.0))
    eng = pt_cb.PagedDecodeEngine(servers[1], max_batch=4)
    sched = pt_cb.ContinuousScheduler(eng, max_depth=8)
    published = []
    inner = sched._publish_debug
    sched._publish_debug = lambda: (published.append(1), inner())[1]
    fut = sched.submit([PROMPTS[0]], 6, deadline_s=120)
    for _ in range(50):
        if fut.done():
            break
        sched._iterate()
    assert fut.trace is None and len(fut.result(0)[0]) >= 1
    assert list(sched.decision_log) == [] and published == []
    dbg = sched.debug_state()
    assert dbg["scheduler"] == "continuous" and dbg["compiled"]["prefill_families"] >= 1
    fut2 = sched.submit([PROMPTS[2]], 6, deadline_s=120)
    while not fut2.done():
        sched._iterate()
    assert len(published) > 1  # latched: every iteration publishes now


def _redacted(view, prompts):
    """No prompt's token sequence appears anywhere in the view."""
    text = json.dumps(view)
    for p in prompts:
        assert json.dumps(p)[1:-1] not in text
    assert "prompt_ids" not in text


@pytest.mark.parametrize("ahead", [True, False])
def test_debug_state_keys_match_jax(servers, monkeypatch, ahead):
    """Both schedulers' ``debug_state`` has the JAX keys, mid-traffic and
    parked, and never a prompt's tokens; a parked continuous scheduler has
    no step in flight with dispatch-ahead on or off."""
    for mod in (jax_tr, pt_tr):
        monkeypatch.setattr(mod, "_buffer", mod.TraceBuffer(sample=1.0))
    prompts = [[77, 78, 79, 80, 81], [82, 83, 84]]
    opts = {"prefill_chunk": 8, "prefix_cache_blocks": 8}
    jeng, (peng, _) = _engines(servers, opts)
    views = []
    for mod, eng in ((jax_cb, jeng), (pt_cb, peng)):
        sched = mod.ContinuousScheduler(eng, max_depth=8, dispatch_ahead=ahead)
        futs = [sched.submit([p], 6, deadline_s=120) for p in prompts]
        sched._iterate()
        sched._iterate()
        mid = sched.debug_state()
        while not all(f.done() for f in futs):
            sched._iterate()
        views.append((mid, sched.debug_state()))
    (jmid, jend), (pmid, pend) = views
    for j, p in ((jmid, pmid), (jend, pend)):
        assert sorted(p) == sorted(j)
        for key in ("batch", "overlap", "compiled", "goodput", "prefix_cache"):
            assert sorted(p[key]) == sorted(j[key]), key
        if p["batch"]["rows"]:
            assert sorted(p["batch"]["rows"][0]) == sorted(j["batch"]["rows"][0])
        assert p["decisions"] and sorted(p["decisions"][0]) == sorted(j["decisions"][0])
        _redacted(p, prompts)
    assert pmid["batch"]["active_rows"] == jmid["batch"]["active_rows"]
    assert not pend["overlap"]["inflight"] and pend["goodput"]["tokens_in_flight"] == 0
    assert pend["goodput"]["tokens"] == jend["goodput"]["tokens"]
    # the coalescing queue
    qviews = []
    for rq in (jax_rq, pt_rq):
        gate = threading.Event()
        q = rq.RequestQueue(lambda ps, n: (gate.wait(30), [[1] * n for _ in ps])[1],
                            max_depth=4)
        q.start()
        futs = [q.submit([p], 3, deadline_s=60, tenant="gold") for p in prompts]
        time.sleep(0.1)
        qviews.append(q.debug_state())
        gate.set()
        for f in futs:
            f.result(timeout=30)
        q.shutdown(timeout=30)
    assert sorted(qviews[1]) == sorted(qviews[0])
    assert sorted(qviews[1]["waiting"][0]) == sorted(qviews[0]["waiting"][0])
    assert qviews[1]["depth"] == qviews[0]["depth"] == 1
    _redacted(qviews[1], prompts)
