"""PyTorch port: the continuous scheduler's goodput ledgers on the CPU, the
contracts of tests/test_goodput.py, held against the JAX scheduler.

  - the time ledger's six buckets (the JAX bucket names) close against the
    scheduler thread's wall within 1%, with dispatch-ahead on and off, and
    the collector's families mirror the accessor;
  - the token ledger closes exactly (admitted == delivered + evicted_lost
    + preempt_refunded + shed_after_admit + in flight) under a seeded mix
    of a mid-decode eviction, a partial-admission expiry, a forced
    preemption, deadline sheds, streaming and a random tail, and the
    decision log's replay folds every disposition to the same totals;
    driven one iteration at a time beside the JAX scheduler, the books
    equal the JAX books at every step of the script;
  - the per-tenant slot and KV-block seconds accrue under the request's
    tenant, in the collector and in ``debug_state``.

The model is the TINY serving config of tests/test_kv_tier.py on the
weights tests/test_torch_dispatch_ahead.py shares with the JAX server.
"""

import time

import numpy as np
import pytest

from paddlefleetx_tpu.core import continuous_batching as jax_cb
from paddlefleetx_tpu.core import request_queue as jax_rq
from paddlefleetx_tpu.utils import resilience as jax_res
from paddlefleetx_tpu_torch.core import continuous_batching as pt_cb
from paddlefleetx_tpu_torch.core.request_queue import DeadlineExceeded
from paddlefleetx_tpu_torch.utils import resilience as pt_res
from paddlefleetx_tpu_torch.utils.tracing import replay_decision_log
from test_torch_dispatch_ahead import BLK, PROMPTS, servers  # noqa: F401 — a fixture

BUCKETS = {"device_decode", "device_prefill", "host_sched", "readback", "stream_flush", "idle"}
TERMINAL = ("delivered", "evicted_lost", "preempt_refunded", "shed_after_admit")


def _assert_time_closure(ledger, max_drift=0.01):
    assert set(ledger["buckets"]) == BUCKETS, ledger
    assert all(v >= 0.0 for v in ledger["buckets"].values()), ledger
    wall = ledger["wall_s"]
    assert wall > 0.0, ledger
    drift = abs(sum(ledger["buckets"].values()) - wall)
    assert drift <= max(max_drift * wall, 1e-6), (drift, ledger)


def _assert_token_closure(ledger):
    assert ledger["admitted"] == sum(ledger[d] for d in TERMINAL) + ledger["in_flight"], ledger


@pytest.mark.parametrize("ahead", [True, False])
def test_time_ledger_buckets_close_against_wall(servers, ahead):
    """A served batch: the buckets close within 1% of the wall, decode
    work lands in the device and readback buckets, and the collector's
    families mirror the accessor; the bucket names are the JAX ones."""
    jsched = jax_cb.ContinuousScheduler(jax_cb.PagedDecodeEngine(servers[0], max_batch=4))
    assert set(jsched.time_ledger()["buckets"]) == BUCKETS
    eng = pt_cb.PagedDecodeEngine(servers[1], max_batch=4, block=BLK)
    sched = pt_cb.ContinuousScheduler(eng, max_depth=16, dispatch_ahead=ahead)
    sched.warmup([4])
    sched.start()
    futs = [sched.submit([p], 6, deadline_s=120) for p in PROMPTS]
    assert all(len(f.result(timeout=300)[0]) >= 1 for f in futs)
    assert sched.shutdown(timeout=60)
    tl = sched.time_ledger()
    _assert_time_closure(tl)
    assert tl["buckets"]["device_decode"] > 0.0 and tl["buckets"]["readback"] > 0.0, tl
    assert tl["buckets"]["device_prefill"] > 0.0 and tl["buckets"]["idle"] > 0.0, tl
    mets = {(n, frozenset(lab.items())): v for n, lab, v in sched.collect()}
    for b, v in tl["buckets"].items():
        assert mets[("pfx_sched_time_seconds_total", frozenset({("bucket", b)}))] == \
            pytest.approx(v, abs=2e-6)
    assert mets[("pfx_sched_wall_seconds_total", frozenset())] == pytest.approx(
        tl["wall_s"], abs=2e-6)
    assert mets[("pfx_sched_host_gap_seconds_total", frozenset())] == pytest.approx(
        eng.stats["host_gap_s"], abs=2e-6)
    assert mets[("pfx_token_ledger_in_flight", frozenset())] == 0.0
    # the JAX scheduler exports the same ledger families
    ledger = {"pfx_sched_time_seconds_total", "pfx_sched_wall_seconds_total",
              "pfx_sched_host_gap_seconds_total", "pfx_token_ledger_total",
              "pfx_token_ledger_in_flight"}
    assert {n for n, _, _ in jsched.collect()} & ledger == ledger
    assert {n for n, _ in mets} & ledger == ledger


@pytest.mark.parametrize("seed", [3, 11])
def test_token_ledger_exact_closure_seeded_mix(servers, monkeypatch, seed):
    """tests/test_goodput.py's closure property on the port: a true
    mid-decode eviction, a partial-admission expiry, a forced preemption,
    a queue-level shed, streaming and a seeded tail; the books close
    exactly, every disposition exercised, the replay folds to the same
    totals and the time books close within 1%."""
    pt_res.reset_fault_state()
    eng = pt_cb.PagedDecodeEngine(servers[1], max_batch=4, block=BLK)
    sched = pt_cb.ContinuousScheduler(eng, max_depth=32, preempt_min_tokens=2)
    doomed = sched.submit([PROMPTS[1]], 64, deadline_s=60)
    sched._iterate()
    assert eng.active_rows() == 1
    next(r for r in eng.slots if r is not None).entry.deadline = time.monotonic() - 1.0
    sched._iterate()
    assert sched.stats["evictions"] == 1
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=10)
    assert sched.token_ledger()["evicted_lost"] >= 1
    _assert_token_closure(sched.token_ledger())
    rng = np.random.default_rng(seed)
    over = [rng.integers(1, 90, int(n)).tolist() for n in rng.integers(2, 8, eng.capacity + 2)]
    partial = sched.submit(over, 64, deadline_s=60)
    sched._iterate()
    entry = next(r for r in eng.slots if r is not None).entry
    assert entry.next_row < len(entry.prompts), "not partially admitted"
    entry.deadline = time.monotonic() - 1.0
    sched._iterate()
    with pytest.raises(DeadlineExceeded):
        partial.result(timeout=10)
    assert sched.token_ledger()["shed_after_admit"] >= 1
    _assert_token_closure(sched.token_ledger())

    monkeypatch.setenv("PFX_FAULT", f"preempt_storm:{sched._iter_counter + 5}")
    pt_res.reset_fault_state()
    streams = {i: [] for i in range(len(PROMPTS))}
    # queued before the thread starts, the four fill the batch at its first
    # iteration; the tail comes after the storm's forced preemption (a
    # waiting arrival of equal priority would turn the fire into no-op)
    futs = [sched.submit([p], 6, deadline_s=120,
                         stream=(lambda i: lambda r, s, t: streams[i].append((s, list(t))))(i))
            for i, p in enumerate(PROMPTS)]
    sched.start()
    t0 = time.monotonic()
    while sched.stats["preemptions"] < 1 and time.monotonic() - t0 < 60:
        time.sleep(0.001)
    tail = [sched.submit([rng.integers(1, 90, int(rng.integers(1, 12))).tolist()],
                         int(rng.integers(1, 8)), deadline_s=120) for _ in range(6)]
    outs = [f.result(timeout=300)[0] for f in futs]
    tail_outs = [f.result(timeout=300)[0] for f in tail]
    monkeypatch.delenv("PFX_FAULT")
    pt_res.reset_fault_state()
    assert sched.stats["preemptions"] == 1
    late = sched.submit([PROMPTS[0]], 4, deadline_s=0.00001)
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=30)
    assert sched.shutdown(timeout=60)

    ledger = sched.token_ledger()
    assert ledger["in_flight"] == 0
    _assert_token_closure(ledger)
    for d in TERMINAL:
        assert ledger[d] >= 1, (d, ledger)
    assert ledger["delivered"] == sum(len(o) for o in outs) + sum(len(o) for o in tail_outs)
    for i in range(len(PROMPTS)):
        acc = []
        for start, toks in streams[i]:
            assert start == len(acc), f"row {i}: hole or overlap at {start}"
            acc.extend(toks)
        assert acc == outs[i]
    replay = replay_decision_log(sched.decision_log)
    assert replay["tok_admitted"] == ledger["admitted"]
    for d in TERMINAL:
        assert replay[f"tok_{d}"] == ledger[d], (d, replay, ledger)
    _assert_time_closure(sched.time_ledger())


def _books(mod, res, eng, monkeypatch, seed):
    """A script driven one iteration at a time: an eviction, a partial
    expiry and a storm preemption; the token books after every step."""
    res.reset_fault_state()
    sched = mod.ContinuousScheduler(eng, max_depth=32, preempt_min_tokens=2,
                                    dispatch_ahead=True)
    books = []
    doomed = sched.submit([PROMPTS[1]], 64, deadline_s=60)
    sched._iterate()
    sched._iterate()
    next(r for r in eng.slots if r is not None).entry.deadline = time.monotonic() - 1.0
    sched._iterate()
    books.append(sched.token_ledger())
    rng = np.random.default_rng(seed)
    over = [rng.integers(1, 90, int(n)).tolist() for n in rng.integers(2, 8, eng.capacity + 2)]
    partial = sched.submit(over, 64, deadline_s=60)
    sched._iterate()
    sched._iterate()
    next(r for r in eng.slots if r is not None).entry.deadline = time.monotonic() - 1.0
    sched._iterate()
    books.append(sched.token_ledger())
    monkeypatch.setenv("PFX_FAULT", f"preempt_storm:{sched._iter_counter + 5}")
    res.reset_fault_state()
    futs = [sched.submit([p], 6, deadline_s=120) for p in PROMPTS]
    try:
        for _ in range(200):
            if all(f.done() for f in futs):
                break
            sched._iterate()
            books.append(sched.token_ledger())
    finally:
        monkeypatch.delenv("PFX_FAULT")
        res.reset_fault_state()
    for f in (doomed, partial):
        with pytest.raises((DeadlineExceeded, jax_rq.DeadlineExceeded)):
            f.result(0)
    assert sched.stats["preemptions"] == 1
    return books, [f.result(0)[0] for f in futs], replay_decision_log(sched.decision_log)


def test_token_ledger_matches_jax(servers, monkeypatch):
    """The same script on both schedulers: equal books after every step,
    equal answers and equal replays."""
    jeng = jax_cb.PagedDecodeEngine(servers[0], block=BLK)
    peng = pt_cb.PagedDecodeEngine(servers[1], max_batch=jeng.capacity, block=BLK)
    want = _books(jax_cb, jax_res, jeng, monkeypatch, 3)
    got = _books(pt_cb, pt_res, peng, monkeypatch, 3)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    final = got[0][-1]
    assert final["in_flight"] == 0 and all(final[d] >= 1 for d in TERMINAL), final


def test_tenant_occupancy_books_accrue(servers):
    """Slot seconds and KV-block seconds accrue under the request's tenant
    label, in the collector and in the debug view's goodput block."""
    eng = pt_cb.PagedDecodeEngine(servers[1], max_batch=4, block=BLK)
    sched = pt_cb.ContinuousScheduler(eng, max_depth=16)
    sched.start()
    futs = [sched.submit([p], 6, deadline_s=120, tenant="acme") for p in PROMPTS[:2]]
    for f in futs:
        f.result(timeout=300)
    assert sched.shutdown(timeout=60)
    rows = sched.collect()
    occ = {lab["tenant"]: v for n, lab, v in rows if n == "pfx_tenant_slot_seconds_total"}
    kv = {lab["tenant"]: v for n, lab, v in rows if n == "pfx_tenant_kv_block_seconds_total"}
    assert occ.get("acme", 0.0) > 0.0 and kv.get("acme", 0.0) >= occ["acme"], (occ, kv)
    ten = sched.debug_state()["goodput"]["tenant_occupancy"]
    assert ten["acme"]["slot_s"] > 0.0 and ten["acme"]["kv_block_s"] > 0.0
