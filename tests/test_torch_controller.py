"""PyTorch port: the elastic control plane (``core/controller.py``) against
the JAX package's on the CPU.

Each scenario runs twice, once over the JAX module (with the JAX
``Registry`` and ``FleetJournal``) and once over the port's, on the same
stub router snapshots, the same injected clocks and the same injected
``spawn_fn``; what the two runs observe must be equal:

  - every decision row (the injected clock included), the decision log's
    bound and :func:`replay_controller_log` over it;
  - the registry's Prometheus text: the ``pfx_controller_*``,
    ``pfx_replica_*`` and ``pfx_router_adopted_replicas_total`` samples
    with the JAX kinds and help text;
  - the supervisor's slot views, the calls made on the router core, the
    spawn commands (warm boot appends ``--compile-cache-dir``), and the
    journal's ``slot`` and ``scale`` records (their wall-clock ``ts``
    aside);
  - the control plane's log lines (the quarantine is loud on both).

The cases are those of tests/test_controller.py and the supervisor and
controller cases of tests/test_fleet_journal.py (re-adoption by the
identity triple against a stub ``/healthz``, the flap-exempt adopted
exit, the ``spawning`` record before the child, the clock restore), each
with the JAX test's own assertions.
"""

import json
import logging
import os
import re
import subprocess
import sys
import time
import types
from contextlib import contextmanager

import pytest
import torch

from paddlefleetx_tpu.core import controller as jax_controller
from paddlefleetx_tpu.core import router as jax_router
from paddlefleetx_tpu.utils import log as jax_log
from paddlefleetx_tpu.utils import telemetry as jax_telemetry
from paddlefleetx_tpu_torch.core import controller as pt_controller
from paddlefleetx_tpu_torch.core import router as pt_router
from paddlefleetx_tpu_torch.utils import log as pt_log
from paddlefleetx_tpu_torch.utils import telemetry as pt_telemetry
from test_controller import FakeProc, StubCore, _pool_view, _view
from test_fleet_journal import StubHealthz

torch.set_num_threads(2)

SIDES = {
    "jax": types.SimpleNamespace(ctl=jax_controller, Registry=jax_telemetry.Registry,
                                 router=jax_router, logger=jax_log.logger),
    "port": types.SimpleNamespace(ctl=pt_controller, Registry=pt_telemetry.Registry,
                                  router=pt_router, logger=pt_log.logger),
}
TEMPLATE = "python serve.py --port {port} --replica-id {replica_id}"


@contextmanager
def _log_lines(logger):
    lines = []

    class Sink(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    sink = Sink()
    logger.addHandler(sink)
    try:
        yield lines
    finally:
        logger.removeHandler(sink)


def both(scenario, tmp_path=None, scrub=None, **kw):
    """Run ``scenario(side, ...)`` over the JAX and the port module; the two
    observations must be equal (log lines included, each passed through
    ``scrub`` when given).  Returns the port's."""
    seen = {}
    for name, side in SIDES.items():
        kwargs = dict(kw)
        if tmp_path is not None:
            kwargs["tmp_path"] = tmp_path / name
            kwargs["tmp_path"].mkdir()
        with _log_lines(side.logger) as lines:
            out = scenario(side, **kwargs)
        out["log"] = [scrub(ln) for ln in lines] if scrub else list(lines)
        seen[name] = out
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _supervisor(S, reg, template=TEMPLATE, **kw):
    kw.setdefault("base_port", 9500)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("spawn_fn", lambda m: FakeProc())
    kw.setdefault("registry", reg)
    return S.ctl.ReplicaSupervisor(template, **kw)


def _controller(S, core, sup, reg, role="monolith", **policy_kw):
    policy_kw.setdefault("min_replicas", 1)
    policy_kw.setdefault("max_replicas", 3)
    policy_kw.setdefault("up_cooldown_s", 5.0)
    policy_kw.setdefault("down_cooldown_s", 60.0)
    policy_kw.setdefault("idle_s", 30.0)
    return S.ctl.ElasticController(core, sup, S.ctl.ScalePolicy(**policy_kw), role=role,
                                   registry=reg)


def _journal_rows(S, path):
    """The journal's records without their wall-clock stamps."""
    records, note = S.router.read_fleet_journal(str(path))
    return [{k: v for k, v in r.items() if k != "ts"} for r in records], note


def books(reg, core=None, ctls=(), sups=()):
    """What a scenario observes at its end."""
    return {"metrics": reg.render_prometheus(),
            "rows": [list(c.decision_log) for c in ctls],
            "targets": [c.target for c in ctls],
            "views": [s.views() for s in sups],
            "added": list(core.added) if core else [],
            "drained": list(core.drained) if core else []}


# ---------------------------------------------------------------------------
# policy validation and the supervisor's template checks: the same loud
# messages
# ---------------------------------------------------------------------------


BAD_POLICIES = [
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
    dict(low_depth=5.0, high_depth=4.0), dict(low_occupancy=0.95, high_occupancy=0.9),
    dict(idle_s=0), dict(up_cooldown_s=-1.0), dict(interval_s=0), dict(low_blocks=-1),
    dict(use_depth=False, use_occupancy=False, low_blocks=0),
]
GOOD_POLICIES = [dict(), dict(low_blocks=8, use_depth=False),
                 dict(use_depth=False, use_occupancy=False, low_blocks=4),
                 dict(use_depth=True, use_occupancy=False)]
BAD_SUPERVISORS = [("python serve.py", dict()), (TEMPLATE, dict(flap_budget=0))]


def _validation(S):
    errors = []
    for kw in BAD_POLICIES:
        with pytest.raises(ValueError) as e:
            S.ctl.ScalePolicy(**kw).validate()
        errors.append(str(e.value))
    views = [S.ctl.ScalePolicy(**kw).validate().view() for kw in GOOD_POLICIES]
    for template, kw in BAD_SUPERVISORS:
        with pytest.raises(ValueError) as e:
            S.ctl.ReplicaSupervisor(template, base_port=9500, max_replicas=2,
                                    registry=S.Registry(), **kw)
        errors.append(str(e.value))
    for needle, err in zip(("min_replicas", "max_replicas", "hysteresis", "hysteresis",
                            "idle_s", "up_cooldown_s", "interval_s", "low_blocks",
                            "load signal", "{port}", "flap_budget"), errors):
        assert needle in err, err
    return {"errors": errors, "views": views}


# ---------------------------------------------------------------------------
# scale-up: breach-driven fast path, watermarks, cooldown, max bound
# ---------------------------------------------------------------------------


def _breach_scale_up(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg)
    ctl = _controller(S, core, sup, reg)
    ctl._register(sup.ensure(ctl.target, now=0.0))
    assert [k for k, _, _ in core.added] == ["r0"]
    core.views = [_view("r0", breach=True)]
    row = ctl.tick(now=10.0)
    assert row["action"] == "scale_up" and "breach" in row["reason"]
    assert ctl.target == 2 and len(core.added) == 2
    assert sup.slots[1].desired and sup.slots[1].key == core.added[1][0]
    return books(reg, core, [ctl], [sup])


def _watermarks(S):
    reg, core = S.Registry(), StubCore()
    ctl = _controller(S, core, _supervisor(S, reg), reg, high_depth=4.0)
    core.views = [_view("r0", depth=3, in_flight=2)]  # avg 5 > 4
    assert ctl.tick(now=10.0)["action"] == "scale_up"
    core2 = StubCore()
    ctl2 = _controller(S, core2, _supervisor(S, reg, base_port=9600), reg)
    core2.views = [_view("r0", occupancy=0.95)]
    row = ctl2.tick(now=10.0)
    assert row["action"] == "scale_up" and "occupancy" in row["reason"]
    return books(reg, core, [ctl, ctl2])


def _cooldown_and_warming(S):
    reg, core = S.Registry(), StubCore()
    ctl = _controller(S, core, _supervisor(S, reg), reg, up_cooldown_s=5.0)
    core.views = [_view("r0", breach=True)]
    assert ctl.tick(now=10.0)["action"] == "scale_up"
    core.views = [_view("r0", breach=True), _view("r1", state="booting")]
    row = ctl.tick(now=10.5)
    assert row["action"] == "hold" and "warming" in row["reason"]
    core.views = [_view("r0", breach=True), _view("r1")]
    row = ctl.tick(now=12.0)
    assert row["action"] == "hold" and "cooldown" in row["reason"]
    assert ctl.tick(now=20.0)["action"] == "scale_up"
    assert ctl.target == 3
    return books(reg, core, [ctl])


def _max_replicas(S):
    reg, core = S.Registry(), StubCore()
    ctl = _controller(S, core, _supervisor(S, reg), reg, max_replicas=1)
    core.views = [_view("r0", breach=True)]
    for t in (10.0, 11.0):  # warned once, held twice
        row = ctl.tick(now=t)
        assert row["action"] == "hold" and "max_replicas" in row["reason"]
    assert ctl.target == 1 and reg.value("pfx_controller_breach") == 1.0
    return books(reg, core, [ctl])


# ---------------------------------------------------------------------------
# scale-down: idle dwell + cooldown hysteresis, min bound, remote drain
# ---------------------------------------------------------------------------


def _idle_scale_down(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg)
    ctl = _controller(S, core, sup, reg, idle_s=30.0, down_cooldown_s=60.0)
    ctl._register(sup.ensure(2, now=0.0))
    ctl.target = 2
    core.views = [_view("r0"), _view("r1")]
    assert ctl.tick(now=10.0)["action"] == "hold"
    assert ctl.tick(now=35.0)["action"] == "hold"
    assert ctl.tick(now=41.0)["action"] == "scale_down"
    assert ctl.target == 1 and core.drained == [sup.slots[1].key]
    assert not sup.slots[1].desired
    core.views = [_view("r0")]
    for t in (120.0, 200.0, 300.0):
        assert ctl.tick(now=t)["action"] == "hold"
    return books(reg, core, [ctl], [sup])


def _no_spawnable_slot(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg, max_replicas=2)
    ctl = _controller(S, core, sup, reg, max_replicas=2, up_cooldown_s=1.0)
    ctl._register(sup.ensure(1, now=0.0))
    sup._slot(1).quarantined = True
    core.views = [_view("r0", breach=True)]
    for t in (10.0, 20.0, 30.0):
        row = ctl.tick(now=t)
        assert row["action"] == "hold" and "no spawnable slot" in row["reason"], row
    assert ctl.target == 1 and reg.value("pfx_controller_scale_ups_total") == 0.0
    replay = S.ctl.replay_controller_log(list(ctl.decision_log))
    assert replay["scale_ups"] == 0 and replay["ticks"] == 3
    return {**books(reg, core, [ctl], [sup]), "replay": replay}


def _total_outage(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg)
    ctl = _controller(S, core, sup, reg, idle_s=5.0, down_cooldown_s=5.0, max_replicas=3)
    ctl._register(sup.ensure(2, now=0.0))
    ctl.target = 2
    core.views = [_view("r0", state="gone"), _view("r1", state="gone")]
    for t in (10.0, 20.0, 40.0, 80.0):
        assert ctl.tick(now=t)["action"] == "hold"
    assert ctl.target == 2 and core.drained == []
    assert all(m.desired for m in sup.slots.values())
    return books(reg, core, [ctl], [sup])


def _traffic_blip(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg)
    ctl = _controller(S, core, sup, reg, idle_s=30.0)
    ctl._register(sup.ensure(2, now=0.0))
    ctl.target = 2
    core.views = [_view("r0"), _view("r1")]
    ctl.tick(now=10.0)
    core.views = [_view("r0", depth=2), _view("r1")]
    assert ctl.tick(now=25.0)["action"] == "hold"
    core.views = [_view("r0"), _view("r1")]
    assert ctl.tick(now=41.0)["action"] == "hold"
    assert ctl.tick(now=72.0)["action"] == "scale_down"
    return books(reg, core, [ctl], [sup])


# ---------------------------------------------------------------------------
# decision log: bounded, replayable to exact counter agreement, journaled
# ---------------------------------------------------------------------------


def _log_replay(S, tmp_path):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg)
    ctl = _controller(S, core, sup, reg, up_cooldown_s=1.0, idle_s=5.0, down_cooldown_s=5.0)
    journal = S.router.FleetJournal(str(tmp_path / "fleet_state.jsonl"))
    ctl.journal = sup.journal = journal
    ctl._register(sup.ensure(ctl.target, now=0.0))
    core.views = [_view("r0", breach=True)]
    ctl.tick(now=10.0)
    core.views = [_view("r0", breach=True), _view("r1")]
    ctl.tick(now=12.0)
    core.views = [_view("r0"), _view("r1"), _view("r2")]
    for dt in (3, 4, 5, 6, 7, 8, 9):
        ctl.tick(now=10.0 + dt)
    replay = S.ctl.replay_controller_log(list(ctl.decision_log))
    assert replay["ticks"] == len(ctl.decision_log) == 9
    assert replay["scale_ups"] == 2 and replay["scale_downs"] >= 1
    assert reg.value("pfx_controller_ticks_total") == replay["ticks"]
    assert reg.value("pfx_controller_scale_ups_total") == replay["scale_ups"]
    assert reg.value("pfx_controller_scale_downs_total") == replay["scale_downs"]
    assert reg.value("pfx_controller_target_replicas") == ctl.target
    records, note = _journal_rows(S, journal.path)
    assert note is None and [r["kind"] for r in records].count("scale") == 9
    state = S.router.replay_fleet_state(records)
    assert state["controller"]["monolith"]["tick"] == 9
    assert set(state["slots"]["monolith"]) == {"0", "1", "2"}
    return {**books(reg, core, [ctl], [sup]), "replay": replay, "journal": records,
            "state": state}


def _bounded_log(S):
    os.environ["PFX_CONTROLLER_LOG_CAP"] = "8"
    try:
        reg, core = S.Registry(), StubCore()
        ctl = _controller(S, core, _supervisor(S, reg), reg)
    finally:
        del os.environ["PFX_CONTROLLER_LOG_CAP"]
    core.views = [_view("r0")]
    for i in range(20):
        ctl.tick(now=float(i))
    assert len(ctl.decision_log) == 8 and ctl.decision_log[-1]["tick"] == 20
    return books(reg, core, [ctl])


def _log_cap_parse(S, raw):
    os.environ["PFX_CONTROLLER_LOG_CAP"] = raw
    try:
        with pytest.raises(ValueError) as e:
            _controller(S, StubCore(), _supervisor(S, S.Registry()), S.Registry())
    finally:
        del os.environ["PFX_CONTROLLER_LOG_CAP"]
    return {"error": str(e.value)}


# ---------------------------------------------------------------------------
# supervisor: spawn, crash-restart backoff, flap quarantine, warm boot
# ---------------------------------------------------------------------------


def _recording_spawn(spawned, rc=None):
    def spawn(m):
        p = FakeProc()
        p.rc = rc
        spawned.append((m.slot, p))
        return p
    return spawn


def _restart_backoff(S):
    reg, spawned = S.Registry(), []
    sup = _supervisor(S, reg, spawn_fn=_recording_spawn(spawned), backoff_base_s=2.0,
                      flap_budget=5)
    sup.ensure(1, now=0.0)
    spawned[0][1].rc = 1
    sup.poll(now=10.0)
    sup.poll(now=11.0)
    assert len(spawned) == 1
    sup.poll(now=12.5)
    assert len(spawned) == 2 and sup.slots[0].restarts == 1
    assert reg.value("pfx_replica_restarts_total", replica="m0") == 1.0
    return books(reg, sups=[sup])


def _quarantine(S):
    reg, spawned = S.Registry(), []
    sup = _supervisor(S, reg, spawn_fn=_recording_spawn(spawned, rc=23), backoff_base_s=0.01,
                      flap_budget=3, flap_window_s=60.0)
    sup.ensure(1, now=0.0)
    t = 1.0
    for _ in range(40):
        sup.poll(now=t)
        t += 1.0
        if sup.slots[0].quarantined:
            break
    m = sup.slots[0]
    assert m.quarantined and m.restarts == 3 and len(spawned) == 4
    assert reg.value("pfx_replica_quarantines_total", replica="m0") == 1.0
    for _ in range(5):
        sup.poll(now=t)
        t += 1.0
    assert len(spawned) == 4
    started = sup.ensure(1, now=t)
    assert [m2.slot for m2 in started] == [1]
    return {**books(reg, sups=[sup]), "desired": sup.desired_count(),
            "quarantined": sup.quarantined_count()}


def _clean_exit_respawn(S):
    reg, spawned = S.Registry(), []
    sup = _supervisor(S, reg, spawn_fn=_recording_spawn(spawned), backoff_base_s=0.5,
                      flap_budget=3, flap_window_s=1e9)
    sup.ensure(1, now=0.0)
    t = 1.0
    for _ in range(6):
        spawned[-1][1].rc = 0
        sup.poll(now=t)
        sup.poll(now=t + 0.6)
        t += 1.0
    m = sup.slots[0]
    assert len(spawned) == 7 and m.restarts == 6 and not m.quarantined
    assert m.restart_times == []
    assert reg.value("pfx_replica_restarts_total", replica="m0") == 6.0
    return books(reg, sups=[sup])


def _expected_exit(S):
    reg, spawned = S.Registry(), []
    sup = _supervisor(S, reg, spawn_fn=_recording_spawn(spawned))
    sup.ensure(1, now=0.0)
    sup.drain_slot(0)
    spawned[0][1].rc = 0
    for t in (1.0, 2.0, 3.0):
        sup.poll(now=t)
    assert len(spawned) == 1 and sup.slots[0].restarts == 0
    return books(reg, sups=[sup])


def _warm_boot(S):
    reg = S.Registry()
    sup = _supervisor(S, reg, base_port=9600, max_replicas=2,
                      compile_cache_dir="/fleet/kernels")
    sup.ensure(2, now=0.0)
    for slot, m in sup.slots.items():
        assert m.cmd[-2:] == ["--compile-cache-dir", "/fleet/kernels"]
        assert f"--port 960{slot}" in " ".join(m.cmd)
        assert f"--replica-id m{slot}" in " ".join(m.cmd)
    return {**books(reg, sups=[sup]),
            "cmds": [m.cmd for _, m in sorted(sup.slots.items())],
            "hash": S.ctl._cmd_hash(sup.slots[0].cmd)}


def _view_shape(S):
    m = S.ctl.ManagedReplica(slot=0, port=9500, url="http://127.0.0.1:9500", cmd=["x"])
    v = m.view()
    assert v["slot"] == 0 and v["pid"] is None and not v["quarantined"]
    return {"view": v}


# ---------------------------------------------------------------------------
# role-aware pool supervision
# ---------------------------------------------------------------------------


def _decode_pool_blocks(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg, slot_prefix="d", role="decode")
    ctl = _controller(S, core, sup, reg, "decode", use_depth=False, low_blocks=4)
    core.views = [_pool_view("r0", "decode", available_blocks=64, depth=50)]
    assert ctl.tick(now=10.0)["action"] == "hold"
    core.views = [_pool_view("r0", "decode", available_blocks=64),
                  _pool_view("r1", "decode", available_blocks=3)]
    row = ctl.tick(now=20.0)
    assert row["action"] == "scale_up" and "available blocks" in row["reason"]
    assert row["min_blocks"] == 3 and row["pool"] == "decode"
    core2 = StubCore()
    ctl2 = _controller(S, core2, _supervisor(S, S.Registry()), reg, "decode", use_depth=False)
    core2.views = [_pool_view("r0", "decode", occupancy=0.95)]
    assert ctl2.tick(now=10.0)["action"] == "scale_up"
    return books(reg, core, [ctl, ctl2], [sup])


def _decode_pool_headroom(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg, slot_prefix="d", role="decode")
    ctl = _controller(S, core, sup, reg, "decode", use_depth=False, low_blocks=4, idle_s=5.0,
                      down_cooldown_s=5.0)
    ctl._register(sup.ensure(2, now=0.0))
    ctl.target = 2
    core.views = [_pool_view("r0", "decode", available_blocks=7),
                  _pool_view("r1", "decode", available_blocks=64)]
    for t in (10.0, 20.0, 40.0):
        assert ctl.tick(now=t)["action"] == "hold"
    core.views = [_pool_view("r0", "decode", available_blocks=60),
                  _pool_view("r1", "decode", available_blocks=64)]
    ctl.tick(now=50.0)
    assert ctl.tick(now=56.0)["action"] == "scale_down"
    return books(reg, core, [ctl], [sup])


def _prefill_pool_signals(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg, slot_prefix="p", role="prefill")
    ctl = _controller(S, core, sup, reg, "prefill", use_occupancy=False, high_depth=4.0)
    core.views = [_pool_view("r0", "prefill", occupancy=1.0)]
    assert ctl.tick(now=10.0)["action"] == "hold"
    core.views = [_pool_view("r0", "prefill", depth=3, in_flight=2)]
    row = ctl.tick(now=20.0)
    assert row["action"] == "scale_up" and "depth" in row["reason"]
    core2 = StubCore()
    ctl2 = _controller(S, core2, _supervisor(S, S.Registry()), reg, "prefill",
                       use_occupancy=False)
    core2.views = [_pool_view("r0", "prefill", breach=True)]
    assert ctl2.tick(now=10.0)["action"] == "scale_up"
    return books(reg, core, [ctl, ctl2], [sup])


def _prefill_pool_without_in_flight(S):
    reg, core = S.Registry(), StubCore()
    sup = _supervisor(S, reg, slot_prefix="p", role="prefill")
    ctl = _controller(S, core, sup, reg, "prefill", use_occupancy=False, high_depth=4.0,
                      count_in_flight=False)
    core.views = [_pool_view("r0", "prefill", depth=0, in_flight=5)]
    assert ctl.tick(now=10.0)["action"] == "hold"
    core.views = [_pool_view("r0", "prefill", depth=5, in_flight=0)]
    assert ctl.tick(now=20.0)["action"] == "scale_up"
    return books(reg, core, [ctl], [sup])


def _pool_counters(S):
    reg, core = S.Registry(), StubCore()
    pre = _controller(S, core, _supervisor(S, reg, slot_prefix="p", role="prefill"), reg,
                      "prefill", use_occupancy=False, up_cooldown_s=1.0)
    dec = _controller(S, core, _supervisor(S, reg, base_port=9700, slot_prefix="d",
                                           role="decode"), reg,
                      "decode", use_depth=False, low_blocks=4, up_cooldown_s=1.0)
    core.views = [_pool_view("r0", "prefill", depth=9),
                  _pool_view("r1", "decode", available_blocks=2)]
    pre.tick(now=10.0)
    dec.tick(now=10.0)
    core.views = [_pool_view("r0", "prefill", depth=9),
                  _pool_view("r2", "prefill", state="booting"),
                  _pool_view("r1", "decode", available_blocks=50),
                  _pool_view("r3", "decode", state="booting")]
    pre.tick(now=11.0)
    dec.tick(now=11.0)
    rows = list(pre.decision_log) + list(dec.decision_log)
    replays = {}
    for pool, ctl in (("prefill", pre), ("decode", dec)):
        replay = replays[pool] = S.ctl.replay_controller_log(rows, pool=pool)
        assert replay["ticks"] == 2 and replay["scale_ups"] == 1
        assert reg.value("pfx_controller_ticks_total", pool=pool) == replay["ticks"]
        assert reg.value("pfx_controller_scale_ups_total", pool=pool) == replay["scale_ups"]
        assert reg.value("pfx_controller_target_replicas", pool=pool) == ctl.target
    assert reg.value("pfx_controller_ticks_total") == 0.0
    return {**books(reg, core, [pre, dec], [pre.supervisor, dec.supervisor]),
            "replays": replays, "all": S.ctl.replay_controller_log(rows)}


def _slot_prefix(S):
    reg = S.Registry()
    sup = _supervisor(S, reg, slot_prefix="d", role="decode")
    sup.ensure(2, now=0.0)
    assert [m.rid for m in sup._snapshot()] == ["d0", "d1"]
    assert sup.views()[0]["replica_id"] == "d0"
    return books(reg, sups=[sup])


SCENARIOS = {
    "scale_policy_and_template_messages": _validation,
    "breach_drives_scale_up_and_registers_replica": _breach_scale_up,
    "depth_and_occupancy_watermarks": _watermarks,
    "up_cooldown_and_warming_bound_scale_rate": _cooldown_and_warming,
    "max_replicas_bounds_scale_up_loudly": _max_replicas,
    "idle_dwell_and_cooldown_gate_scale_down": _idle_scale_down,
    "no_spawnable_slot_keeps_books_honest": _no_spawnable_slot,
    "total_outage_never_scales_down": _total_outage,
    "traffic_blip_resets_idle_dwell": _traffic_blip,
    "decision_log_is_bounded": _bounded_log,
    "supervisor_restarts_crash_with_backoff": _restart_backoff,
    "supervisor_quarantines_within_flap_budget": _quarantine,
    "clean_exit_respawns_without_flap_spend": _clean_exit_respawn,
    "expected_exit_is_not_restarted": _expected_exit,
    "warm_boot_appends_compile_cache_dir": _warm_boot,
    "managed_replica_view_shape": _view_shape,
    "decode_pool_scales_on_available_blocks": _decode_pool_blocks,
    "decode_pool_block_pressure_blocks_scale_down": _decode_pool_headroom,
    "prefill_pool_scales_on_depth_and_breach": _prefill_pool_signals,
    "prefill_pool_depth_without_router_in_flight": _prefill_pool_without_in_flight,
    "pool_controllers_keep_labeled_counters": _pool_counters,
    "supervisor_slot_prefix_names_pool_replicas": _slot_prefix,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_matches_jax(name):
    both(SCENARIOS[name])


def test_decision_log_replays_and_journals_as_jax(tmp_path):
    out = both(_log_replay, tmp_path)
    assert out["replay"]["scale_downs"] >= 1


@pytest.mark.parametrize("raw", ["abc", "0", "-3"])
def test_log_cap_parse_matches_jax(raw):
    assert "PFX_CONTROLLER_LOG_CAP" in both(_log_cap_parse, raw=raw)["error"]


def test_replay_controller_log_matches_jax():
    rows = [{"action": "scale_up", "pool": "prefill"}, {"action": "hold"},
            {"action": "scale_down", "pool": "decode"}, {"action": "scale_up"},
            {"action": "hold", "pool": "decode"}, {}]
    for pool in (None, "monolith", "prefill", "decode"):
        assert pt_controller.replay_controller_log(rows, pool=pool) == \
            jax_controller.replay_controller_log(rows, pool=pool)


# ---------------------------------------------------------------------------
# re-adoption by the identity triple (never a bare pid), the flap-exempt
# adopted exit, the "spawning" record before the child, the clock restore
# ---------------------------------------------------------------------------


ADOPTIONS = {
    # (live identity, journaled facts, adopted slots, slot 0 quarantined)
    "full_triple": ({"replica_id": "m0", "pid": os.getpid(), "boot_id": "live-boot"},
                    {"0": {"pid": os.getpid(), "boot_id": "live-boot", "rid": "m0",
                           "cmd_hash": "x"}, "1": {}}, [0], False),
    "wrong_boot_id": ({"replica_id": "m0", "pid": os.getpid(), "boot_id": "new-incarnation"},
                      {"0": {"pid": os.getpid(), "boot_id": "journaled-boot", "rid": "m0",
                             "cmd_hash": "x"}}, [], True),
    "wrong_replica_id": ({"replica_id": "imposter", "pid": os.getpid(), "boot_id": "b"},
                         {"0": {}}, [], True),
    "empty_fact_matches_replica_id": ({"replica_id": "m0", "pid": 777, "boot_id": "b"},
                                      {"0": {}}, [0], False),
}


def _adopt(S, tmp_path, stub, facts):
    reg = S.Registry()
    sup = _supervisor(S, reg, base_port=stub.port, max_replicas=2)
    sup.journal = S.router.FleetJournal(str(tmp_path / "fleet_state.jsonl"))
    adopted = [m.slot for m in sup.adopt(facts)]
    m = sup.slots[0]
    slot0 = (m.desired, m.quarantined, m.adopted_pid, m.adopted_boot_id, m.proc, m.restarts,
             m.flap_exempt)
    sup.poll(now=100.0)  # a live adopted pid: nothing to do; a dead one: a flap-exempt respawn
    return {**books(reg, sups=[sup]), "adopted": adopted, "slot0": slot0,
            "journal": _journal_rows(S, sup.journal.path)}


@pytest.mark.parametrize("case", sorted(ADOPTIONS))
def test_adopt_by_identity_triple_matches_jax(case, tmp_path):
    identity, facts, want_adopted, quarantined = ADOPTIONS[case]
    stub = StubHealthz(identity)
    try:
        out = both(_adopt, tmp_path, stub=stub, facts=facts)
    finally:
        stub.stop()
    assert out["adopted"] == want_adopted
    assert out["slot0"][1] == quarantined
    if want_adopted:
        assert out["slot0"][2] == identity["pid"] and out["slot0"][5] == 0
        assert out["journal"][0][-1]["phase"] == "adopted"
        assert 'pfx_router_adopted_replicas_total{replica="m0"} 1' in out["metrics"]
    if quarantined:
        assert any("QUARANTINE" in ln for ln in out["log"])


def _dead_pid():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def _adopt_silent_port(S, port, pid):
    sup = _supervisor(S, S.Registry(), base_port=port, max_replicas=2)
    assert sup.adopt({"0": {"pid": pid, "cmd_hash": "notourhash", "rid": "m0"}}) == []
    m = sup.slots[0]
    assert not m.quarantined and not m.desired and m.adopted_pid is None
    return {"views": sup.views()}


def _reap_corpse(S, port):
    """Nothing answers on the slot's port, but the journaled pid is alive
    and its /proc cmdline hashes to the slot's spawn command: the corpse
    is SIGKILLed; a live pid whose command hashes otherwise is left."""
    ours = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    other = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(61)"])
    try:
        argv = [sys.executable, "-c", "import time; time.sleep(60)"]
        deadline = time.time() + 10
        while S.ctl._proc_cmd_hash(ours.pid) != S.ctl._cmd_hash(argv):
            assert time.time() < deadline, "the child never exec'd"
            time.sleep(0.01)
        sup = _supervisor(S, S.Registry(), base_port=port, max_replicas=2)
        facts = {"0": {"pid": ours.pid, "cmd_hash": S.ctl._cmd_hash(argv), "rid": "m0"},
                 "1": {"pid": other.pid, "cmd_hash": S.ctl._cmd_hash(argv), "rid": "m1"}}
        assert sup.adopt(facts) == []
        assert ours.wait(timeout=10) == -9  # reaped
        assert other.poll() is None and S.ctl._pid_alive(other.pid)  # not ours: left
        return {"views": [{k: v for k, v in m.items() if k != "port" and k != "url"}
                          for m in sup.views()], "rc": ours.returncode}
    finally:
        for p in (ours, other):
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)


def _adopted_exit(S, pid):
    sup = _supervisor(S, S.Registry(), base_port=19999, max_replicas=2)
    m = sup._slot(0)
    m.desired, m.adopted_pid, m.adopted_boot_id = True, pid, "gone-boot"
    sup.poll(now=1000.0)
    assert m.adopted_pid is None and m.flap_exempt
    assert m.next_restart_t == 1000.0 + sup.backoff_base_s
    m2 = sup._slot(1)
    m2.desired, m2.adopted_pid = False, pid
    sup.poll(now=1000.0)
    assert m2.adopted_pid is None and not m2.flap_exempt
    # the respawn spends no flap budget
    sup.poll(now=1001.0)
    assert m.restarts == 1 and m.restart_times == []
    return {"views": sup.views(), "next": m.next_restart_t}


def test_adopt_silent_port_and_adopted_exit_match_jax():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    pid = _dead_pid()
    both(_adopt_silent_port, port=dead_port, pid=pid)
    out = both(_reap_corpse, port=dead_port,
               scrub=lambda ln: re.sub(r"pid \d+", "pid <child>", ln))  # each side's own child
    assert out["rc"] == -9 and not any(v["desired"] or v["quarantined"] for v in out["views"])
    out = both(_adopted_exit, pid=pid)
    assert out["views"][0]["restarts"] == 1 and not out["views"][0]["quarantined"]


def _spawning_first(S, tmp_path):
    j = S.router.FleetJournal(str(tmp_path / "fleet_state.jsonl"))
    seen_at_spawn = []

    def spawn_fn(m):
        seen_at_spawn.append(_journal_rows(S, j.path)[0])
        return FakeProc()

    sup = _supervisor(S, S.Registry(), spawn_fn=spawn_fn, max_replicas=1)
    sup.journal = j
    sup.ensure(1)
    (at_spawn,) = seen_at_spawn
    assert [r["phase"] for r in at_spawn] == ["spawning"] and at_spawn[0]["pid"] is None
    assert at_spawn[0]["cmd_hash"] == S.ctl._cmd_hash(sup.slots[0].cmd)
    records, _ = _journal_rows(S, j.path)
    assert [r["phase"] for r in records] == ["spawning", "spawned"]
    return {"at_spawn": at_spawn, "records": records,
            "state": S.router.replay_fleet_state(records)}


def test_spawning_record_lands_before_the_child_as_jax(tmp_path):
    out = both(_spawning_first, tmp_path)
    assert out["state"]["slots"]["monolith"]["0"]["pid"] == 4242


class _StubCore:
    def replica_views(self):
        return []

    def add_replica(self, url, role="monolith"):
        return "r0"


def _restore(S):
    reg = S.Registry()
    sup = _supervisor(S, reg, spawn_fn=lambda m: None)
    ctl = S.ctl.ElasticController(
        _StubCore(), sup,
        S.ctl.ScalePolicy(min_replicas=1, max_replicas=3, up_cooldown_s=30.0,
                          down_cooldown_s=60.0, idle_s=30.0), registry=reg)
    ctl.restore_clocks(target=2, tick=17, up_age_s=5.0, scale_age_s=5.0, extra_age_s=2.0)
    now = time.monotonic()
    assert ctl.target == 2 and ctl._seq == 17 and ctl._idle_since is None
    ages = (round(now - ctl._last_up_t), round(now - ctl._last_scale_t))
    assert ages == (7, 7)
    st = ctl.journal_state()
    assert st["target"] == 2 and st["tick"] == 17 and st["idle_for_s"] is None
    st = {k: (round(v) if isinstance(v, float) else v) for k, v in st.items()}
    ctl.restore_clocks(target=99, tick=3)
    clamped = (ctl.target, ctl._seq)
    assert clamped == (3, 17)
    ctl.restore_clocks(target="x", tick=None, up_age_s="y")  # bad values are skipped
    return {"ages": ages, "state": st, "clamped": clamped, "target": ctl.target,
            "metrics": reg.render_prometheus(),
            "log": None}


def test_restore_clocks_matches_jax():
    seen = {}
    for name, side in SIDES.items():
        with _log_lines(side.logger) as lines:
            seen[name] = _restore(side)
        # the log line names the death window, which the wall clock moves
        seen[name]["log"] = [ln.split(", death window")[0] for ln in lines]
    assert seen["port"] == seen["jax"]


def test_real_subprocess_lifecycle_matches_jax():
    """One real child on each side: spawn, SIGKILL -> crash seen -> restart,
    ``stop_all`` tears down cleanly (pids are the children's own)."""
    seen = {}
    for name, side in SIDES.items():
        reg = side.Registry()
        sup = side.ctl.ReplicaSupervisor(
            f"{sys.executable} -c 'import time; time.sleep({{port}})'",
            base_port=300, max_replicas=1, backoff_base_s=0.05, registry=reg)
        try:
            sup.ensure(1)
            m = sup.slots[0]
            assert m.proc.poll() is None
            m.proc.kill()
            m.proc.wait(timeout=10)
            deadline = time.time() + 10
            while m.restarts == 0 and time.time() < deadline:
                sup.poll()
                time.sleep(0.02)
            assert m.restarts == 1 and m.proc is not None and m.proc.poll() is None
        finally:
            sup.stop_all(timeout=10)
        assert all(s.proc is None for s in sup.slots.values())
        views = [{k: v for k, v in view.items() if k != "pid"} for view in sup.views()]
        seen[name] = {"views": views, "metrics": reg.render_prometheus()}
    assert seen["port"] == seen["jax"]
    assert seen["port"]["views"][0]["last_exit_rc"] == -9


# ---------------------------------------------------------------------------
# warm boot: --compile-cache-dir names the kernel-library directory
# ---------------------------------------------------------------------------


def test_build_dir_builds_each_library_once(tmp_path, monkeypatch):
    """``use_build_dir`` moves where the kernel libraries are built and
    loaded; a second build into the filled directory starts no compiler,
    and moving the directory after a library loaded raises."""
    from paddlefleetx_tpu_torch.ops import _build

    calls = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\necho "$@" >> ' + str(calls) + '\n'
                    'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILT", [])
    fleet = tmp_path / "fleet-kernels"
    assert _build.use_build_dir(fleet) == fleet.resolve() == _build.BUILD_DIR
    names = ("decode_attention_sm90", "paged_attention_sm90")
    with _log_lines(pt_log.logger) as lines:
        paths = _build.build(names)
    assert all(p.parent == fleet.resolve() and p.exists() for p in paths.values())
    assert _build.BUILT == list(names) and len(calls.read_text().splitlines()) == 2
    assert [ln.split(" -> ")[0] for ln in lines] == [f"kernel build: nvcc {n}.cu" for n in names]
    _build.BUILT.clear()  # a second replica spawned into the same directory
    with _log_lines(pt_log.logger) as lines:
        assert _build.build(names) == paths
    assert _build.BUILT == [] and len(calls.read_text().splitlines()) == 2 and lines == []
    _build._LIBS["decode_attention_sm90"] = object()
    assert _build.use_build_dir(fleet) == fleet.resolve()  # the same place: fine
    with pytest.raises(RuntimeError, match="already loaded from"):
        _build.use_build_dir(tmp_path / "elsewhere")


_WARM_BOOT = r"""
import json, sys
from paddlefleetx_tpu_torch.data import _build as host
from paddlefleetx_tpu_torch.ops import _build as kernels
from paddlefleetx_tpu_torch.tools import serve
assert serve.main(["-c", sys.argv[1], "--device", "cpu", "--compile-cache-dir", sys.argv[2]]) == 0
host.load_bpe()
print(json.dumps({"kernels": str(kernels.BUILD_DIR), "host": str(host.BUILD_ROOT),
                  "built": host.BUILT + kernels.BUILT}))
"""


def test_serve_cli_compile_cache_dir_is_a_warm_boot(tmp_path):
    """The serve CLI's ``--compile-cache-dir`` (what the supervisor appends
    to every spawn) is where its libraries build and load: the first
    process builds, the next one spawned into the directory only loads."""
    from test_torch_router import write_config

    cfg, cache = write_config(tmp_path), tmp_path / "fleet-cache"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), OMP_NUM_THREADS="2")
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _WARM_BOOT, cfg, str(cache)], env=env,
                             stdin=subprocess.DEVNULL, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        runs[-1]["logged"] = "host library build: g++ bpe.cpp" in out.stdout + out.stderr
    assert runs[0]["kernels"] == runs[0]["host"] == str(cache.resolve())
    assert runs[0]["built"] == ["bpe"] and runs[1]["built"] == []
    assert runs[0]["logged"] and not runs[1]["logged"]
    assert list((cache / "bpe").glob("bpe-*.so"))
