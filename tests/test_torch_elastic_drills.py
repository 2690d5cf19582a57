"""PyTorch port: the elastic control plane's drills through the real CLIs
on ``--device cpu`` (the drills of tests/test_elastic_drills.py and the
router re-adoption drill of tests/test_ha_drills.py).

  remote drain   ``POST /admin/drain`` on a port replica with
                 ``PFX_ADMIN_TOKEN`` set: 401 without the token (and
                 ``/debug/*`` too), the drain and exit 0 with it.
  crash loop     a replica that can never boot (``PFX_FAULT=boot_crash:0``)
                 is restarted with backoff, then quarantined loudly within
                 the flap budget; the decision log replays to the
                 ``pfx_controller_*`` counters.
  SIGKILL        a managed replica killed under flood is restarted and
                 re-admitted (same slot, new pid); every response an honest
                 200 or 503, none hangs.
  scale          a flood past one replica's queue burns its error-rate SLO:
                 breach, scale-up, recovery; then idleness scales the fleet
                 back down through the token-gated remote drain (the
                 drained replica exits 0), and ``tools/report.py --fleet``
                 renders the router's fleet log with both scale events.
  pools          ``--prefill-cmd`` / ``--decode-cmd``: one supervised
                 prefill and one decode replica answer the in-process
                 server's tokens disaggregated, each pool with its labeled
                 counters and its replay.
  re-adoption    SIGKILL the supervising router and restart it on the same
                 ports and flight directory: the live replicas are adopted
                 with their pids, no restart spent.
  cross-package  the JAX ``tools/router.py --supervise --compile-cache-dir``
                 over a port serve template.

Every child's output goes to a file (the router's through the harness of
tests/test_torch_router.py, each replica's to its own log under the
router's ``--replica-log-dir``); every wait is bounded.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from paddlefleetx_tpu_torch.core.controller import replay_controller_log
from test_torch_router import (
    BODIES,
    REPO,
    Proc,
    metric,
    metrics,
    reference_tokens,
    replica,
    write_config,
)
from test_torch_tenancy import _free_port

pytestmark = pytest.mark.fault

TOKEN = "fleet-secret"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
BODY = {"prompt_ids": [1, 2, 3], "max_tokens": 6, "deadline_s": 60}


def _req(port, path, data=None, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if data is None else json.dumps(data).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait(predicate, timeout, what, proc=None):
    end = time.time() + timeout
    last = None
    while time.time() < end:
        if proc is not None:
            assert proc.proc.poll() is None, f"{proc.name} died:\n{proc.output()[-3000:]}"
        try:
            last = predicate()
            if last:
                return last
        except (OSError, ValueError, KeyError) as e:  # listener still booting
            last = e
        time.sleep(0.2)
    raise AssertionError(f"timeout waiting for {what}: {last!r}")


def serve_template(cfg, *extra):
    """A port serve command template for the supervisor ({port} and
    {replica_id} stay placeholders)."""
    return " ".join([sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", cfg,
                     "--port", "{port}", "--replica-id", "{replica_id}", "--device", "cpu",
                     "--warmup-buckets", "8", "--deadline", "60", *extra])


def supervised_router(tmp_path, name, *args, port=None, env_extra=None, jax=False):
    """The port's (or the JAX package's) router with --supervise, its
    replica logs under ``tmp_path/replica-logs``."""
    entry = ([os.path.join(REPO, "tools", "router.py")] if jax
             else ["-m", "paddlefleetx_tpu_torch.tools.router"])
    proc = Proc(tmp_path, name, lambda p: [
        *entry, "--port", str(port or p), "--poll-interval", "0.2", "--supervise",
        "--replica-log-dir", str(tmp_path / "replica-logs"), "--control-interval", "0.5",
        *args], env_extra)
    if port is not None:
        proc.port = port
    return proc


def replay_agrees(port, headers=None, pool=None):
    """The decision log and /metrics, read until no tick lands between
    the reads: the log replays to the pfx_controller_* counters exactly."""
    labels = {"pool": pool} if pool else {}
    for _ in range(20):
        _, dbg = _req(port, "/debug/controller", headers=headers)
        m = metrics(port)
        _, dbg2 = _req(port, "/debug/controller", headers=headers)
        rows = dbg["pools"][pool]["decisions"] if pool else dbg["decisions"]
        rows2 = dbg2["pools"][pool]["decisions"] if pool else dbg2["decisions"]
        if len(rows) != len(rows2):
            continue
        replay = replay_controller_log(rows, pool=pool)
        assert metric(m, "pfx_controller_ticks_total", **labels) == replay["ticks"] > 0
        assert metric(m, "pfx_controller_scale_ups_total", **labels) == replay["scale_ups"]
        assert metric(m, "pfx_controller_scale_downs_total", **labels) == replay["scale_downs"]
        return replay
    raise AssertionError("the controller never held still between two reads")


def finish(router, timeout=60):
    """SIGTERM the router (it drains its managed replicas) and return its
    exit code after checking its log for tracebacks."""
    rc = router.stop(timeout=timeout)
    assert "Traceback" not in router.output(), router.output()[-3000:]
    return rc


def replica_log(tmp_path, rid):
    return (tmp_path / "replica-logs" / f"{rid}.log").read_text()


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def test_remote_drain_is_authenticated(tmp_path):
    cfg = write_config(tmp_path)
    rep = replica(tmp_path, cfg, "m0", env_extra={"PFX_ADMIN_TOKEN": TOKEN})
    try:
        _wait(lambda: _req(rep.port, "/healthz")[1].get("ok"), 120, "replica healthy", rep)
        code, body = _req(rep.port, "/debug/state")
        assert code == 401 and "PFX_ADMIN_TOKEN" in body["error"], body
        assert _req(rep.port, "/debug/state", headers=AUTH)[0] == 200
        assert _req(rep.port, "/admin/drain", data={})[0] == 401
        assert _req(rep.port, "/admin/drain", data={},
                    headers={"Authorization": "Bearer wrong"})[0] == 401
        assert _req(rep.port, "/healthz")[1]["state"] == "ok"
        assert _req(rep.port, "/generate", data=BODY)[0] == 200
        code, body = _req(rep.port, "/admin/drain", data={}, headers=AUTH)
        assert code == 200 and body["state"] == "draining", body
        assert rep.proc.wait(timeout=60) == 0
    finally:
        rep.stop()
    assert "drained cleanly" in rep.output() and "Traceback" not in rep.output()


def test_crash_loop_is_quarantined_loudly(tmp_path):
    cfg = write_config(tmp_path)
    router = supervised_router(
        tmp_path, "router", "--replica-cmd", serve_template(cfg), "--base-port",
        str(_free_port()), "--min-replicas", "1", "--max-replicas", "1", "--flap-budget", "3",
        "--flap-window", "300", "--restart-backoff", "0.2",
        env_extra={"PFX_FAULT": "boot_crash:0"})
    try:
        quar = _wait(lambda: _req(router.port, "/healthz")[1]["controller"]["quarantined"],
                     90, "quarantine", router)
        assert quar == 1
        slot = _req(router.port, "/debug/controller")[1]["replicas"][0]
        assert slot["quarantined"] and not slot["restart_pending"], slot
        assert slot["restarts"] == 3 and slot["last_exit_rc"] == 23, slot
        m = metrics(router.port)
        assert metric(m, "pfx_replica_quarantines_total", replica="m0") == 1.0
        assert metric(m, "pfx_replica_restarts_total", replica="m0") == 3.0
        assert _req(router.port, "/healthz")[1]["eligible"] == 0
        replay = replay_agrees(router.port)
        assert replay["scale_ups"] == replay["scale_downs"] == 0
        assert "boot_crash" in replica_log(tmp_path, "m0")
    finally:
        rc = finish(router)
    assert rc == 0 and "QUARANTINE" in router.output()


def test_sigkill_under_flood_restarts_and_readmits(tmp_path):
    cfg = write_config(tmp_path)
    (want,) = reference_tokens(cfg, [BODY])
    router = supervised_router(
        tmp_path, "router", "--replica-cmd", serve_template(cfg, "--queue-depth", "32"),
        "--base-port", str(_free_port()), "--min-replicas", "2", "--max-replicas", "2",
        "--restart-backoff", "0.2")
    stop = threading.Event()
    codes, lock, threads = [], threading.Lock(), []
    try:
        _wait(lambda: _req(router.port, "/healthz")[1]["eligible"] >= 2, 90,
              "two supervised replicas serving", router)
        pids = {v["key"]: v["pid"] for v in _req(router.port, "/replicas")[1]["replicas"]}
        assert len(set(pids.values())) == 2

        def flood():
            while not stop.is_set():
                c, _ = _req(router.port, "/generate", data=BODY, timeout=90)
                with lock:
                    codes.append(c)

        threads = [threading.Thread(target=flood) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        os.kill(pids["r0"], signal.SIGKILL)

        def readmitted():
            v = {v["key"]: v for v in _req(router.port, "/replicas")[1]["replicas"]}["r0"]
            return v["state"] == "serving" and v["pid"] not in (None, pids["r0"])

        _wait(readmitted, 90, "the killed replica restarted and readmitted", router)
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    try:
        assert not any(t.is_alive() for t in threads), "a request hung through the kill"
        assert codes and set(codes) <= {200, 503} and 200 in codes, codes
        for _ in range(3):
            code, out = _req(router.port, "/generate", data=BODY)
            assert code == 200 and out["completion_ids"] == want, out
        m = metrics(router.port)
        assert metric(m, "pfx_replica_restarts_total", replica="m0") >= 1.0
        assert not any(n == "pfx_replica_quarantines_total" for n, _ in m)
    finally:
        assert finish(router) == 0


def test_breach_scale_up_recovery_then_idle_scale_down(tmp_path):
    """With the fleet token set: the breach scales up, the burn recovers,
    idleness scales down through the authenticated remote drain; the
    fleet report marks both scale events."""
    cfg = write_config(tmp_path)
    router = supervised_router(
        tmp_path, "router", "--replica-cmd",
        serve_template(cfg, "--queue-depth", "1", "--slo-error-rate", "0.05",
                       "--slo-windows", "2,6"),
        "--base-port", str(_free_port()), "--min-replicas", "1", "--max-replicas", "2",
        "--scale-up-cooldown", "2", "--scale-idle", "1", "--scale-down-cooldown", "2",
        env_extra={"PFX_ADMIN_TOKEN": TOKEN})
    stop = threading.Event()
    codes, lock, threads = [], threading.Lock(), []
    try:
        _wait(lambda: _req(router.port, "/healthz")[1]["eligible"] >= 1, 90,
              "the first replica serving", router)
        assert _req(router.port, "/debug/controller")[0] == 401  # the gate holds
        assert _req(router.port, "/generate", data=BODY)[0] == 200

        def flood():
            while not stop.is_set():
                c, _ = _req(router.port, "/generate", data=BODY, timeout=90)
                with lock:
                    codes.append(c)

        threads = [threading.Thread(target=flood) for _ in range(4)]
        for t in threads:
            t.start()

        def scaled_up():
            ups = [d for d in _req(router.port, "/debug/controller", headers=AUTH)[1]
                   ["decisions"] if d["action"] == "scale_up"]
            return ups if ups and _req(router.port, "/healthz")[1]["eligible"] >= 2 else None

        ups = _wait(scaled_up, 90, "a breach-driven scale-up", router)
        assert ups[0]["breach"] and "breach" in ups[0]["reason"], ups
        with lock:
            assert 429 in codes, "the flood never overflowed the queue"

        def recovered():
            vs = [v for v in _req(router.port, "/replicas")[1]["replicas"]
                  if v["state"] == "serving"]
            return len(vs) >= 2 and not any(v["slo_breach"] for v in vs)

        _wait(recovered, 60, "the burn recovering after the scale-up", router)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    try:
        assert not any(t.is_alive() for t in threads), "a request hung through the drill"

        def scaled_down():
            dbg = _req(router.port, "/debug/controller", headers=AUTH)[1]
            slot = {v["slot"]: v for v in dbg["replicas"]}[1]
            downs = [d for d in dbg["decisions"] if d["action"] == "scale_down"]
            return downs if downs and slot["last_exit_rc"] == 0 and not slot["desired"] else None

        downs = _wait(scaled_down, 60, "an idle scale-down whose replica exits 0", router)
        assert "idle" in downs[0]["reason"] and downs[0]["target"] == 1
        assert "drained cleanly" in replica_log(tmp_path, "m1")
        replay = replay_agrees(router.port, headers=AUTH)
        assert replay["scale_ups"] == 1 and replay["scale_downs"] == 1
        assert metric(metrics(router.port), "pfx_controller_target_replicas") == 1.0
        # the scale-event mirror feeds the fleet log (once a second)
        fleet_log = tmp_path / "flight" / "fleet_metrics.jsonl"
        _wait(lambda: fleet_log.read_text().count('"event": "scale"') >= 2, 15,
              "both scale events in the fleet log")
    finally:
        assert finish(router) == 0
    out = tmp_path / "fleet.html"
    rep = subprocess.run([sys.executable, os.path.join(REPO, "tools", "report.py"), "--fleet",
                          str(fleet_log), "-o", str(out)], capture_output=True, text=True,
                         timeout=60)
    assert rep.returncode == 0, rep.stderr
    doc = out.read_text()
    assert "Scale events" in doc and "scale_up" in doc and "scale_down" in doc
    assert "slo burn-rate breach" in doc and "TTFT p99" in doc


def test_supervised_pools_route_disaggregated(tmp_path):
    cfg = write_config(tmp_path)
    want = reference_tokens(cfg, BODIES)
    pre_port, dec_port = _free_port(), _free_port()
    router = supervised_router(
        tmp_path, "router",
        "--prefill-cmd", serve_template(cfg, "--role", "prefill"),
        "--decode-cmd", serve_template(cfg, "--role", "decode", "--cb-batch", "4"),
        "--min-prefill", "1", "--max-prefill", "1", "--min-decode", "1", "--max-decode", "1",
        "--prefill-base-port", str(pre_port), "--decode-base-port", str(dec_port),
        "--handoff", "direct")
    try:
        h = _wait(lambda: (lambda h: h if h["eligible"] >= 2 else None)(
            _req(router.port, "/healthz")[1]), 90, "both pools serving", router)
        assert h["mode"] == "disaggregated" and set(h["controller"]["pools"]) == \
            {"prefill", "decode"}
        for body, tokens in zip(BODIES, want):
            code, out = _req(router.port, "/generate", data=body)
            assert code == 200 and out["completion_ids"] == tokens, out
        views = {v["replica_id"]: v for v in _req(router.port, "/replicas")[1]["replicas"]}
        assert {k: v["role"] for k, v in views.items()} == {"p0": "prefill", "d0": "decode"}
        assert views["p0"]["url"].endswith(str(pre_port))
        dbg = _req(router.port, "/debug/controller")[1]["pools"]
        assert dbg["prefill"]["policy"]["use_occupancy"] is False
        assert dbg["prefill"]["policy"]["count_in_flight"] is False  # --handoff direct
        assert dbg["decode"]["policy"]["use_depth"] is False
        m = metrics(dec_port)
        assert metric(m, "pfx_handoff_adopts_total") == len(BODIES)
        for pool in ("prefill", "decode"):
            replay_agrees(router.port, pool=pool)
    finally:
        assert finish(router) == 0
    for rid in ("p0", "d0"):
        assert "drained cleanly" in replica_log(tmp_path, rid)


def test_router_sigkill_readopts_the_fleet(tmp_path):
    cfg = write_config(tmp_path)
    (want,) = reference_tokens(cfg, [BODY])
    rport, bport = _free_port(), _free_port()
    args = ("--replica-cmd", serve_template(cfg), "--base-port", str(bport),
            "--min-replicas", "2", "--max-replicas", "2")
    router = supervised_router(tmp_path, "router", *args, port=rport)
    router2 = None
    try:
        _wait(lambda: _req(rport, "/healthz")[1]["eligible"] >= 2, 90,
              "two supervised replicas serving", router)
        pids = {v["key"]: v["pid"] for v in _req(rport, "/replicas")[1]["replicas"]}
        assert len(pids) == 2 and all(isinstance(p, int) for p in pids.values())
        router.proc.kill()
        router.proc.wait(timeout=30)
        assert all(_pid_alive(p) for p in pids.values())  # the fleet outlives its router
        router2 = supervised_router(tmp_path, "router2", *args, port=rport)

        def readopted():
            vs = {v["key"]: v for v in _req(rport, "/replicas")[1]["replicas"]}
            return vs if set(vs) == set(pids) and all(
                v["state"] == "serving" for v in vs.values()) else None

        vs = _wait(readopted, 60, "both replicas re-adopted and serving", router2)
        assert {k: v["pid"] for k, v in vs.items()} == pids
        code, out = _req(rport, "/generate", data=BODY)
        assert code == 200 and out["completion_ids"] == want
        m = metrics(rport)
        assert metric(m, "pfx_router_recoveries_total") == 1.0
        for rid in ("m0", "m1"):
            assert metric(m, "pfx_router_adopted_replicas_total", replica=rid) == 1.0
        assert not any(n in ("pfx_replica_restarts_total", "pfx_replica_quarantines_total")
                       for n, _ in m)
        assert "recovery: re-adopted 2 live replica(s)" in router2.output()
    finally:
        router.stop()
        if router2 is not None:
            assert finish(router2) == 0  # SIGTERMs the adopted replicas
    assert not any(_pid_alive(p) for p in pids.values())


def test_jax_router_supervises_port_replicas(tmp_path):
    """The JAX package's router, unmodified, supervises a port serve
    template and hands every spawn ``--compile-cache-dir``: the port
    replica takes it as its kernel-library directory."""
    cfg = write_config(tmp_path)
    (want,) = reference_tokens(cfg, [BODY])
    kdir = tmp_path / "kernels"
    router = supervised_router(
        tmp_path, "jax_router", "--replica-cmd", serve_template(cfg), "--base-port",
        str(_free_port()), "--min-replicas", "1", "--max-replicas", "1",
        "--compile-cache-dir", str(kdir), jax=True,
        env_extra={"JAX_PLATFORMS": "cpu", "PFX_PLATFORM": "cpu"})
    try:
        _wait(lambda: _req(router.port, "/healthz")[1]["eligible"] >= 1, 120,
              "the port replica serving behind the JAX router", router)
        code, out = _req(router.port, "/generate", data=BODY)
        assert code == 200 and out["completion_ids"] == want, out
        (view,) = _req(router.port, "/debug/controller")[1]["replicas"]
        assert view["replica_id"] == "m0" and view["restarts"] == 0
        with open(f"/proc/{view['pid']}/cmdline", "rb") as f:
            argv = f.read().split(b"\0")
        assert b"paddlefleetx_tpu_torch.tools.serve" in argv
        assert argv[-3:-1] == [b"--compile-cache-dir", str(kdir).encode()]
    finally:
        assert finish(router) == 0
    assert "drained cleanly" in replica_log(tmp_path, "m0")
