"""PyTorch port: the serve CLI's operations surface on ``--device cpu``,
the drills of tests/test_serve_drills.py and tests/test_goodput.py.

  - ``/debug/state``, ``/debug/trace?id=`` and ``/debug/traces`` behind
    ``PFX_ADMIN_TOKEN`` (401 without it; the 403 of a remote client with
    no token is ``check_admin``'s, held against the JAX rule in
    tests/test_torch_tracing.py);
  - ``/admin/profile`` answers with the op table (``source`` cpu), 409
    while a capture runs, 400 past ``PFX_PROFILE_MAX_SECONDS``;
    ``/admin/adopt_prefixes`` stays 501; ``/admin/drain`` answers, the
    server exits 0 and the flight dump on disk holds the drain;
  - ``/metrics`` parses with the JAX parser and agrees with ``/healthz``;
    its goodput ledgers close (the time buckets within 1% of the wall,
    the tokens exactly);
  - ``gen_crash`` answers 500 and the server keeps serving; ``gen_hang``
    trips the watchdog (``/healthz`` degraded, a flight dump), a waiting
    request is shed, and the server recovers; ``cb_step_hang`` breaches
    the TTFT SLO, which recovers once the windows pass; ``boot_crash``
    exits 23;
  - the stdin REPL (``--port 0``) answers ids as the in-process server
    does.

Servers write their output to a file, never a pipe read only at exit.
The model is the TINY serving config of tests/test_kv_tier.py.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
import yaml

from paddlefleetx_tpu.utils import telemetry as jax_tel
from paddlefleetx_tpu_torch.tools.serve import build_server
from test_torch_dispatch_ahead import BLK, PORT_SECTIONS, TINY
from test_torch_tenancy import _free_port, _request
from test_tracing import validate_chrome_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "drill-token"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
PROMPT = [1, 2, 3, 4, 5]


def _config(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({k: TINY[k] for k in PORT_SECTIONS}))
    return str(path)


def _env(tmp_path, extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", PFX_KV_BLOCK=str(BLK),
               PFX_FLIGHT_DIR=str(tmp_path / "flight"))
    for k in ("PFX_FAULT", "PFX_ADMIN_TOKEN", "PFX_TRACE_SAMPLE", "PFX_FLIGHT_RECORDER"):
        env.pop(k, None)
    env.update(extra or {})
    return env


class _Server:
    def __init__(self, tmp_path, args, env_extra=None):
        self.port = _free_port()
        self.log = tmp_path / f"serve_{self.port}.log"
        self.fh = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c",
             _config(tmp_path), "--port", str(self.port), "--device", "cpu", *args],
            env=_env(tmp_path, env_extra), cwd=REPO, stdout=self.fh,
            stderr=subprocess.STDOUT, text=True)

    def output(self):
        return self.log.read_text()

    def wait_healthy(self):
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                return self.get("/healthz")[1]
            except OSError:
                assert self.proc.poll() is None, f"server died: {self.output()[-3000:]}"
                time.sleep(0.2)
        raise AssertionError(f"never healthy: {self.output()[-3000:]}")

    def call(self, path, body=None, headers=None, timeout=60):
        """(status, parsed body); an HTTP error status is returned."""
        try:
            status, _, text = _request(self.port, path, body, headers, timeout=timeout)
        except urllib.error.HTTPError as e:
            status, text = e.code, e.read().decode()
        try:
            return status, json.loads(text)
        except ValueError:
            return status, text

    def get(self, path, headers=None):
        return self.call(path, None, headers)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.fh.close()
        return self.proc.returncode


def _metrics(srv):
    status, _, text = _request(srv.port, "/metrics")
    rows = jax_tel.parse_exposition(text)
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in rows}


def _flight(tmp_path):
    path = tmp_path / "flight" / "flight_recorder.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_debug_admin_metrics_and_drain_continuous(tmp_path):
    srv = _Server(tmp_path, ["--scheduler", "continuous", "--cb-batch", "4"],
                  {"PFX_ADMIN_TOKEN": TOKEN, "PFX_FAULT": "gen_crash:1",
                   "PFX_PROFILE_MAX_SECONDS": "3"})
    try:
        srv.wait_healthy()
        # gen_crash: the first admission fails with a 500, the server serves on
        status, body = srv.call("/generate", {"prompt_ids": PROMPT, "max_tokens": 6})
        assert status == 500 and "injected gen_crash at request 1" in body["error"]
        status, body = srv.call("/generate", {"prompt_ids": PROMPT, "max_tokens": 6})
        assert status == 200 and len(body["completion_ids"]) == 6, body
        tid = body["trace_id"]
        # /debug/* behind the token
        assert srv.get("/debug/state")[0] == 401
        assert srv.get("/debug/state", {"Authorization": "Bearer nope"})[0] == 401
        status, dbg = srv.get("/debug/state", AUTH)
        assert status == 200 and dbg["scheduler"] == "continuous"
        for key in ("waiting", "batch", "arena", "overlap", "compiled", "goodput", "decisions",
                    "flags", "trace_buffer", "metrics", "serving"):
            assert key in dbg, key
        assert dbg["trace_buffer"]["sample"] == 1.0 and dbg["decisions"]
        assert json.dumps(PROMPT)[1:-1] not in json.dumps(dbg)  # no prompt contents
        status, tl = srv.get(f"/debug/trace?id={tid}", AUTH)
        names = [e["name"] for e in tl["events"]]
        assert status == 200 and tl["done"] and names.count("decode_chunk") == 6
        assert {"admission", "queue_wait", "prefill", "respond"} <= set(names), names
        assert srv.get("/debug/trace", AUTH)[0] == 400
        assert srv.get("/debug/trace?id=nope", AUTH)[0] == 404
        assert srv.get("/debug/nope", AUTH)[0] == 404
        status, doc = srv.get("/debug/traces", AUTH)
        assert status == 200 and len(validate_chrome_trace(doc)) >= 2

        # /admin/profile under traffic: the op table; 409 while it runs;
        # 400 past the cap; no token -> 401
        stop = threading.Event()

        def load():
            while not stop.is_set():
                srv.call("/generate", {"prompt_ids": PROMPT, "max_tokens": 8})

        loader = threading.Thread(target=load)
        loader.start()
        first = {}
        prof = threading.Thread(target=lambda: first.update(
            zip(("status", "body"), srv.call("/admin/profile", {"seconds": 1.0, "top": 5},
                                             AUTH))))
        try:
            prof.start()
            time.sleep(0.4)
            busy = srv.call("/admin/profile", {"seconds": 0.5}, AUTH)
            prof.join(timeout=60)
        finally:
            stop.set()
            loader.join(timeout=60)
        assert busy[0] == 409 and "already active" in busy[1]["error"]
        summ = first["body"]
        assert first["status"] == 200 and summ["source"] == "cpu", summ
        assert summ["op_count"] > 0 and len(summ["top_ops"]) == 5 and summ["host_us"] > 0
        assert os.path.isfile(os.path.join(summ["trace_dir"], "profile_summary.json"))
        assert srv.call("/admin/profile", {"seconds": 5}, AUTH)[0] == 400
        assert srv.call("/admin/profile", {"seconds": 0.1})[0] == 401
        assert srv.call("/admin/adopt_prefixes", {}, AUTH)[0] == 501
        assert srv.call("/admin/nope", {}, AUTH)[0] == 404

        # /metrics parses and agrees with /healthz; the ledgers close
        health = srv.get("/healthz")[1]
        got = _metrics(srv)
        assert health["queue"]["completed"] == got[("pfx_queue_completed_total", ())] >= 2
        assert health["queue"]["gen_errors"] == got[("pfx_queue_gen_errors_total", ())] == 1
        assert health["serving"]["requests"] == got[("pfx_serving_requests_total", ())]
        assert health["counters"]["http_500"] == got[
            ("pfx_http_responses_total", (("code", "500"),))] == 1
        assert got[("pfx_request_queue_wait_seconds_count", ())] >= 2
        assert got[("pfx_request_decode_seconds_count", ())] >= 2
        assert got[("pfx_profiler_traces_total", ())] == 1
        assert got[("pfx_trace_sampled_total", ())] >= 2
        buckets = {dict(lab)["bucket"]: v for (n, lab), v in got.items()
                   if n == "pfx_sched_time_seconds_total"}
        wall = got[("pfx_sched_wall_seconds_total", ())]
        assert abs(sum(buckets.values()) - wall) <= 0.01 * wall + 1e-5, (buckets, wall)
        toks = {dict(lab)["disposition"]: v for (n, lab), v in got.items()
                if n == "pfx_token_ledger_total"}
        assert got[("pfx_token_ledger_in_flight", ())] == 0
        assert toks["admitted"] == toks["delivered"] > 0 and toks["evicted_lost"] == 0

        # /admin/drain: answered, drained, exit 0, the drain in the dump
        status, body = srv.call("/admin/drain", {}, AUTH)
        assert status == 200 and body["state"] == "draining"
        assert srv.proc.wait(timeout=60) == 0
        assert "drained cleanly" in srv.output()
        kinds = [e["event"] for e in _flight(tmp_path)]
        assert kinds[0] == "flight_recorder_dump" and "drain_start" in kinds
        assert "drain_done" in kinds and "span" in kinds and "profile_capture" in kinds
    finally:
        srv.stop()


def test_slo_breach_on_cb_step_hang_recovers(tmp_path):
    """A step hang carries a request's TTFT past the objective on every
    window: /healthz and /metrics report the breach; once the windows pass,
    a quick request leaves it recovered."""
    srv = _Server(tmp_path, ["--scheduler", "continuous", "--cb-batch", "2", "--slo-ttft-p99",
                             "0.8", "--slo-windows", "1,2.5"],
                  {"PFX_FAULT": "cb_step_hang:2", "PFX_FAULT_HANG_S": "1.5"})
    try:
        health = srv.wait_healthy()
        assert health["slo"]["enabled"] and not health["slo"]["breach"]
        status, _ = srv.call("/generate", {"prompt_ids": PROMPT, "max_tokens": 4})
        assert status == 200
        health = srv.get("/healthz")[1]
        assert health["slo"]["breach"] and "ttft_p99" in health["slo"]["reason"], health["slo"]
        got = _metrics(srv)
        assert got[("pfx_slo_breach", (("objective", "ttft_p99"),))] == 1.0
        assert got[("pfx_slo_burn_rate", (("objective", "ttft_p99"), ("window", "1s")))] == 100.0
        time.sleep(2.7)
        assert srv.call("/generate", {"prompt_ids": PROMPT, "max_tokens": 4})[0] == 200
        health = srv.get("/healthz")[1]
        assert not health["slo"]["breach"] and health["slo"]["burn"]["ttft_p99"]["1s"] == 0.0
        assert "PFX_FAULT: firing cb_step_hang at step 2" in srv.output()
    finally:
        srv.stop()


def test_gen_hang_trips_the_watchdog_and_sheds(tmp_path):
    """A wedged generation flips /healthz to degraded (a flight dump while
    it is live), a request waiting behind it is shed with 503, and the
    watchdog recovers once the generation ends."""
    srv = _Server(tmp_path, ["--no-warmup", "--watchdog", "1"],
                  {"PFX_FAULT": "gen_hang:1", "PFX_FAULT_HANG_S": "4"})
    try:
        srv.wait_healthy()
        first = {}
        th = threading.Thread(target=lambda: first.update(
            zip(("status", "body"), srv.call("/generate", {"prompt_ids": PROMPT,
                                                           "max_tokens": 4}))))
        th.start()
        deadline = time.time() + 10
        health = srv.get("/healthz")[1]
        while health["state"] != "degraded" and time.time() < deadline:
            time.sleep(0.1)
            health = srv.get("/healthz")[1]
        assert health["state"] == "degraded" and health["ok"] is False, health
        assert _metrics(srv)[("pfx_serve_degraded", ())] == 1.0
        status, body = srv.call("/generate", {"prompt_ids": [7, 8], "max_tokens": 2,
                                              "deadline_s": 0.2})
        assert status == 503, body
        th.join(timeout=30)
        assert first["status"] == 200 and len(first["body"]["completion_ids"]) == 4
        deadline = time.time() + 10
        while srv.get("/healthz")[1]["state"] != "ok" and time.time() < deadline:
            time.sleep(0.1)
        health = srv.get("/healthz")[1]
        assert health["state"] == "ok" and health["ok"], health
        assert "WATCHDOG: generation wedged" in srv.output()
        assert "WATCHDOG: generation recovered" in srv.output()
        dump = _flight(tmp_path)
        assert any(e.get("event") == "watchdog_degraded" for e in dump)
    finally:
        srv.stop()


def test_boot_crash_exits_23(tmp_path):
    srv = _Server(tmp_path, [], {"PFX_FAULT": "boot_crash:0"})
    try:
        assert srv.proc.wait(timeout=120) == 23
        assert "PFX_FAULT: firing boot_crash at step 0" in srv.output()
    finally:
        srv.stop()


def test_repl_answers_ids(tmp_path):
    """``--port 0``: one prompt a line; an injected gen_crash and a bad line
    report and the session goes on; the answer is the in-process one."""
    cfg = _config(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", cfg, "--device",
         "cpu"], input="1 2 3\n1 2 3\nbad\n\n", env=_env(tmp_path, {"PFX_FAULT": "gen_crash:1"}),
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    # the answers, without the logger's colored lines
    lines = [x for x in out.stdout.replace("prompt> ", "\n").splitlines()
             if x.strip() and not x.startswith("\x1b[")]
    assert lines[0] == "generation failed (RuntimeError): PFX_FAULT: injected gen_crash at " \
                       "request 1", lines
    assert lines[2].startswith("error: invalid literal"), lines
    torch.manual_seed(0)
    want = build_server(cfg, [], "cpu").generate_ids([[1, 2, 3]])[0]
    assert lines[1] == " ".join(map(str, want)), (lines, want)


@pytest.mark.parametrize("site", ["gen_crash", "gen_hang", "cb_step_hang", "boot_crash"])
def test_serving_sites_are_wired(monkeypatch, site):
    from paddlefleetx_tpu_torch.utils import resilience as pt_res

    monkeypatch.setenv("PFX_FAULT", f"{site}:3")
    assert pt_res.serving_fault_spec() == (site, 3, 1)
