"""PyTorch port: the router core and the router CLI, against the JAX
package on the CPU.

  - ``RouterCore._score``, ``_affinity`` and ``pick`` on scripted replica
    views, ``replay_fleet_state`` on the same journal records and
    ``FleetFederation.ingest`` / ``collect`` on the same exposition give
    the JAX module's results;
  - the port's ``tools/router.py`` over two port ``--device cpu``
    monolith replicas answers the tokens of the in-process server, and
    refuses ``--supervise`` (the elastic controller is not ported);
  - the JAX package's ``tools/router.py``, unmodified, in front of a port
    prefill and a port decode replica answers the same tokens: the HTTP
    contract is the JAX one.

The fleet harness here (replicas and routers as subprocesses, their
output to files, each wait bounded) also serves
tests/test_torch_disagg_drills.py.  The model is the TINY serving config
of tests/test_disagg_drills.py (float32, greedy).
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch
import yaml

from paddlefleetx_tpu.core import paged_cache as jax_pc
from paddlefleetx_tpu.core import router as jax_router
from paddlefleetx_tpu_torch.core import paged_cache as pt_pc
from paddlefleetx_tpu_torch.core import router as pt_router
from paddlefleetx_tpu_torch.tools.serve import build_server
from test_torch_tenancy import _free_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_disagg_drills.py TINY
TINY = {
    "Global": {"global_batch_size": 8, "seed": 11},
    "Engine": {"mix_precision": {"enable": False}, "save_load": {"save_steps": 0}},
    "Model": {"module": "GPTModule", "vocab_size": 96, "hidden_size": 32, "num_layers": 2,
              "num_attention_heads": 4, "max_position_embeddings": 64, "dtype": "float32"},
    "Generation": {"max_dec_len": 8, "decode_strategy": "greedy_search", "pad_to_multiple": 8,
                   "eos_token_id": 95, "pad_token_id": 0},
}
# a shared "system prompt": 34 tokens = 2 full KV blocks of 16 and a
# 2-token tail, so a second request maps shared blocks and a COW copy
SYS = list(range(1, 35))
BODIES = [{"prompt_ids": SYS + [40, 41, 42], "max_tokens": 6, "deadline_s": 60},
          {"prompt_ids": SYS + [50, 51], "max_tokens": 6, "deadline_s": 60},
          {"prompt_ids": [7, 8, 9, 10, 11], "max_tokens": 6, "deadline_s": 60}]


# ---------------------------------------------------------------------------
# the fleet harness
# ---------------------------------------------------------------------------


def write_config(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(TINY))
    return str(path)


def reference_tokens(cfg_path, bodies):
    """Each body's greedy tokens from the in-process port server on the
    same seeded weights (the continuous and coalescing paths agree)."""
    srv = build_server(cfg_path, [], "cpu")
    return [srv.generate_ids([b["prompt_ids"]], max_dec_len=b["max_tokens"])[0]
            for b in bodies]


def _env(tmp_path, extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               PFX_FLIGHT_DIR=str(tmp_path / "flight"))
    for k in ("PFX_FAULT", "PFX_ADMIN_TOKEN", "PFX_KV_BLOCK", "PFX_TRACE_SAMPLE",
              "PFX_FLIGHT_RECORDER"):
        env.pop(k, None)
    env.update(extra or {})
    return env


class Proc:
    """One subprocess with its output in a file (never a pipe read at
    exit)."""

    def __init__(self, tmp_path, name, argv, env_extra=None):
        self.port = _free_port()
        self.name = name
        self.log = tmp_path / f"{name}_{self.port}.log"
        self.fh = open(self.log, "w")
        self.proc = subprocess.Popen([sys.executable, *argv(self.port)],
                                     env=_env(tmp_path, env_extra), cwd=REPO, stdout=self.fh,
                                     stderr=subprocess.STDOUT, text=True)

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def output(self):
        return self.log.read_text()

    def stop(self, timeout=60):
        """SIGTERM (the drain) and the exit code; kills past the timeout."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self.fh.close()
        return self.proc.returncode


def replica(tmp_path, cfg_path, name, *args, env_extra=None):
    return Proc(tmp_path, name, lambda port: [
        "-m", "paddlefleetx_tpu_torch.tools.serve", "-c", cfg_path, "--port", str(port),
        "--device", "cpu", "--queue-depth", "32", "--deadline", "60", "--warmup-buckets", "8",
        "--replica-id", name, *args], env_extra)


def port_router(tmp_path, name, *args):
    return Proc(tmp_path, name, lambda port: [
        "-m", "paddlefleetx_tpu_torch.tools.router", "--port", str(port), "--poll-interval",
        "0.2", "--eject-after", "3", *args])


def get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.load(r)


def post(port, body, path="/generate", timeout=90):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def metrics(port):
    """``/metrics`` parsed with the JAX parser: {(name, labels): value}."""
    from paddlefleetx_tpu.utils.telemetry import parse_exposition

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        rows = parse_exposition(r.read().decode())
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in rows}


def metric(m, name, **labels):
    return m.get((name, tuple(sorted((k, str(v)) for k, v in labels.items()))), 0.0)


def wait_healthy(procs, timeout=120):
    end = time.time() + timeout
    pending = list(procs)
    while pending and time.time() < end:
        for p in list(pending):
            assert p.proc.poll() is None, f"{p.name} died at boot:\n{p.output()[-3000:]}"
            try:
                if get(p.port, "/healthz", timeout=5).get("ok"):
                    pending.remove(p)
            except (OSError, ValueError):
                pass
        time.sleep(0.2)
    assert not pending, f"never healthy: {[p.name for p in pending]}"


def wait_eligible(router, n, timeout=60):
    end = time.time() + timeout
    h = {}
    while time.time() < end:
        assert router.proc.poll() is None, f"router died:\n{router.output()[-3000:]}"
        try:
            h = get(router.port, "/healthz")
        except (OSError, ValueError):
            h = {}
        if h.get("eligible", 0) >= n:
            return h
        time.sleep(0.2)
    raise AssertionError(f"router never saw {n} eligible replicas: {h}")


def stop_all(procs):
    """Stop every process; returns their exit codes and asserts no log
    holds a traceback."""
    codes = {p.name: p.stop() for p in procs}
    for p in procs:
        assert "Traceback" not in p.output(), f"{p.name}:\n{p.output()[-3000:]}"
    return codes


# ---------------------------------------------------------------------------
# the router core against the JAX module
# ---------------------------------------------------------------------------


MONO = [  # (role, depth, in_flight, last_latency_s, busy_s, occupancy, available_blocks)
    ("monolith", 5, 0, 0.05, 0.0, 0.0, None),
    ("monolith", 1, 1, 2.0, 3.0, 0.0, None),
    ("monolith", 3, 0, 0.01, 0.0, 0.0, None),
]
DISAGG = [
    ("prefill", 2, 0, 0.05, 0.0, 0.0, None),
    ("decode", 1, 0, 0.05, 0.0, 0.95, 2),
    ("decode", 1, 0, 0.05, 0.0, 0.10, 60),
    ("decode", 0, 0, 0.05, 0.0, 0.5, 0),
]


def _scripted(mod, views):
    core = mod.RouterCore([(f"http://127.0.0.1:{9000 + i}", v[0]) for i, v in enumerate(views)])
    for r, v in zip(core.replicas.values(), views):
        (_, r.depth, r.in_flight, r.last_latency_s, r.busy_s, r.occupancy,
         r.available_blocks) = v
        r.state, r.healthy = "serving", True
    # r1 advertises the first two blocks of SYS, r2 the first only
    full = pt_pc.prefix_digest_hashes(SYS, 16)
    core.replicas["r1"].prefix_hashes, core.replicas["r1"].prefix_block = frozenset(full[:2]), 16
    core.replicas["r2"].prefix_hashes, core.replicas["r2"].prefix_block = frozenset(full[:1]), 16
    return core


@pytest.mark.parametrize("views", [MONO, DISAGG], ids=["replicated", "disaggregated"])
def test_router_scoring_matches_jax(views):
    assert pt_pc.prefix_digest_hashes(SYS, 16) == jax_pc.prefix_digest_hashes(SYS, 16)
    got, want = _scripted(pt_router, views), _scripted(jax_router, views)
    for remaining in (0.5, 5.0, 60.0):
        for key in got.replicas:
            for aff in (0.0, 1.0, 50.0):
                assert got._score(got.replicas[key], remaining, affinity=aff) == \
                    want._score(want.replicas[key], remaining, affinity=aff)
    for tokens in (None, SYS, SYS[:20], [99] * 40):
        gc, wc = {}, {}
        assert [got._affinity(r, tokens, gc) for r in got.replicas.values()] == \
            [want._affinity(r, tokens, wc) for r in want.replicas.values()]
    # pick: the same winners in sequence, the in-flight reservations
    # moving the scores between picks
    roles = sorted({v[0] for v in views})
    for role in roles:
        for remaining, tokens in ((60.0, None), (1.0, None), (60.0, SYS), (60.0, SYS[:20])):
            for _ in range(3):
                assert got.pick(role, remaining, prefix_tokens=tokens).key == \
                    want.pick(role, remaining, prefix_tokens=tokens).key
    for core in (got, want):
        for r in core.replicas.values():
            r.drain_requested = True
    with pytest.raises(pt_router.NoReplicaAvailable) as err:
        got.pick(roles[0], 60.0)
    with pytest.raises(jax_router.NoReplicaAvailable) as jerr:
        want.pick(roles[0], 60.0)
    assert str(err.value) == str(jerr.value)


def test_fleet_journal_replay_matches_jax(tmp_path):
    """The port's journal writes records the JAX reader replays to the
    JAX state, and the port's replay equals the JAX replay."""
    path = str(tmp_path / "fleet_state.jsonl")
    j = pt_router.FleetJournal(path)
    j.record("replica", key="r0", url="http://a", role="decode", state="warm", why="poll",
             replica_id="d0", pid=11, boot_id="b0")
    j.record("replica", key="r0", url="http://a", role="decode", state="serving",
             why="streak", replica_id="d0", pid=11, boot_id="b0")
    j.record("replica", key="r1", url="http://b", role="prefill", state="gone", why="eject",
             replica_id="p0", pid=12, boot_id="b1")
    j.record("tenants", buckets={"gold": {"tokens": 1.5, "rate": 2.0, "burst": 4.0}},
             in_flight={"gold": 2})
    records, note = pt_router.read_fleet_journal(path)
    jrecords, jnote = jax_router.read_fleet_journal(path)
    assert note == jnote and records == jrecords and len(records) == 4
    got, want = pt_router.replay_fleet_state(records), jax_router.replay_fleet_state(records)
    assert got == want
    assert got["replicas"]["r0"]["state"] == "serving" and got["replicas"]["r1"]["pid"] == 12
    # a torn tail reads as the JAX reader reads it
    with open(path, "ab") as f:
        f.write(b'{"kind": "replica", "key"')
    assert pt_router.read_fleet_journal(path) == jax_router.read_fleet_journal(path)


def test_fleet_federation_matches_jax():
    text = "\n".join([
        "# TYPE pfx_serving_tokens_out_total counter",
        "pfx_serving_tokens_out_total 3",
        'pfx_http_responses_total{code="200"} 5',
        'pfx_router_replica_depth{replica="inner"} 2',
        "pfx_fleet_series 99",
        "python_gc_collections_total 7",
        'pfx_handoff_bytes_total{transport="direct"} 1234',
    ]) + "\n"
    got, want = pt_router.FleetFederation(series_cap=3), jax_router.FleetFederation(series_cap=3)
    assert got.ingest("r0", "decode", text) == want.ingest("r0", "decode", text) == 4
    assert got.ingest("r1", "prefill", text) == want.ingest("r1", "prefill", text)
    got.note_miss("r2", "error")
    want.note_miss("r2", "error")

    def rows(fed):
        return sorted((n, tuple(sorted(lab.items())), v) for n, lab, v in fed.collect()
                      if n != "pfx_fleet_scrape_age_seconds")

    assert rows(got) == rows(want)
    assert got.value("r0", "pfx_handoff_bytes_total", transport="direct") == 1234.0


# ---------------------------------------------------------------------------
# the router CLI over port replicas
# ---------------------------------------------------------------------------


def test_port_router_replicated_matches_in_process(tmp_path):
    """Two monolith continuous replicas behind the port's router: every
    answer is the in-process server's, both replicas serve, the router's
    counters move, and the drain exits 0 everywhere."""
    cfg = write_config(tmp_path)
    want = reference_tokens(cfg, BODIES)
    reps = [replica(tmp_path, cfg, f"m{i}", "--scheduler", "continuous", "--cb-batch", "4")
            for i in range(2)]
    router = None
    try:
        wait_healthy(reps)
        router = port_router(tmp_path, "router", *[a for r in reps for a in ("--replica", r.url)],
                             "--router-id", "front")
        h = wait_eligible(router, 2)
        assert h["identity"]["replica_id"] == "front" and h["mode"] == "replicated"
        for body, tokens in zip(BODIES * 2, want * 2):
            code, out = post(router.port, body)
            assert code == 200 and out["completion_ids"] == tokens, out
        m = metrics(router.port)
        served = {lab: v for (n, lab), v in m.items() if n == "pfx_router_requests_total"}
        assert sum(served.values()) == 6 and len(served) == 2, served
        views = {v["replica_id"]: v for v in get(router.port, "/replicas")["replicas"]}
        assert set(views) == {"m0", "m1"} and all(v["scheduler"] == "continuous"
                                                   for v in views.values())
    finally:
        codes = stop_all(([router] if router else []) + reps)
    assert set(codes.values()) == {0}, codes


SUPERVISE_REFUSALS = [  # (extra argv, exit code): bad input to --supervise
    (["--replica-cmd", "python x.py --replica-id {replica_id}"], 1),  # no {port}
    (["--replica-cmd", "python x.py --port {port}", "--flap-budget", "0"], 1),
    (["--replica-cmd", "python x.py --port {port}", "--scale-low-depth", "5",
      "--scale-high-depth", "4"], 1),  # inverted watermarks
    (["--replica-cmd", "python x.py --port {port}", "--max-replicas", "0"], 1),
    (["--prefill-cmd", "python x.py --port {port}"], 2),  # one pool only
    (["--replica-cmd", "a {port}", "--prefill-cmd", "b {port}", "--decode-cmd", "c {port}"], 2),
    (["--prefill-cmd", "p {port}", "--decode-cmd", "d {port}", "--prefill-base-port", "8201",
      "--decode-base-port", "8203"], 2),  # overlapping slot ranges
    (["--replica-cmd", "a {port}", "--replica", "http://127.0.0.1:1"], 2),
]


def _refusal(argv, tmp_path):
    out = subprocess.run([sys.executable, *argv], env=_env(tmp_path, {"JAX_PLATFORMS": "cpu"}),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    lines = [ln for ln in out.stderr.strip().splitlines() if ln.strip()]
    return out.returncode, (lines[-1].split("error: ", 1)[-1] if lines else "")


def test_port_router_refuses_supervise(tmp_path):
    """The port router's --supervise refuses bad input as the JAX router
    does: the same exit codes and the same last line (an argparse error, or
    the controller's ValueError before anything spawns)."""
    for extra, code in SUPERVISE_REFUSALS:
        args = ["--port", "9", "--supervise", *extra]
        got = _refusal(["-m", "paddlefleetx_tpu_torch.tools.router", *args], tmp_path)
        want = _refusal([os.path.join(REPO, "tools", "router.py"), *args], tmp_path)
        assert got == want and got[0] == code and got[1], (extra, got, want)


def test_jax_router_fronts_port_replicas(tmp_path):
    """The JAX package's tools/router.py, unmodified, in front of a port
    prefill replica and a port decode replica (direct transfer): the
    in-process server's tokens, and the payload never crossed it."""
    cfg = write_config(tmp_path)
    want = reference_tokens(cfg, BODIES)
    pre = replica(tmp_path, cfg, "pre0", "--role", "prefill")
    dec = replica(tmp_path, cfg, "dec0", "--role", "decode", "--cb-batch", "4")
    router = None
    try:
        wait_healthy([pre, dec])
        router = Proc(tmp_path, "jax_router", lambda port: [
            os.path.join(REPO, "tools", "router.py"), "--port", str(port), "--poll-interval",
            "0.2", "--prefill", pre.url, "--decode", dec.url, "--handoff", "direct"],
            {"JAX_PLATFORMS": "cpu", "PFX_PLATFORM": "cpu"})
        wait_eligible(router, 2, timeout=120)
        for body, tokens in zip(BODIES, want):
            code, out = post(router.port, body)
            assert code == 200 and out["completion_ids"] == tokens, out
        assert metric(metrics(router.port), "pfx_router_handoff_bytes_total") == 0.0
        assert metric(metrics(dec.port), "pfx_handoff_adopts_total") == 3.0
        assert metric(metrics(pre.port), "pfx_handoff_direct_total", outcome="ok") == 3.0
    finally:
        codes = stop_all(([router] if router else []) + [pre, dec])
    assert set(codes.values()) == {0}, codes
