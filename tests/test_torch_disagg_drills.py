"""PyTorch port: the disaggregated fleet's drills through the real CLIs on
``--device cpu`` (the drills of tests/test_disagg_drills.py and
tests/test_kv_tier.py's migration).

  - direct and proxy: a port prefill replica (prefix cache on) and a port
    decode replica behind the port's router answer the tokens of a
    monolithic continuous replica under ``--handoff direct`` (the router's
    byte counter stays flat while the replicas count the payload) and
    under ``--handoff proxy`` (the router carries every payload byte);
    exports and adoptions count one a request, the prefill replica's
    prefix cache hits the shared system prompt, and traces carry the
    ``prefill_export`` and ``adopt`` spans;
  - failover: ``handoff_drop:1:2`` on the prefill replica degrades the
    first direct send to the proxy leg, and ``adopt_crash:2`` on one of
    two decode replicas kills it at its second adoption, which the router
    re-prefills through the surviving pair: every answer a 200 with the
    same tokens;
  - a rolling drain with prefix migration: the router's ``drain``
    subcommand drains one of two replicas, whose ``/admin/drain`` carries
    the surviving peer in ``migrate_to``; the drained replica ships its
    cached prefixes there and exits 0, and the next request with that
    prefix is a hit on the peer with the same tokens.

The harness (subprocesses with their output in files, bounded waits) is
tests/test_torch_router.py's.
"""

import json
import subprocess
import sys

from test_torch_router import (
    BODIES,
    REPO,
    _env,
    get,
    metric,
    metrics,
    port_router,
    post,
    reference_tokens,
    replica,
    stop_all,
    wait_eligible,
    wait_healthy,
    write_config,
)


def test_direct_and_proxy_match_a_monolithic_replica(tmp_path):
    cfg = write_config(tmp_path)
    pre = replica(tmp_path, cfg, "pre0", "--role", "prefill", "--prefix-cache-blocks", "16")
    dec = replica(tmp_path, cfg, "dec0", "--role", "decode", "--cb-batch", "4")
    mono = replica(tmp_path, cfg, "mono", "--scheduler", "continuous", "--cb-batch", "4")
    routers = []
    try:
        wait_healthy([pre, dec, mono])
        want = []
        for body in BODIES:
            code, out = post(mono.port, body)
            assert code == 200
            want.append(out["completion_ids"])
        hp, hd = get(pre.port, "/healthz"), get(dec.port, "/healthz")
        assert (hp["identity"]["role"], hp["identity"]["scheduler"]) == ("prefill", "queue")
        assert (hd["identity"]["role"], hd["identity"]["scheduler"]) == ("decode", "continuous")
        assert hd["available_blocks"] > 0 and "available_blocks" not in hp
        code, out = post(pre.port, BODIES[0])
        assert code == 400 and "--role prefill" in out["error"]
        code, out = post(dec.port, BODIES[0], path="/prefill")
        assert code == 404

        direct = port_router(tmp_path, "direct", "--prefill", pre.url, "--decode", dec.url,
                             "--handoff", "direct")
        routers.append(direct)
        assert wait_eligible(direct, 2)["mode"] == "disaggregated"
        got = [post(direct.port, body) for body in BODIES]
        assert [c for c, _ in got] == [200] * 3 and [o["completion_ids"] for _, o in got] == want
        m = metrics(direct.port)
        assert metric(m, "pfx_router_handoff_bytes_total") == 0.0
        assert metric(m, "pfx_router_handoff_seconds_count") == 3.0
        pm, dm = metrics(pre.port), metrics(dec.port)
        direct_bytes = metric(dm, "pfx_handoff_bytes_total", transport="direct")
        assert direct_bytes > 0 and direct_bytes == metric(pm, "pfx_handoff_bytes_total",
                                                           transport="direct")
        assert metric(pm, "pfx_handoff_direct_total", outcome="ok") == 3.0
        assert metric(pm, "pfx_handoff_exports_total") == 3.0
        assert metric(dm, "pfx_handoff_adopts_total") == 3.0
        # the shared system prompt prefilled once on the prefill replica
        assert get(pre.port, "/healthz")["serving"]["prefix"]["hits"] == 1
        assert direct.stop() == 0

        proxy = port_router(tmp_path, "proxy", "--prefill", pre.url, "--decode", dec.url,
                            "--handoff", "proxy")
        routers.append(proxy)
        wait_eligible(proxy, 2)
        got = [post(proxy.port, body) for body in BODIES]
        assert [o["completion_ids"] for _, o in got] == want
        dm2 = metrics(dec.port)
        proxied = metric(dm2, "pfx_handoff_bytes_total", transport="proxy")
        assert proxied > 0 and metric(metrics(proxy.port),
                                      "pfx_router_handoff_bytes_total") == proxied
        assert metric(dm2, "pfx_handoff_adopts_total") == 6.0
        assert metric(dm2, "pfx_kv_blocks_used") == 0.0
        # the decode replica's sampled traces hold the adoption
        traces = json.dumps(get(dec.port, "/debug/traces"))
        assert '"adopt"' in traces
        assert '"prefill_export"' in json.dumps(get(pre.port, "/debug/traces"))
    finally:
        codes = stop_all(routers + [pre, dec, mono])
    assert set(codes.values()) == {0}, codes


def test_handoff_drop_and_adopt_crash_fail_over_with_the_same_tokens(tmp_path):
    cfg = write_config(tmp_path)
    want = reference_tokens(cfg, BODIES[:1])[0]
    pre = replica(tmp_path, cfg, "pre0", "--role", "prefill",
                  env_extra={"PFX_FAULT": "handoff_drop:1:2"})
    d1 = replica(tmp_path, cfg, "d1", "--role", "decode", "--cb-batch", "4",
                 env_extra={"PFX_FAULT": "adopt_crash:2"})
    d2 = replica(tmp_path, cfg, "d2", "--role", "decode", "--cb-batch", "4")
    router = None
    try:
        wait_healthy([pre, d1, d2])
        assert "PFX_FAULT drill armed: adopt_crash" in d1.output()
        router = port_router(tmp_path, "router", "--prefill", pre.url, "--decode", d1.url,
                             "--decode", d2.url, "--handoff", "direct")
        wait_eligible(router, 3)
        codes, outs = [], []
        for _ in range(12):
            c, out = post(router.port, BODIES[0])
            codes.append(c)
            outs.append(out.get("completion_ids"))
            if d1.proc.poll() is not None and len(codes) >= 3:
                break  # the fatal adoption landed and failed over
        assert codes == [200] * len(codes) and outs == [want] * len(outs), (codes, outs)
        assert d1.proc.wait(timeout=30) == 29
        m = metrics(router.port)
        assert metric(m, "pfx_router_handoff_bytes_total") > 0  # the dropped send's proxy leg
        assert metric(m, "pfx_handoff_failovers_total", leg="decode") >= 1.0
        pm = metrics(pre.port)
        assert metric(pm, "pfx_handoff_direct_total", outcome="fallback") >= 1.0
        assert metric(pm, "pfx_handoff_direct_total", outcome="ok") >= 1.0
        c, out = post(router.port, BODIES[0])
        assert c == 200 and out["completion_ids"] == want
        assert metric(metrics(d2.port), "pfx_kv_blocks_used") == 0.0
    finally:
        codes = stop_all(([router] if router else []) + [pre, d1, d2])
    assert codes["d1"] == 29 and {codes[k] for k in ("pre0", "d2", "router")} == {0}, codes


def test_rolling_drain_migrates_prefixes(tmp_path):
    cfg = write_config(tmp_path)
    want = reference_tokens(cfg, BODIES[:2])
    args = ("--scheduler", "continuous", "--cb-batch", "4", "--prefix-cache-blocks", "16")
    r0, r1 = replica(tmp_path, cfg, "m0", *args), replica(tmp_path, cfg, "m1", *args)
    router = None
    try:
        wait_healthy([r0, r1])
        code, out = post(r0.port, BODIES[0])
        assert code == 200 and out["completion_ids"] == want[0]
        assert get(r0.port, "/healthz")["prefix_cached_blocks"] >= 2
        router = port_router(tmp_path, "router", "--replica", r0.url, "--replica", r1.url)
        wait_eligible(router, 2)
        # the drain subcommand: the router names the surviving peer in the
        # drain's migrate_to, m0 ships its prefixes there and exits 0
        drained = subprocess.run(
            [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.router", "drain", "--admin",
             router.url, "--replica-id", "m0", "--timeout", "60"],
            env=_env(tmp_path), cwd=REPO, capture_output=True, text=True, timeout=90)
        assert drained.returncode == 0 and "drained and exited" in drained.stdout, drained
        assert r0.proc.wait(timeout=30) == 0
        assert f"migrate: {r1.url} adopted" in r0.output()
        assert metric(metrics(r1.port), "pfx_migrate_adopted_total") >= 2.0
        # the migrated system prompt is a hit on the survivor, same tokens
        code, out = post(router.port, BODIES[1])
        assert code == 200 and out["completion_ids"] == want[1]
        h = get(r1.port, "/healthz")
        assert h["serving"]["prefix"]["hits"] == 1 and h["serving"]["prefix"]["hit_tokens"] >= 32
        assert h["serving"]["migrate_adopted"] >= 2
    finally:
        codes = stop_all(([router] if router else []) + [r0, r1])
    assert set(codes.values()) == {0}, codes
