"""The elastic control plane: replica supervision and SLO-driven scaling
behind the router (``tools/router.py --supervise``).

A copy of ``paddlefleetx_tpu/core/controller.py`` (pure host Python) that
imports only this package's modules: for the same router snapshots and
clocks it takes the JAX controller's decisions, keeps its counters and
writes its journal records, so either router supervises either package's
replicas.  Two cooperating pieces, neither touching the card (the control
plane boots at once and survives anything the replicas do):

  - :class:`ReplicaSupervisor` spawns replicas as managed subprocesses
    from one command template, restarts crashes with exponential backoff
    and applies a **flap budget**: a replica that crash-loops more than
    ``flap_budget`` times inside ``flap_window_s`` is QUARANTINED loudly
    (ERROR log + ``pfx_replica_quarantines_total``) instead of being
    restarted forever.  **Warm boot**: spawned replicas get
    ``--compile-cache-dir`` appended; the port's serve CLI builds and loads
    its kernel libraries there (``ops/_build.use_build_dir``), so a spawn
    into a directory an earlier replica filled builds nothing.
  - :class:`ElasticController` is one control loop over the router's
    replica snapshots: **breach-driven fast scale-up** (any serving
    replica reporting an SLO burn-rate breach, or average queue depth /
    paged-arena occupancy past the high watermarks, or a decode pool's
    admissible blocks at its watermark) bounded by ``up_cooldown_s`` per
    spawn; **idle scale-down** only after ``idle_s`` of idleness AND
    ``down_cooldown_s`` since the last scale action (the two watermarks
    plus the dwell keep the fleet from oscillating), executed through the
    router's authenticated remote drain so no admitted request is dropped;
    hard ``min_replicas`` / ``max_replicas`` bounds.

Every control tick appends ONE row to a bounded decision log
(``PFX_CONTROLLER_LOG_CAP``, default 4096): an untruncated log replays to
exact agreement with the ``pfx_controller_*`` counters through
:func:`replay_controller_log`, so a scale action the log does not explain
shows up as a mismatch.  A restarted router re-adopts the live replicas
its journal names (:meth:`ReplicaSupervisor.adopt`, by replica id, pid and
boot id) and resumes the controller's clocks
(:meth:`ElasticController.restore_clocks`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shlex
import signal
import subprocess
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.telemetry import (
    Registry,
    env_int,
    get_registry,
)

CONTROLLER_LOG_CAP_ENV = "PFX_CONTROLLER_LOG_CAP"


def _cmd_hash(cmd: List[str]) -> str:
    """Short stable hash of a spawn command — the fleet journal records
    it per slot so re-adoption can recognize OUR replica build in
    /proc/<pid>/cmdline (corpse reaping) without journaling the full
    command line."""
    return hashlib.sha256(" ".join(cmd).encode()).hexdigest()[:12]


def _pid_alive(pid: int) -> bool:
    """Signal-0 liveness probe (PermissionError means alive but not
    ours — treated alive: we must never respawn onto its port)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def _proc_cmd_hash(pid: int) -> Optional[str]:
    """The live process's spawn-command hash via /proc (None when the
    process is gone or the platform has no /proc) — the only safe way
    to recognize a journaled pid after the parent died: pid alone may
    have been recycled by an unrelated process."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            raw = f.read()
    except OSError:
        return None
    parts = [p.decode("utf-8", "replace") for p in raw.split(b"\0") if p]
    return _cmd_hash(parts) if parts else None


@dataclasses.dataclass
class ScalePolicy:
    """The autoscaling knobs, validated loudly (a policy whose
    watermarks invert would oscillate by construction).

    ``high_depth``/``low_depth`` are AVERAGE waiting-queue depth per
    serving replica (router in-flight included); occupancy watermarks
    are the max continuous-batch rows/capacity across the fleet.  Scale
    UP when any breach/high-watermark signal fires (at most once per
    ``up_cooldown_s`` — a spawned replica needs time to reach serving
    before it can relieve anything); scale DOWN only after ``idle_s`` of
    sustained idleness and ``down_cooldown_s`` since the last scale
    action.

    Disaggregated pools watch DIFFERENT signals (docs/serving.md
    "Disaggregated operations"): a prefill pool scales on queue depth /
    TTFT burn (``use_occupancy=False`` — prefill replicas hold no
    decode arena), a decode pool on arena occupancy and
    ``available_blocks`` (``use_depth=False``, ``low_blocks`` > 0: any
    serving replica's admissible-block count at or below it is
    pressure).  The SLO-breach signal is always live.

    ``count_in_flight=False`` builds the depth signal from replica-
    reported queue depth ONLY: under the direct handoff transport a
    prefill replica's router-side in-flight spans the whole
    prefill->decode relay, so counting it would scale the prefill pool
    on DECODE duration (tools/router.py sets this for the prefill pool
    when ``--handoff direct``)."""

    min_replicas: int = 1
    max_replicas: int = 4
    high_depth: float = 4.0
    low_depth: float = 0.5
    high_occupancy: float = 0.9
    low_occupancy: float = 0.25
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 60.0
    idle_s: float = 30.0
    interval_s: float = 1.0
    use_depth: bool = True
    use_occupancy: bool = True
    low_blocks: int = 0
    count_in_flight: bool = True

    def validate(self) -> "ScalePolicy":
        if self.low_blocks < 0:
            raise ValueError(
                f"low_blocks must be >= 0, got {self.low_blocks}"
            )
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}"
            )
        if self.low_depth >= self.high_depth:
            raise ValueError(
                f"low_depth {self.low_depth} must be < high_depth "
                f"{self.high_depth} (hysteresis band)"
            )
        if self.low_occupancy >= self.high_occupancy:
            raise ValueError(
                f"low_occupancy {self.low_occupancy} must be < "
                f"high_occupancy {self.high_occupancy} (hysteresis band)"
            )
        for name in ("up_cooldown_s", "down_cooldown_s", "idle_s",
                     "interval_s"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if (not self.use_depth and not self.use_occupancy
                and self.low_blocks <= 0):
            # with every load signal off, pressure is breach-only and
            # "idle" degenerates to "no breach": a slammed pool would
            # read as idle and be drained to min_replicas mid-load
            raise ValueError(
                "ScalePolicy needs at least one load signal: enable "
                "use_depth or use_occupancy, or set low_blocks > 0"
            )
        return self

    def view(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ManagedReplica:
    """One supervised replica slot (fixed port; the process comes and
    goes — crash-restart and drain-respawn reuse the slot, so the router
    sees the same url walk gone -> warm -> serving)."""

    slot: int
    port: int
    url: str
    cmd: List[str]
    rid: str = ""        # replica_id: <slot_prefix><slot> (m0, p0, d1...)
    log_path: str = ""
    key: Optional[str] = None            # router registry key
    proc: Optional[subprocess.Popen] = None
    desired: bool = False                # False = expected to exit (drain)
    quarantined: bool = False
    restarts: int = 0
    restart_times: List[float] = dataclasses.field(default_factory=list)
    next_restart_t: float = 0.0          # 0 = no restart pending
    flap_exempt: bool = False            # pending respawn spends no flap
    last_exit_rc: Optional[int] = None
    started_t: float = 0.0
    # re-adoption (docs/serving.md "Control-plane recovery"): a replica
    # spawned by a PREVIOUS router incarnation and re-adopted at boot is
    # not our child — no Popen handle, so liveness is signal-0 on the
    # pid and identity is the /healthz boot_id captured at adoption
    adopted_pid: Optional[int] = None
    adopted_boot_id: Optional[str] = None

    def pid(self) -> Optional[int]:
        if self.proc is not None:
            return self.proc.pid
        return self.adopted_pid

    def view(self) -> Dict[str, Any]:
        return {
            "slot": self.slot,
            "replica_id": self.rid,
            "port": self.port,
            "url": self.url,
            "key": self.key,
            "pid": self.pid(),
            "cmd_hash": _cmd_hash(self.cmd),
            "adopted": self.adopted_pid is not None,
            "desired": self.desired,
            "quarantined": self.quarantined,
            "restarts": self.restarts,
            "restart_pending": self.next_restart_t > 0,
            "last_exit_rc": self.last_exit_rc,
            "log_path": self.log_path,
        }


class ReplicaSupervisor:
    """Managed-subprocess replica supervision: spawn from a command
    template, crash-restart with exponential backoff, quarantine
    crash-loopers LOUDLY within the flap budget, warm-boot via the
    persistent compile cache.

    ``cmd_template`` is a shell-style string with ``{port}`` and
    ``{replica_id}`` placeholders, e.g.::

        python tools/serve.py -c cfg.yaml --port {port} --replica-id {replica_id}

    Slot ``i`` listens on ``base_port + i`` with replica_id ``m<i>``.
    When ``compile_cache_dir`` is set, ``--compile-cache-dir <dir>`` is
    appended so every spawn (first boot, crash-restart, scale-up) loads
    the fleet's kernel libraries from it — scale-up cost is process boot,
    not a kernel build.  ``spawn_fn`` is injectable for tests; the default
    Popen routes stdout+stderr to ``<log_dir>/<replica_id>.log`` so a
    crash-looping replica leaves evidence instead of a blocked pipe."""

    def __init__(self, cmd_template: str, *, base_port: int,
                 max_replicas: int, role: str = "monolith",
                 slot_prefix: str = "m",
                 compile_cache_dir: str = "", log_dir: str = "",
                 backoff_base_s: float = 0.5, backoff_max_s: float = 30.0,
                 flap_budget: int = 5, flap_window_s: float = 60.0,
                 env: Optional[Dict[str, str]] = None,
                 spawn_fn: Optional[Callable[..., Any]] = None,
                 registry: Optional[Registry] = None) -> None:
        if "{port}" not in cmd_template:
            raise ValueError(
                "replica command template must contain a {port} "
                f"placeholder, got {cmd_template!r}"
            )
        if flap_budget < 1:
            raise ValueError(f"flap_budget must be >= 1, got {flap_budget}")
        # slot_prefix keeps two pools' replica ids distinct (the
        # disaggregated control plane runs one supervisor per pool:
        # prefill p<i>, decode d<i>; the monolith fleet keeps m<i>)
        self.slot_prefix = slot_prefix
        self.cmd_template = cmd_template
        self.base_port = int(base_port)
        self.max_replicas = int(max_replicas)
        self.role = role
        self.compile_cache_dir = compile_cache_dir
        self.log_dir = log_dir
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.flap_budget = int(flap_budget)
        self.flap_window_s = float(flap_window_s)
        self.env = dict(env) if env is not None else None
        self._spawn_fn = spawn_fn
        self._registry = registry or get_registry()
        # optional control-plane journal (core.router.FleetJournal —
        # tools/router.py wires one): slot facts land in it BEFORE the
        # child process exists, so there is no window where a spawned
        # replica is untracked and unadoptable
        self.journal: Optional[Any] = None
        self.slots: Dict[int, ManagedReplica] = {}
        # guards the slots DICT (inserted by the control thread, read
        # by HTTP handler threads via views()/counts — an unguarded
        # sorted(items()) during a scale-up insert is a RuntimeError);
        # ManagedReplica field reads stay lock-free (ints/bools, racy
        # reads are benign)
        self._lock = threading.Lock()

    # -- slot construction ----------------------------------------------
    def _slot(self, i: int) -> ManagedReplica:
        m = self.slots.get(i)
        if m is None:
            port = self.base_port + i
            replica_id = f"{self.slot_prefix}{i}"
            cmd = shlex.split(
                self.cmd_template.format(port=port, replica_id=replica_id)
            )
            if self.compile_cache_dir:
                cmd += ["--compile-cache-dir", self.compile_cache_dir]
            log_path = (os.path.join(self.log_dir, f"{replica_id}.log")
                        if self.log_dir else "")
            m = ManagedReplica(
                slot=i, port=port, url=f"http://127.0.0.1:{port}",
                cmd=cmd, rid=replica_id, log_path=log_path,
            )
            with self._lock:
                self.slots[i] = m
        return m

    def _snapshot(self) -> List[ManagedReplica]:
        with self._lock:
            return [m for _, m in sorted(self.slots.items())]

    def _journal_slot(self, m: ManagedReplica, phase: str,
                      pid: Optional[int], boot_id: Optional[str] = None
                      ) -> None:
        j = self.journal
        if j is not None:
            j.record("slot", pool=self.role, slot=m.slot, port=m.port,
                     url=m.url, rid=m.rid, cmd_hash=_cmd_hash(m.cmd),
                     phase=phase, pid=pid, boot_id=boot_id)

    def _spawn(self, m: ManagedReplica, now: float) -> None:
        # the "spawning" record lands BEFORE the child exists: if the
        # router dies between this append and the Popen returning, the
        # next boot still knows the slot/port/cmd_hash and can adopt or
        # reap whatever the half-spawn left behind (satellite: no
        # untracked-child window)
        m.adopted_pid = None
        m.adopted_boot_id = None
        self._journal_slot(m, "spawning", None)
        if self._spawn_fn is not None:
            m.proc = self._spawn_fn(m)
        else:
            if m.log_path:
                os.makedirs(os.path.dirname(m.log_path), exist_ok=True)
                # append: one log tells the whole crash-loop story
                out = open(m.log_path, "ab", buffering=0)
            else:
                out = subprocess.DEVNULL
            m.proc = subprocess.Popen(
                m.cmd, stdout=out, stderr=subprocess.STDOUT,
                env=self.env,
            )
            if out is not subprocess.DEVNULL:
                out.close()  # the child holds its own fd now
        m.started_t = now
        m.next_restart_t = 0.0
        self._journal_slot(m, "spawned", m.proc.pid)
        logger.info(
            f"supervisor: spawned replica {m.rid} "
            f"(pid {m.proc.pid}, port {m.port})"
        )

    # -- desired-state management ---------------------------------------
    def ensure(self, target: int, now: Optional[float] = None
               ) -> List[ManagedReplica]:
        """Desire ``target`` running replicas among non-quarantined
        slots (lowest slots first), spawning the missing ones NOW.
        Returns the newly DESIRED slots — spawned immediately, or
        respawn-pending behind a still-draining predecessor (the
        controller registers their urls with the router and commits a
        scale-up only when this list is non-empty)."""
        now = time.monotonic() if now is None else now
        started: List[ManagedReplica] = []
        desired = 0
        for i in range(self.max_replicas):
            if desired >= target:
                break
            m = self._slot(i)
            if m.quarantined:
                continue
            if not m.desired:
                m.desired = True
                started.append(m)
                if m.proc is None:
                    self._spawn(m, now)
                else:
                    # the slot's previous process is still draining out:
                    # spawning now would double-bind the port — respawn
                    # right after poll() reaps its exit
                    m.next_restart_t = now
            desired += 1
        return started

    # -- fleet re-adoption (docs/serving.md "Control-plane recovery") ----
    def _probe_identity(self, url: str, timeout: float
                        ) -> Optional[Dict[str, Any]]:
        """GET /healthz on a slot's port -> its identity block, or None
        when nothing answers (import is deferred: the supervisor must stay
        importable standalone)."""
        from paddlefleetx_tpu_torch.core.router import _http_request
        try:
            status, body, _, _ = _http_request(
                url, "GET", "/healthz", timeout=timeout)
            if status != 200:
                return None
            h = json.loads(body)
            return h.get("identity") or {}
        except Exception:  # noqa: BLE001 — any failure means no replica
            return None

    def adopt(self, slot_facts: Dict[str, Any], *,
              probe_timeout_s: float = 2.0) -> List[ManagedReplica]:
        """Reconcile journaled slot facts against what is actually
        running (the Borg/Pathways reconcile step): probe each
        recorded slot's port, and a live replica whose /healthz identity
        matches the journal (replica_id + pid + boot_id — never bare
        pid) is RE-ADOPTED into its slot with zero restarts and no flap
        budget spent.  A port answering with the WRONG identity is a
        squatter — the slot is quarantined loudly rather than spawned
        into a bind collision.  A journaled pid that is alive but not
        answering is reaped ONLY when /proc/<pid>/cmdline hashes to the
        slot's recorded spawn command (a recycled pid never gets our
        SIGKILL).  Slots left empty respawn through the normal
        ``ensure`` path.  With an EMPTY fact for a slot (journal lost),
        a live replica answering with the slot's own replica_id is
        still adopted — the probe on OUR port reporting OUR replica_id
        is the identity match.  Returns the newly adopted slots (the
        controller registers their urls like freshly spawned ones)."""
        adopted: List[ManagedReplica] = []
        now = time.monotonic()
        for slot_key, fact in sorted(
                (slot_facts or {}).items(), key=lambda kv: str(kv[0])):
            try:
                i = int(slot_key)
            except (TypeError, ValueError):
                continue
            if not (0 <= i < self.max_replicas):
                continue
            fact = fact if isinstance(fact, dict) else {}
            m = self._slot(i)
            if m.proc is not None or m.adopted_pid is not None:
                continue
            ident = self._probe_identity(m.url, probe_timeout_s)
            if ident is None:
                # nothing answering: if the journaled pid is still alive
                # AND provably ours (cmdline hash), it is a wedged corpse
                # from the dead router — reap it so ensure() can respawn
                # onto the port
                pid = fact.get("pid")
                if (isinstance(pid, int) and pid > 0 and _pid_alive(pid)
                        and fact.get("cmd_hash")
                        and _proc_cmd_hash(pid) == fact.get("cmd_hash")):
                    logger.warning(
                        f"supervisor: reaping stale replica corpse "
                        f"{m.rid} (pid {pid} alive but /healthz silent; "
                        "cmdline matches the journaled spawn command)")
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except OSError:
                        pass
                continue
            live_pid = ident.get("pid")
            live_boot = ident.get("boot_id")
            rid_ok = ident.get("replica_id") == m.rid
            if fact.get("pid") is not None or fact.get("boot_id"):
                # journal has identity facts: the FULL triple must match
                match = (rid_ok and live_pid == fact.get("pid")
                         and (not fact.get("boot_id")
                              or live_boot == fact.get("boot_id")))
            else:
                # journal lost/stale (self-registration rebuild path):
                # the process answering on our slot's port with our
                # replica_id IS the identity match
                match = rid_ok
            if not match:
                m.quarantined = True
                logger.error(
                    f"QUARANTINE: slot {i} (port {m.port}) is held by a "
                    f"process whose identity does not match "
                    f"(journal pid={fact.get('pid')} "
                    f"boot_id={fact.get('boot_id')}; live "
                    f"pid={live_pid} boot_id={live_boot} "
                    f"replica_id={ident.get('replica_id')!r}); NOT "
                    "spawning into a bind collision — free the port and "
                    "restart the control plane")
                continue
            m.desired = True
            m.adopted_pid = int(live_pid) if live_pid is not None else None
            m.adopted_boot_id = live_boot
            m.started_t = now
            m.next_restart_t = 0.0
            m.last_exit_rc = None
            adopted.append(m)
            self._registry.counter(
                "pfx_router_adopted_replicas_total", replica=m.rid
            ).inc()
            self._journal_slot(m, "adopted", m.adopted_pid,
                               m.adopted_boot_id)
            logger.info(
                f"supervisor: re-adopted replica {m.rid} "
                f"(pid {m.adopted_pid}, port {m.port}, "
                f"boot_id {m.adopted_boot_id}) — zero restarts, no flap "
                "budget spent")
        return adopted

    def drain_slot(self, slot: int) -> ManagedReplica:
        """Mark a slot's exit EXPECTED (scale-down): the supervisor will
        not restart it.  The actual drain goes through the router's
        authenticated remote-drain so admitted work finishes."""
        m = self.slots[slot]
        m.desired = False
        m.next_restart_t = 0.0
        return m

    def pick_drain_slot(self) -> Optional[ManagedReplica]:
        """Highest desired, non-quarantined slot — scale-down retires
        the newest replica first so the stable low slots keep their
        warm caches and router history."""
        live = [m for m in self._snapshot()
                if m.desired and not m.quarantined]
        return max(live, key=lambda m: m.slot) if live else None

    # -- supervision ----------------------------------------------------
    def poll(self, now: Optional[float] = None) -> None:
        """One supervision sweep: reap exits, schedule/execute
        backoff restarts, quarantine crash-loopers loudly."""
        now = time.monotonic() if now is None else now
        for m in self._snapshot():
            if m.proc is None and m.adopted_pid is not None:
                # adopted replicas are not our children: liveness is
                # signal-0, and an exit's rc is unobservable — treat it
                # like a clean out-of-band drain (flap budget untouched)
                # and respawn if still desired
                if _pid_alive(m.adopted_pid):
                    continue
                pid = m.adopted_pid
                m.adopted_pid = None
                m.adopted_boot_id = None
                m.last_exit_rc = None
                if not m.desired or m.quarantined:
                    logger.info(
                        f"supervisor: adopted replica {m.rid} "
                        f"(pid {pid}) exited (expected: drained)")
                    continue
                m.flap_exempt = True
                m.next_restart_t = now + self.backoff_base_s
                logger.info(
                    f"supervisor: adopted replica {m.rid} (pid {pid}) "
                    f"exited (rc unobservable — not our child); "
                    f"respawning in {self.backoff_base_s:.2f}s "
                    "(flap budget not spent)")
                continue
            if m.proc is not None:
                rc = m.proc.poll()
                if rc is None:
                    continue
                m.last_exit_rc = rc
                m.proc = None
                if not m.desired:
                    logger.info(
                        f"supervisor: replica {m.rid} exited rc={rc} "
                        "(expected: drained)"
                    )
                    continue
                if m.quarantined:
                    continue
                if rc == 0:
                    # a CLEAN exit while desired: an out-of-band drain
                    # (manual POST /admin/drain at a supervised replica,
                    # or ensure()'s respawn-after-drain handoff) — the
                    # fleet self-heals by respawning, but a deploy is
                    # not a crash: the flap budget is not spent and no
                    # crash warning is logged
                    m.flap_exempt = True
                    m.next_restart_t = now + self.backoff_base_s
                    logger.info(
                        f"supervisor: replica {m.rid} exited cleanly "
                        "(rc=0) while desired — out-of-band drain? "
                        f"respawning in {self.backoff_base_s:.2f}s "
                        "(flap budget not spent)"
                    )
                    continue
                m.flap_exempt = False
                recent = [t for t in m.restart_times
                          if now - t <= self.flap_window_s]
                if len(recent) >= self.flap_budget:
                    m.quarantined = True
                    m.next_restart_t = 0.0
                    self._registry.counter(
                        "pfx_replica_quarantines_total",
                        replica=m.rid,
                    ).inc()
                    logger.error(
                        f"QUARANTINE: replica {m.rid} (port {m.port}) "
                        f"crash-looped {len(recent)} time(s) within "
                        f"{self.flap_window_s:g}s (flap budget "
                        f"{self.flap_budget}; last rc={rc}); NOT "
                        "restarting it again — inspect "
                        f"{m.log_path or 'its log'} and redeploy, then "
                        "restart the control plane"
                    )
                    continue
                backoff = min(
                    self.backoff_max_s,
                    self.backoff_base_s * (2.0 ** len(recent)),
                )
                m.next_restart_t = now + backoff
                logger.warning(
                    f"supervisor: replica {m.rid} crashed rc={rc}; "
                    f"restart {len(recent) + 1} in {backoff:.2f}s"
                )
            elif (m.desired and not m.quarantined
                  and m.next_restart_t > 0 and now >= m.next_restart_t):
                if not m.flap_exempt:
                    m.restart_times = [
                        t for t in m.restart_times
                        if now - t <= self.flap_window_s
                    ]
                    m.restart_times.append(now)
                m.flap_exempt = False
                m.restarts += 1
                self._registry.counter(
                    "pfx_replica_restarts_total", replica=m.rid
                ).inc()
                self._spawn(m, now)

    # -- views / teardown ------------------------------------------------
    def views(self) -> List[Dict[str, Any]]:
        return [m.view() for m in self._snapshot()]

    def desired_count(self) -> int:
        return sum(1 for m in self._snapshot()
                   if m.desired and not m.quarantined)

    def quarantined_count(self) -> int:
        return sum(1 for m in self._snapshot() if m.quarantined)

    def kill_all(self) -> None:
        """Hard teardown for the force-quit path: SIGKILL every live
        child, no drain, never raises (runs on signal escape paths
        where a secondary failure must not mask the exit)."""
        for m in self._snapshot():
            if m.proc is not None:
                try:
                    m.proc.kill()
                except OSError:
                    pass
            elif m.adopted_pid is not None:
                try:
                    os.kill(m.adopted_pid, signal.SIGKILL)
                except OSError:
                    pass
                m.adopted_pid = None
                m.adopted_boot_id = None

    def stop_all(self, timeout: float = 30.0) -> None:
        """Graceful teardown: SIGTERM every live child (each drains via
        the serve CLI's contract and exits 0), kill stragglers.  Adopted
        replicas (not our children — no Popen handle) get the same
        SIGTERM and a signal-0 liveness wait."""
        live = [m for m in self._snapshot() if m.proc is not None]
        adopted = [m for m in self._snapshot()
                   if m.proc is None and m.adopted_pid is not None]
        for m in live:
            m.desired = False
            try:
                m.proc.terminate()
            except OSError:
                pass
        for m in adopted:
            m.desired = False
            try:
                os.kill(m.adopted_pid, signal.SIGTERM)
            except OSError:
                m.adopted_pid = None
                m.adopted_boot_id = None
        deadline = time.monotonic() + timeout
        for m in live:
            if m.proc is None:
                continue
            left = max(0.1, deadline - time.monotonic())
            try:
                m.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                logger.warning(
                    f"supervisor: replica {m.rid} ignored SIGTERM for "
                    f"{timeout:g}s; killing"
                )
                m.proc.kill()
                try:
                    m.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            m.proc = None
        for m in adopted:
            if m.adopted_pid is None:
                continue
            while (_pid_alive(m.adopted_pid)
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            if _pid_alive(m.adopted_pid):
                logger.warning(
                    f"supervisor: adopted replica {m.rid} ignored "
                    f"SIGTERM for {timeout:g}s; killing")
                try:
                    os.kill(m.adopted_pid, signal.SIGKILL)
                except OSError:
                    pass
            m.adopted_pid = None
            m.adopted_boot_id = None


class ElasticController:
    """The control loop: consume the router's replica snapshots, emit
    scale decisions, drive the supervisor + the authenticated remote
    drain.  ``core`` needs the RouterCore surface (``replica_views``,
    ``add_replica``, ``drain``); tests drive :meth:`tick` directly with
    injected clocks and stub cores."""

    def __init__(self, core: Any, supervisor: ReplicaSupervisor,
                 policy: ScalePolicy, *, role: str = "monolith",
                 registry: Optional[Registry] = None) -> None:
        self.core = core
        self.supervisor = supervisor
        self.policy = policy.validate()
        self.role = role
        reg = registry or get_registry()
        # disaggregated pool controllers label their counters with the
        # pool so prefill/decode decisions replay per pool; the monolith
        # fleet stays UNLABELED — the drill contracts read it that
        # way, and one monolith controller per process needs no label
        labels = {} if role == "monolith" else {"pool": role}
        self._ticks = reg.counter("pfx_controller_ticks_total", **labels)
        self._ups = reg.counter("pfx_controller_scale_ups_total", **labels)
        self._downs = reg.counter(
            "pfx_controller_scale_downs_total", **labels
        )
        self._target_gauge = reg.gauge(
            "pfx_controller_target_replicas", **labels
        )
        self._breach_gauge = reg.gauge("pfx_controller_breach", **labels)
        # bounded decision log, the replay contract (controller
        # edition): one row per tick; an untruncated log replays to
        # exact agreement with the counters (replay_controller_log)
        self.decision_log: deque = deque(
            maxlen=env_int(CONTROLLER_LOG_CAP_ENV, 4096)
        )
        # appends happen on the control thread while /debug/controller
        # handler threads snapshot — list(deque) during an append is a
        # RuntimeError without this
        self._log_lock = threading.Lock()
        self.target = self.policy.min_replicas
        self._seq = 0
        self._last_up_t = float("-inf")
        self._last_scale_t = float("-inf")
        self._idle_since: Optional[float] = None
        # optional control-plane journal (core.router.FleetJournal):
        # every tick's decision + clock AGES land in it so a restarted
        # router resumes cooldowns instead of insta-rescaling
        self.journal: Optional[Any] = None
        self._at_max_warned = False
        self._no_slot_warned = False
        self._thread = None
        self._stop = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ElasticController":
        """Bring the fleet to ``min_replicas`` and start the loop."""
        self._register(self.supervisor.ensure(self.target))
        self._target_gauge.set(float(self.target))
        if self._thread is None or not self._thread.is_alive():
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop,
                name=f"elastic-controller-{self.role}", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self.supervisor.poll()
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # one bad tick (a replica url racing its own exit, a
                # transient drain failure); crashing the control plane
                # on it would take down supervision entirely
                logger.warning(f"controller tick failed: {e}")

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _register(self, started: List[ManagedReplica]) -> None:
        for m in started:
            if m.key is None:
                m.key = self.core.add_replica(m.url, self.role)

    # -- the decision ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate one control decision; returns (and logs) the
        decision row.  Pure function of the snapshots + injected clock —
        the unit tests drive it deterministically."""
        now = time.monotonic() if now is None else float(now)
        p = self.policy
        views = [v for v in self.core.replica_views()
                 if v["role"] == self.role]
        serving = [v for v in views
                   if v["state"] == "serving" and not v["draining"]]
        coming = [v for v in views if v["state"] in ("booting", "warm")]
        breach = any(v.get("slo_breach") for v in serving)
        depth_total = sum(
            v["depth"] + (v["in_flight"] if p.count_in_flight else 0)
            for v in serving
        )
        avg_depth = depth_total / max(1, len(serving))
        occ = max((v.get("occupancy", 0.0) for v in serving), default=0.0)
        # decode-pool signal: the WORST serving replica's admissible
        # blocks (free + reclaimable, from /healthz) — a pool whose
        # tightest arena is at/below low_blocks will start bouncing
        # adoptions; None until a poll carries the field
        min_blocks = min(
            (v["available_blocks"] for v in serving
             if v.get("available_blocks") is not None),
            default=None,
        )
        depth_hot = p.use_depth and avg_depth > p.high_depth
        occ_hot = p.use_occupancy and occ > p.high_occupancy
        blocks_hot = (p.low_blocks > 0 and min_blocks is not None
                      and min_blocks <= p.low_blocks)
        pressure = breach or depth_hot or occ_hot or blocks_hot
        # zero serving replicas is an OUTAGE, not idleness: with nothing
        # serving, depth/occupancy read 0 by construction, and scaling
        # down mid-outage would retire capacity exactly when the fleet
        # is returning 503s — idle requires at least one serving replica
        idle = (bool(serving) and not pressure
                and (not p.use_depth or avg_depth <= p.low_depth)
                and (not p.use_occupancy or occ <= p.low_occupancy)
                and (p.low_blocks == 0 or min_blocks is None
                     or min_blocks > 2 * p.low_blocks))
        self._idle_since = (
            (self._idle_since if self._idle_since is not None else now)
            if idle else None
        )

        action, reason = "hold", ""
        if pressure:
            why = ("slo burn-rate breach" if breach
                   else f"avg depth {avg_depth:.2f} > {p.high_depth:g}"
                   if depth_hot
                   else f"occupancy {occ:.2f} > {p.high_occupancy:g}"
                   if occ_hot
                   else f"available blocks {min_blocks} <= "
                        f"{p.low_blocks} (arena pressure)")
            if self.target >= p.max_replicas:
                reason = f"{why}, but at max_replicas {p.max_replicas}"
                if not self._at_max_warned:
                    self._at_max_warned = True
                    logger.warning(
                        f"controller: {reason} — the fleet cannot absorb "
                        "more load; raise --max-replicas or add hosts"
                    )
            elif coming:
                # a spawned replica is still walking booting -> serving:
                # let it land before deciding the fleet is still short
                reason = f"{why}; {len(coming)} replica(s) still warming"
            elif now - self._last_up_t < p.up_cooldown_s:
                reason = f"{why}; up-cooldown"
            else:
                started = self.supervisor.ensure(self.target + 1, now)
                if started:
                    action, reason = "scale_up", why
                    self.target += 1
                    self._last_up_t = self._last_scale_t = now
                    self._at_max_warned = False
                    self._no_slot_warned = False
                    self._register(started)
                else:
                    # every remaining slot is quarantined: a scale-up
                    # that spawns nothing must not move the target or
                    # the counters — the decision log records reality
                    reason = (
                        f"{why}, but no spawnable slot "
                        f"({self.supervisor.quarantined_count()} "
                        "quarantined)"
                    )
                    if not self._no_slot_warned:
                        self._no_slot_warned = True
                        logger.warning(
                            f"controller: {reason} — redeploy the "
                            "quarantined replica(s) and restart the "
                            "control plane"
                        )
        elif (idle and self.target > p.min_replicas
              and now - self._idle_since >= p.idle_s
              and now - self._last_scale_t >= p.down_cooldown_s):
            m = self.supervisor.pick_drain_slot()
            if m is not None and m.key is not None:
                action = "scale_down"
                reason = (f"idle {now - self._idle_since:.0f}s "
                          f"(avg depth {avg_depth:.2f}, occ {occ:.2f})")
                self.target -= 1
                self._last_scale_t = now
                self._idle_since = None
                self.supervisor.drain_slot(m.slot)
                try:
                    self.core.drain(m.key)
                except ValueError as e:
                    # already gone / auth misconfig: the slot stays
                    # retired (desired=False) either way, loudly
                    logger.warning(
                        f"controller: drain of {m.key} failed: {e}"
                    )

        self._seq += 1
        row = {
            "tick": self._seq,
            "t": round(now, 3),
            # the pool this row belongs to: disaggregated control planes
            # run one controller per pool, and a per-pool replay must
            # fold each pool's rows into ITS labeled counters
            "pool": self.role,
            "action": action,
            "reason": reason,
            "target": self.target,
            "serving": len(serving),
            "warming": len(coming),
            "breach": breach,
            "avg_depth": round(avg_depth, 3),
            "occupancy": round(occ, 3),
            "min_blocks": min_blocks,
            "quarantined": self.supervisor.quarantined_count(),
        }
        with self._log_lock:
            self.decision_log.append(row)
        j = self.journal
        if j is not None:
            # ages, not clock values: monotonic clocks never cross a
            # process boundary — restore_clocks rebases them as
            # new_now - (age + death window)
            j.record(
                "scale", pool=self.role, action=action, reason=reason,
                target=self.target, tick=self._seq, serving=len(serving),
                up_age_s=(round(now - self._last_up_t, 3)
                          if self._last_up_t != float("-inf") else None),
                scale_age_s=(round(now - self._last_scale_t, 3)
                             if self._last_scale_t != float("-inf")
                             else None),
                idle_for_s=(round(now - self._idle_since, 3)
                            if self._idle_since is not None else None),
            )
        self._ticks.inc()
        if action == "scale_up":
            self._ups.inc()
        elif action == "scale_down":
            self._downs.inc()
        self._target_gauge.set(float(self.target))
        self._breach_gauge.set(1.0 if pressure else 0.0)
        return row

    def journal_state(self) -> Dict[str, Any]:
        """This controller's journal-snapshot row — the same age-based
        clock encoding tick()'s ``scale`` records use, consumed by
        :meth:`restore_clocks` on the next boot."""
        now = time.monotonic()
        return {
            "target": self.target,
            "tick": self._seq,
            "up_age_s": (round(now - self._last_up_t, 3)
                         if self._last_up_t != float("-inf") else None),
            "scale_age_s": (round(now - self._last_scale_t, 3)
                            if self._last_scale_t != float("-inf")
                            else None),
            "idle_for_s": (round(now - self._idle_since, 3)
                           if self._idle_since is not None else None),
        }

    def restore_clocks(self, *, target: Optional[int] = None,
                       tick: Optional[int] = None,
                       up_age_s: Optional[float] = None,
                       scale_age_s: Optional[float] = None,
                       extra_age_s: float = 0.0) -> None:
        """Resume from a journaled ``scale`` record (router restart):
        the target is clamped into the current policy's bounds, the tick
        sequence continues instead of restarting at 0, and the cooldown
        clocks rebase as ``now - (journaled age + extra_age_s)`` where
        ``extra_age_s`` is the death window — real wall time passed, so
        cooldowns neither reset (which would allow an instant re-scale)
        nor freeze.  The idle dwell is deliberately NOT restored:
        idleness was not observed across the death window, and a restart
        must never open with a scale-down."""
        now = time.monotonic()
        p = self.policy
        extra = max(0.0, float(extra_age_s))
        if target is not None:
            try:
                self.target = max(p.min_replicas,
                                  min(p.max_replicas, int(target)))
            except (TypeError, ValueError):
                pass
        if tick is not None:
            try:
                self._seq = max(self._seq, int(tick))
            except (TypeError, ValueError):
                pass
        if up_age_s is not None:
            try:
                self._last_up_t = now - (max(0.0, float(up_age_s))
                                         + extra)
            except (TypeError, ValueError):
                pass
        if scale_age_s is not None:
            try:
                self._last_scale_t = now - (max(0.0, float(scale_age_s))
                                            + extra)
            except (TypeError, ValueError):
                pass
        self._idle_since = None
        self._target_gauge.set(float(self.target))
        logger.info(
            f"controller[{self.role}]: clocks restored from the fleet "
            f"journal (target {self.target}, tick {self._seq}, death "
            f"window {extra:.1f}s)")

    def view(self) -> Dict[str, Any]:
        """Operator snapshot for GET /debug/controller (auth-gated)."""
        with self._log_lock:
            decisions = list(self.decision_log)
        return {
            "policy": self.policy.view(),
            "target": self.target,
            "decisions": decisions,
            "replicas": self.supervisor.views(),
        }


def replay_controller_log(rows, pool: Optional[str] = None
                          ) -> Dict[str, int]:
    """Fold controller decision rows back into the counters they must
    reproduce (the replay contract): on a run whose log was not
    truncated, ``ticks`` == pfx_controller_ticks_total, ``scale_ups`` ==
    pfx_controller_scale_ups_total and ``scale_downs`` ==
    pfx_controller_scale_downs_total — a scale action the log cannot
    explain shows up as a mismatch.  ``pool`` restricts the fold to one
    pool's rows (rows predating the field count as monolith), matching
    the ``pool``-labeled counters a disaggregated control plane keeps
    per pool."""
    out = {"ticks": 0, "scale_ups": 0, "scale_downs": 0, "holds": 0}
    for row in rows:
        if pool is not None and row.get("pool", "monolith") != pool:
            continue
        out["ticks"] += 1
        action = row.get("action")
        if action == "scale_up":
            out["scale_ups"] += 1
        elif action == "scale_down":
            out["scale_downs"] += 1
        else:
            out["holds"] += 1
    return out
