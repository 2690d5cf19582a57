"""Multi-tenant vocabulary of the serving path: labels, quotas and the
weighted-fair pick.

Counterpart of ``paddlefleetx_tpu/core/tenancy.py``, all of it, host code
with no tensors.  Both schedulers of the port (``core/request_queue.py``,
``core/continuous_batching.py``) and the serve CLI import from here, so
the config file, the header names and the fairness math cannot drift:

  - **Labels**: requests carry ``X-Tenant`` / ``X-Priority`` headers.
    :func:`normalize_tenant` maps a raw header onto a bounded,
    metrics-safe alphabet (unknown or empty -> ``anon``);
    :func:`parse_priority` clamps priorities to [-100, 100] with 0 as
    the neutral default.
  - **TenantConfig**: one JSON file (``--tenants path``) of fair-share
    weights and quotas::

        {"default": {"weight": 1.0},
         "tenants": {"gold": {"weight": 4, "rps": 50, "burst": 100,
                              "max_inflight": 32}}}

    Absent fields mean no limit (the default config admits everything:
    a single-tenant deployment pays nothing).  Parse errors are loud.
  - **TokenBucket / TenantAdmission**: per-tenant request-rate and
    in-flight caps for a front door (the port has no router yet).  A
    rate rejection returns the bucket's actual time to the next token,
    so a 429's Retry-After is honest.
  - **DeficitRoundRobin**: the weighted-fair pick of both schedulers'
    admission loops: each replenish round grants every backlogged
    tenant ``quantum * weight`` deficit, a pick costs 1, and an idle
    tenant's deficit resets (classic DRR, Shreedhar & Varghese 1996).
    Starvation-free: every replenish grows every backlogged tenant's
    deficit.  FCFS order within a tenant is the caller's.
  - **TenantLabelCap**: tenants are unbounded, metric label cardinality
    must not be: the first ``PFX_TENANT_LABEL_TOPK`` distinct tenants
    (config-declared tenants seeded first) keep their own label, later
    ones fold into ``__other__``.  A tenant never changes buckets once
    assigned, so per-label counters stay monotonic.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from paddlefleetx_tpu_torch.utils.log import logger

# Header names carried verbatim across every hop (router dispatch
# retries, re-prefill failover, direct prefill->decode handoff).
TENANT_HEADER = "X-Tenant"
PRIORITY_HEADER = "X-Priority"

# The label every unlabeled request lands on.  A deployment that never
# sends X-Tenant runs exactly as before: one tenant, default weight, no
# quotas.
DEFAULT_TENANT = "anon"

# The fold-bucket for tenants past the top-k label cap.
OVERFLOW_TENANT = "__other__"

_TENANT_SAFE_RE = re.compile(r"[^A-Za-z0-9_.:-]")
_TENANT_MAX_LEN = 64

PRIORITY_MIN = -100
PRIORITY_MAX = 100


def normalize_tenant(raw: Optional[str]) -> str:
    """Map a raw ``X-Tenant`` header value onto the bounded, metrics-safe
    tenant alphabet.  Empty/missing -> :data:`DEFAULT_TENANT`."""
    if raw is None:
        return DEFAULT_TENANT
    cleaned = _TENANT_SAFE_RE.sub("_", raw.strip())[:_TENANT_MAX_LEN]
    return cleaned or DEFAULT_TENANT


def parse_priority(raw: Optional[str]) -> int:
    """Parse an ``X-Priority`` header: int, clamped to [-100, 100];
    missing/garbage -> 0 (never a 500 off a malformed header)."""
    if raw is None:
        return 0
    try:
        val = int(str(raw).strip())
    except ValueError:
        return 0
    return max(PRIORITY_MIN, min(PRIORITY_MAX, val))


@dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant knobs.  ``None`` means no limit for that axis."""

    weight: float = 1.0
    rps: Optional[float] = None
    burst: Optional[float] = None
    max_inflight: Optional[int] = None

    def __post_init__(self) -> None:
        if not (self.weight > 0.0):
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.rps is not None and not (self.rps > 0.0):
            raise ValueError(
                f"tenant rps must be > 0 when set, got {self.rps} "
                f"(omit it for 'no rate limit')"
            )
        if self.burst is not None and not (self.burst >= 1.0):
            raise ValueError(f"tenant burst must be >= 1, got {self.burst}")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError(
                f"tenant max_inflight must be >= 1, got {self.max_inflight}"
            )


_POLICY_FIELDS = ("weight", "rps", "burst", "max_inflight")


def _policy_from_obj(obj: Dict, where: str) -> TenantPolicy:
    if not isinstance(obj, dict):
        raise ValueError(f"{where}: expected an object, got {type(obj).__name__}")
    unknown = sorted(set(obj) - set(_POLICY_FIELDS))
    if unknown:
        raise ValueError(f"{where}: unknown keys {unknown} (valid: {_POLICY_FIELDS})")
    kwargs = {}
    for key in _POLICY_FIELDS:
        if key in obj and obj[key] is not None:
            kwargs[key] = obj[key]
    try:
        return TenantPolicy(**kwargs)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"{where}: {exc}") from None


class TenantConfig:
    """The one tenant policy table: default policy + per-tenant overrides.

    Parsed from the JSON shape documented in the module docstring; the
    same object feeds router quotas, scheduler weights, and the label
    cap's seed set.
    """

    def __init__(self, default: Optional[TenantPolicy] = None,
                 tenants: Optional[Dict[str, TenantPolicy]] = None) -> None:
        self.default = default or TenantPolicy()
        self.tenants: Dict[str, TenantPolicy] = dict(tenants or {})

    def policy(self, tenant: str) -> TenantPolicy:
        return self.tenants.get(tenant, self.default)

    def weight(self, tenant: str) -> float:
        return self.policy(tenant).weight

    def known_tenants(self) -> List[str]:
        """Config-declared tenants in declaration order (label-cap seed)."""
        return list(self.tenants)

    @classmethod
    def from_obj(cls, obj: Dict, where: str = "tenants config") -> "TenantConfig":
        if not isinstance(obj, dict):
            raise ValueError(f"{where}: expected a JSON object at the top level")
        unknown = sorted(set(obj) - {"default", "tenants"})
        if unknown:
            raise ValueError(
                f"{where}: unknown top-level keys {unknown} "
                f"(valid: 'default', 'tenants')"
            )
        default = _policy_from_obj(obj.get("default", {}), f"{where}.default")
        tenants: Dict[str, TenantPolicy] = {}
        for name, spec in (obj.get("tenants") or {}).items():
            key = normalize_tenant(name)
            if key != name:
                raise ValueError(
                    f"{where}.tenants[{name!r}]: tenant names must already be "
                    f"label-safe (normalized form: {key!r})"
                )
            tenants[key] = _policy_from_obj(spec, f"{where}.tenants[{name!r}]")
        return cls(default=default, tenants=tenants)

    @classmethod
    def from_file(cls, path: str) -> "TenantConfig":
        try:
            with open(path, "r", encoding="utf-8") as fh:
                obj = json.load(fh)
        except OSError as exc:
            raise ValueError(f"tenants config {path!r}: {exc}") from None
        except json.JSONDecodeError as exc:
            raise ValueError(f"tenants config {path!r}: invalid JSON: {exc}") from None
        cfg = cls.from_obj(obj, where=path)
        logger.info(
            f"tenants config {path}: {len(cfg.tenants)} tenant(s) declared, "
            f"default weight {cfg.default.weight}"
        )
        return cfg


class TokenBucket:
    """Monotonic-clock token bucket.  NOT thread-safe on its own — the
    owning :class:`TenantAdmission` serializes access."""

    def __init__(self, rate: float, burst: Optional[float] = None) -> None:
        if not (rate > 0.0):
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, self.rate)
        self.tokens = self.burst
        self._t_last: Optional[float] = None

    def refill(self, now: float) -> None:
        """Advance the refill clock to ``now`` without consuming — the
        snapshot path uses it so journaled token counts are current as
        of the snapshot instant, not as of the tenant's last request."""
        if self._t_last is None:
            self._t_last = now
        elapsed = max(0.0, now - self._t_last)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self._t_last = now

    def try_acquire(self, now: float) -> Tuple[bool, float]:
        """Take one token.  Returns ``(ok, retry_after_s)`` where
        ``retry_after_s`` is the ACTUAL time until the next whole token
        refills (0.0 on success) — the honest Retry-After."""
        self.refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        return False, (1.0 - self.tokens) / self.rate


class TenantAdmission:
    """The router front door's per-tenant quota gate: request-rate token
    buckets plus in-flight caps, all from one :class:`TenantConfig`.

    ``admit`` / ``release`` bracket a request exactly like the router's
    global acquire/release; an unlimited tenant (the default policy)
    takes one dict lookup and returns.
    """

    def __init__(self, config: Optional[TenantConfig] = None,
                 clock=time.monotonic) -> None:
        self.config = config or TenantConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._inflight: Dict[str, int] = {}

    def admit(self, tenant: str) -> Tuple[bool, str, float]:
        """Returns ``(ok, reason, retry_after_s)``.  Reasons: ``rate``
        (bucket empty; retry_after is the real refill time) or
        ``inflight`` (cap reached; retry_after estimates one token
        interval, or 1.0 for rate-unlimited tenants).  On ``ok`` the
        tenant's in-flight count is already incremented — callers MUST
        pair with :meth:`release`."""
        pol = self.config.policy(tenant)
        with self._lock:
            if (pol.max_inflight is not None
                    and self._inflight.get(tenant, 0) >= pol.max_inflight):
                retry = 1.0 if pol.rps is None else 1.0 / pol.rps
                return False, "inflight", retry
            if pol.rps is not None:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = TokenBucket(pol.rps, pol.burst)
                    self._buckets[tenant] = bucket
                ok, retry = bucket.try_acquire(self._clock())
                if not ok:
                    return False, "rate", retry
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        return True, "", 0.0

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 0) - 1
            if n > 0:
                self._inflight[tenant] = n
            else:
                self._inflight.pop(tenant, None)

    def inflight_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._inflight)

    # -- control-plane journal surface (core/router.py FleetJournal) ----
    def bucket_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant token-bucket state for the control-plane journal
        (docs/serving.md "Control-plane recovery"): tokens are refilled
        to NOW first, so the snapshot is current at the instant it is
        taken and restorers only need the wall-clock age of the record
        — the monotonic refill clock never leaves this process."""
        with self._lock:
            now = self._clock()
            out: Dict[str, Dict[str, float]] = {}
            for tn, b in self._buckets.items():
                b.refill(now)
                out[tn] = {
                    "tokens": round(b.tokens, 6),
                    "rate": b.rate,
                    "burst": b.burst,
                }
            return out

    def restore_buckets(self, buckets: Dict[str, Dict[str, float]],
                        age_s: float = 0.0) -> int:
        """Fold a journaled :meth:`bucket_snapshot` back in (router
        restart): each tenant's bucket resumes from its recorded token
        count plus ``age_s`` seconds of refill at the CURRENTLY
        configured rate — the router's death window earns exactly the
        refill it would have earned, never a fresh burst allowance
        (that free window is the 429-storm hole this closes).  Tenants
        whose current config no longer rate-limits are skipped (the
        operator's new config wins); rate/burst come from the current
        policy, not the journal, for the same reason.  Returns the
        number of buckets restored."""
        restored = 0
        with self._lock:
            now = self._clock()
            for tn, snap in (buckets or {}).items():
                pol = self.config.policy(str(tn))
                if pol.rps is None:
                    continue
                try:
                    tokens = float(snap.get("tokens", 0.0))
                except (TypeError, ValueError, AttributeError):
                    continue
                b = TokenBucket(pol.rps, pol.burst)
                b.tokens = min(
                    b.burst,
                    max(0.0, tokens) + max(0.0, float(age_s)) * b.rate,
                )
                b._t_last = now
                self._buckets[str(tn)] = b
                restored += 1
        return restored


class DeficitRoundRobin:
    """Weighted-fair tenant pick for an admission loop.

    Usage: ``pick(backlog)`` with ``{tenant: waiting_count}`` returns
    the tenant to serve next (or ``None`` if nothing waits); the caller
    admits that tenant's OLDEST entry (FCFS within tenant) and calls
    ``charge(tenant)``.  Deficit state for tenants with no backlog is
    dropped (classic DRR reset), so a returning tenant starts fresh
    rather than cashing in idle time.
    """

    def __init__(self, weight_fn=None, quantum: float = 1.0) -> None:
        self._weight_fn = weight_fn or (lambda tenant: 1.0)
        self.quantum = max(1e-6, float(quantum))
        # insertion-ordered: first-seen order breaks deficit ties, so
        # the pick is deterministic for the decision-log replay
        self._deficit: Dict[str, float] = {}

    def pick(self, backlog: Dict[str, int]) -> Optional[str]:
        active = [t for t, n in backlog.items() if n > 0]
        if not active:
            return None
        active_set = set(active)
        for t in list(self._deficit):
            if t not in active_set:
                del self._deficit[t]
        for t in active:
            self._deficit.setdefault(t, 0.0)
        # every replenish adds quantum*weight (> 0) to every backlogged
        # tenant, so the worst case to cross cost=1 is bounded by the
        # smallest weight; the cap below is generous headroom over that
        max_rounds = int(2 + 1.0 / (self.quantum * min(
            max(1e-6, float(self._weight_fn(t))) for t in active
        )))
        for _ in range(max_rounds):
            best = None
            for t in self._deficit:  # insertion order breaks ties
                if t in active_set and (best is None
                                        or self._deficit[t] > self._deficit[best]):
                    best = t
            if best is not None and self._deficit[best] >= 1.0:
                return best
            for t in active:
                self._deficit[t] += self.quantum * max(
                    1e-6, float(self._weight_fn(t))
                )
        return best  # unreachable in practice; never None (active nonempty)

    def charge(self, tenant: str, cost: float = 1.0) -> None:
        if tenant in self._deficit:
            self._deficit[tenant] -= cost


class TenantLabelCap:
    """First-K-distinct tenant -> metric label fold (the label
    cardinality cap).  Config-declared tenants are seeded first so the
    tenants an operator actually configured never fold into
    ``__other__`` (as long as they fit in K)."""

    def __init__(self, topk: Optional[int] = None,
                 seed: Sequence[str] = ()) -> None:
        if topk is None:
            raw = os.environ.get("PFX_TENANT_LABEL_TOPK") or ""
            if raw.strip():
                try:
                    topk = int(raw)
                except ValueError:
                    raise ValueError(
                        f"PFX_TENANT_LABEL_TOPK={raw!r} is not an int "
                        f"(loud-parse: unset it or pass a valid value)"
                    ) from None
                if topk < 1:
                    raise ValueError(
                        f"PFX_TENANT_LABEL_TOPK={topk} must be >= 1"
                    )
            else:
                topk = 8
        self.topk = topk
        self._lock = threading.Lock()
        self._known: Dict[str, None] = {}
        for t in seed:
            if len(self._known) >= self.topk:
                break
            self._known.setdefault(normalize_tenant(t), None)

    def label(self, tenant: str) -> str:
        """The metric label for ``tenant``: itself while distinct-tenant
        count stays within top-k, else the overflow bucket.  Stable per
        tenant for the life of the process (monotonic counters)."""
        with self._lock:
            if tenant in self._known:
                return tenant
            if len(self._known) < self.topk:
                self._known[tenant] = None
                return tenant
        return OVERFLOW_TENANT

    def labels(self) -> List[str]:
        with self._lock:
            return list(self._known)
