"""The parts of ``paddlefleetx_tpu/utils/resilience.py`` that the port
runs: ``PreemptionGuard:438`` (SIGTERM/SIGINT -> a flag the training loop
polls; the loop finishes the step, checkpoints with a ``preempted``
marker and returns, and the launcher exits 0), ``AnomalyGuard:497``
(budgets on non-finite streaks and loss spikes, past which the engine
rolls back to the last checkpoint), and the fault-injection harness
(``FAULT_SITES:239``, ``reset_fault_state:260``, ``fault_spec:265``,
``maybe_fire:318``): ``PFX_FAULT=<site>:<step>[:<count>]`` fires a named
fault at a step, at most ``count`` times a process.

The serving path wires seven sites (:data:`SERVING_FAULT_SITES`).
``maybe_fire`` carries out four of them, with the JAX behavior
(``resilience.py:344-379``): ``gen_crash`` raises ``RuntimeError``
inside generation request K, ``gen_hang`` and ``cb_step_hang`` sleep
``PFX_FAULT_HANG_S`` seconds (default 3600) inside generation request K
or before continuous decode step K, and ``boot_crash`` hard-exits the
serve CLI with code 23 right after argument parsing.  The other three
live at their call sites (``maybe_fire`` only counts and reports):
``preempt_storm`` (the continuous scheduler force-preempts its
lowest-priority eligible row at that iteration), ``spill_corrupt`` (the
engine's Kth spill readmit probe finds its host copy torn) and
``cb_commit_crash`` (the engine's commit of step K raises).  The serve
CLI refuses every other site at boot (:func:`serving_fault_spec`); the
training engine refuses ``PFX_FAULT`` altogether.  Not ported: the I/O
retry wrapper.
"""

from __future__ import annotations

import collections
import math
import os
import signal
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.telemetry import env_float


class PreemptionGuard:
    """SIGTERM/SIGINT -> ``requested``.  The handler only records the
    request; the first signal also restores the original handlers, so a
    second one kills or interrupts the ordinary way (the escape hatch
    when the in-flight step is wedged)."""

    def __init__(self) -> None:
        self.requested = False
        self.signum: Optional[int] = None
        self._orig: Dict[int, Any] = {}
        self.installed = False

    def install(self) -> "PreemptionGuard":
        def handler(signum, frame):
            self.requested = True
            self.signum = signum
            for sig, orig in self._orig.items():
                signal.signal(sig, orig)
            logger.warning(f"received signal {signum}: finishing the in-flight step, "
                           "checkpointing, then exiting cleanly (send again to force-quit)")

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._orig[sig] = signal.signal(sig, handler)
            self.installed = True
        except ValueError:
            # signal.signal works on the main thread only
            logger.warning("preemption handlers unavailable off the main thread; SIGTERM "
                           "will kill this run without a final checkpoint")
        return self

    def uninstall(self) -> None:
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)
        self._orig.clear()
        self.installed = False


class AnomalyGuard:
    """Budgeted anomaly detector over the per-step (loss, skipped) stream.

    Either detector trips: ``max_skip_streak`` consecutive non-finite
    steps, or a loss whose z-score against a rolling window of recent
    finite losses exceeds ``spike_zscore`` for ``spike_streak`` steps in a
    row (off while the window holds fewer than ``min_window`` losses, or
    when ``spike_zscore`` <= 0).  ``observe`` returns None (healthy) or
    the reason."""

    def __init__(self, max_skip_streak: int = 10, spike_zscore: float = 0.0,
                 spike_streak: int = 5, window: int = 64, min_window: int = 16) -> None:
        self.max_skip_streak = int(max_skip_streak)
        self.spike_zscore = float(spike_zscore)
        self.spike_streak_budget = int(spike_streak)
        self.min_window = int(min_window)
        self.losses: collections.deque = collections.deque(maxlen=int(window))
        self.skip_streak = 0
        self.spike_streak = 0

    def reset(self) -> None:
        """Forget all history (after a rollback)."""
        self.losses.clear()
        self.skip_streak = 0
        self.spike_streak = 0

    def observe(self, loss: float, skipped: bool) -> Optional[str]:
        if skipped or not math.isfinite(loss):
            self.skip_streak += 1
            if self.max_skip_streak and self.skip_streak >= self.max_skip_streak:
                return (f"{self.skip_streak} consecutive non-finite steps "
                        f"(budget {self.max_skip_streak})")
            return None
        self.skip_streak = 0
        if self.spike_zscore > 0 and len(self.losses) >= self.min_window:
            mean = float(np.mean(self.losses))
            std = float(np.std(self.losses))
            z = (loss - mean) / std if std > 1e-12 else 0.0
            if z > self.spike_zscore:
                self.spike_streak += 1
                if self.spike_streak >= self.spike_streak_budget:
                    return (f"loss spike z={z:.1f} for {self.spike_streak} consecutive steps "
                            f"(threshold {self.spike_zscore}, budget "
                            f"{self.spike_streak_budget})")
                # a spiking loss stays out of the window
                return None
            self.spike_streak = 0
        self.losses.append(loss)
        return None


# ---------------------------------------------------------------------------
# fault injection harness
# ---------------------------------------------------------------------------

# the JAX package's site names, so a PFX_FAULT value parses (or fails)
# the same way on either side
FAULT_SITES = (
    "sigterm", "save_crash", "ckpt_truncate", "nan_grads",
    "gen_crash", "gen_hang", "cb_step_hang", "boot_crash",
    "corrupt_sample", "io_stall", "handoff_drop", "adopt_crash",
    "cb_commit_crash", "spill_corrupt", "migrate_stall",
    "preempt_storm",
)
# the sites the port's serving path wires (cb_commit_crash: the continuous
# engine's commit raises "PFX_FAULT: injected cb_commit_crash at step K", the
# JAX message, where a dispatched step's readback would fail); the KV
# handoff and migration sites stay refused with the handoff itself
SERVING_FAULT_SITES = ("preempt_storm", "spill_corrupt", "cb_commit_crash",
                       "gen_crash", "gen_hang", "cb_step_hang", "boot_crash")

# fires per site in THIS process; a relaunched process starts clean
_fires: Dict[str, int] = {}


def reset_fault_state() -> None:
    """Clear the per-process fire counters (test isolation)."""
    _fires.clear()


def fault_spec() -> Optional[Tuple[str, int, int]]:
    """Parse ``PFX_FAULT=<site>:<step>[:<count>]`` (None when unset).

    Loud: an unknown site or a non-integer field raises at once, since an
    injection that silently never fires would pass a drill that exercised
    nothing.  ``io_stall``'s third field is seconds, not a count, and its
    fire count is always 1."""
    raw = os.environ.get("PFX_FAULT") or ""
    if not raw.strip():
        return None
    parts = raw.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"PFX_FAULT={raw!r}; expected <site>:<step>[:<count>] with "
            f"site in {FAULT_SITES}"
        )
    site = parts[0]
    if site not in FAULT_SITES:
        raise ValueError(
            f"PFX_FAULT site {site!r} unknown; valid: {', '.join(FAULT_SITES)}"
        )
    try:
        step = int(parts[1])
        if site == "io_stall":
            if len(parts) == 3:
                float(parts[2])  # loud-parse the seconds field here too
            count = 1
        else:
            count = int(parts[2]) if len(parts) == 3 else 1
    except ValueError:
        raise ValueError(
            f"PFX_FAULT={raw!r}: step/count must be integers "
            "(io_stall's third field: seconds, int or float)"
        ) from None
    if count < 1:
        raise ValueError(f"PFX_FAULT={raw!r}: count must be >= 1")
    return site, step, count


def serving_fault_spec() -> Optional[Tuple[str, int, int]]:
    """:func:`fault_spec` for the serve CLI's boot: a value that does not
    parse raises its ValueError, and a site the serving path does not
    wire raises NotImplementedError (a drill against it would exercise
    nothing)."""
    spec = fault_spec()
    if spec is not None and spec[0] not in SERVING_FAULT_SITES:
        raise NotImplementedError(
            f"PFX_FAULT site {spec[0]!r} is not wired into the PyTorch port's serving "
            f"path; wired: {', '.join(SERVING_FAULT_SITES)}"
        )
    return spec


def maybe_fire(site: str, step: int) -> bool:
    """True when the configured fault names ``site`` and ``step`` has
    reached its step, at most ``count`` times a process.  ``gen_crash``
    raises, ``gen_hang`` / ``cb_step_hang`` sleep ``PFX_FAULT_HANG_S``
    seconds and ``boot_crash`` does not return; for every other site the
    caller carries out the fault."""
    spec = fault_spec()
    if spec is None or spec[0] != site or step < spec[1]:
        return False
    if _fires.get(site, 0) >= spec[2]:
        return False
    _fires[site] = _fires.get(site, 0) + 1
    logger.warning(f"PFX_FAULT: firing {site} at step {step} ({_fires[site]}/{spec[2]})")
    if site == "gen_crash":
        raise RuntimeError(f"PFX_FAULT: injected gen_crash at request {step}")
    if site in ("gen_hang", "cb_step_hang"):
        # a wedged decode: the serve watchdog flips /healthz to degraded
        time.sleep(env_float("PFX_FAULT_HANG_S", 3600.0))
    elif site == "boot_crash":
        # a replica that can never come up: os._exit skips every finally
        # and atexit, the closest in-process stand-in for a broken image
        os._exit(23)
    return True
