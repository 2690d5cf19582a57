"""The parts of ``paddlefleetx_tpu/utils/resilience.py`` that
``Engine.fit`` uses: ``PreemptionGuard:438`` (SIGTERM/SIGINT -> a flag the
loop polls; the loop finishes the step, checkpoints with a ``preempted``
marker and returns, and the launcher exits 0) and ``AnomalyGuard:497``
(budgets on non-finite streaks and loss spikes, past which the engine
rolls back to the last checkpoint).

Not ported: the fault-injection harness (``PFX_FAULT``, refused by the
engine when set) and the I/O retry wrapper.
"""

from __future__ import annotations

import collections
import math
import signal
from typing import Any, Dict, Optional

import numpy as np

from paddlefleetx_tpu_torch.utils.log import logger


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
