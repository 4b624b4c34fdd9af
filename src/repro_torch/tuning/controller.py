"""Closed-loop hysteresis control — placement driven by realized QoS.

The open-loop serving horizon fixes the :class:`~repro_torch.core.dynamic
.DynamicPlacer` knobs for the whole run; the sweep grids over
``(switching_cost × stickiness)`` then tell us *offline* which settings
were good (see :mod:`repro_torch.tuning.fit`). This module closes the loop
*online*: :class:`FeedbackPlacer` wraps a ``DynamicPlacer`` and adapts the
stickiness bonus between control ticks from the previous ticks' realized
serving statistics — the paper's §VII "dynamic extension", driven by
measurement instead of a hand-picked σ model.

Control law (deterministic, no RNG):

* the horizon loop reports, after every tick, the mean realized QoS and
  deadline-miss rate of the requests that *completed* during that tick
  (the only signal a real controller has — still-queued work is unknown);
* both signals are EWMA-smoothed (:attr:`FeedbackPlacer.ewma`);
* **multiplicative increase**: when the smoothed miss rate exceeds
  :attr:`target_miss`, latency is suffering — churn (cold starts) and
  queue resets make it worse, never better, so the stickiness bonus is
  multiplied by :attr:`gain` to suppress re-placement;
* **multiplicative decrease**: when misses are under target but the
  smoothed QoS is *declining* (below its own longer-horizon baseline by
  more than :attr:`qos_margin`), the placement has gone stale — resident
  implementations no longer match demand — so stickiness is divided by
  :attr:`gain` and the placer tracks the workload again;
* the bonus is always clamped to ``[STICKINESS_MIN, STICKINESS_MAX]``.

Everything is a pure function of the observation sequence, so a feedback
horizon run stays byte-identical on replay (the ``repro_torch.sweeps``
resume contract), and byte-identical to the reference's
(:mod:`repro.tuning.controller`): the same float64 EWMA arithmetic in the
same order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.dynamic import DynamicPlacer
from repro_torch.core.instance import PIESInstance

__all__ = ["STICKINESS_MIN", "STICKINESS_MAX", "FeedbackPlacer"]

#: Hard clamp on the adapted stickiness bonus. The lower bound is 0 (a
#: negative bonus would *penalize* residency — that is eviction pressure,
#: not hysteresis); the upper bound caps lock-in so a placement can always
#: be displaced by a large enough QoS gap.
STICKINESS_MIN = 0.0
STICKINESS_MAX = 12.0

#: Smallest stickiness a multiplicative *increase* lands on (see
#: :meth:`FeedbackPlacer.observe`).
_INCREASE_FLOOR = 0.25


@dataclasses.dataclass
class FeedbackPlacer:
    """A :class:`DynamicPlacer` whose stickiness adapts to realized QoS.

    Drop-in for ``DynamicPlacer`` in the serving horizon: :meth:`step`
    has the same ``(x, value, n_loads)`` contract and exposes the same
    ``new_loads`` / ``evicted`` masks; the extra surface is
    :meth:`observe`, which the horizon calls once per tick with the tick's
    realized completion statistics.
    """

    switching_cost: float = 2.0
    stickiness: float = 3.0        # initial bonus (adapted online)
    gain: float = 1.5              # multiplicative step, > 1
    ewma: float = 0.5              # smoothing of the per-tick signals
    target_miss: float = 0.05      # acceptable deadline-miss rate
    qos_margin: float = 0.02       # QoS decline that triggers decrease

    def __post_init__(self):
        if not self.gain > 1.0:
            raise ValueError(f"gain must be > 1, got {self.gain}")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {self.ewma}")
        self._placer = DynamicPlacer(self.switching_cost, self.stickiness)
        self._s = float(np.clip(self.stickiness,
                                STICKINESS_MIN, STICKINESS_MAX))
        self._miss_ewma = 0.0
        self._qos_ewma: Optional[float] = None      # fast signal
        self._qos_baseline: Optional[float] = None  # slow reference
        #: stickiness actually applied at each step() (for tests/reports)
        self.history: List[float] = []

    # -- DynamicPlacer surface ---------------------------------------------
    @property
    def current_stickiness(self) -> float:
        return self._s

    @property
    def new_loads(self):
        return self._placer.new_loads

    @property
    def evicted(self):
        return self._placer.evicted

    def step(self, inst: PIESInstance, Q: Optional[np.ndarray] = None):
        """One control tick under the *current* adapted stickiness."""
        self._placer.stickiness = self._s
        self.history.append(self._s)
        return self._placer.step(inst, Q)

    # -- the feedback law --------------------------------------------------
    def observe(self, mean_qos: float, miss_rate: float,
                n_completed: int) -> float:
        """Fold one tick's realized statistics into the next stickiness.

        ``mean_qos``/``miss_rate`` are over the requests that *completed*
        during the tick; a tick with no completions (``n_completed == 0``)
        carries no signal and leaves the controller untouched. Returns the
        stickiness that the next :meth:`step` will apply.
        """
        if n_completed <= 0:
            return self._s
        a = self.ewma
        self._miss_ewma = (1.0 - a) * self._miss_ewma + a * float(miss_rate)
        if self._qos_ewma is None:
            self._qos_ewma = self._qos_baseline = float(mean_qos)
        else:
            self._qos_ewma = (1.0 - a) * self._qos_ewma + a * float(mean_qos)
            # the baseline moves an order of magnitude slower than the
            # signal, so "QoS below baseline" means decline, not noise
            b = a * 0.1
            self._qos_baseline = ((1.0 - b) * self._qos_baseline
                                  + b * float(mean_qos))
        if self._miss_ewma > self.target_miss:
            # churn hurts latency: lock in. The max() floor lets the
            # controller escape a stickiness-0 start, where a pure
            # multiplicative step would be pinned at zero forever.
            self._s = max(self._s * self.gain, _INCREASE_FLOOR)
        elif self._qos_ewma < self._qos_baseline - self.qos_margin:
            self._s /= self.gain          # placement went stale: loosen
        self._s = float(np.clip(self._s, STICKINESS_MIN, STICKINESS_MAX))
        return self._s
