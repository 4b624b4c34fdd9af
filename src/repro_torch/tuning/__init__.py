"""repro_torch.tuning — sweep-driven auto-tuning and closed-loop placement.

The decision layer on top of the measurement stack: ``repro_torch.sweeps``
(kind ``"serving"``) grids the :class:`~repro_torch.core.dynamic
.DynamicPlacer` knobs per scenario and stores realized QoS; this package
turns those stores into decisions —

* :mod:`~repro_torch.tuning.fit` fits per-scenario recommended
  ``(switching_cost, stickiness)`` settings (mean-realized-QoS argmax,
  95%-CI tie-break) into a versioned JSON lookup table that
  ``HorizonConfig.from_overrides`` consults for unset knobs; the packaged
  table is a byte copy of the reference's;
* :mod:`~repro_torch.tuning.pareto` extracts non-dominated
  (QoS, deadline-miss-rate) and (accuracy, latency) frontiers per
  scenario — batched dominance on a CUDA device
  (:func:`pareto_mask_torch`) with a NumPy reference path;
* :mod:`~repro_torch.tuning.controller` closes the loop online:
  :class:`FeedbackPlacer` adapts the stickiness bonus from realized
  per-tick QoS/miss-rate (EWMA signals, multiplicative increase/decrease,
  clamped), exposed as serving policy ``"feedback"``.

All three are the reference's (:mod:`repro.tuning`) value for value, on
the same stores::

    python -m repro_torch.tuning fit --store experiments/sweeps_torch/<key>
    python -m repro_torch.tuning pareto --store experiments/sweeps_torch/<key>
    python -m repro_torch.tuning show
"""
from .controller import STICKINESS_MAX, STICKINESS_MIN, FeedbackPlacer
from .fit import (DEFAULT_TABLE_PATH, TABLE_ENV_VAR, TABLE_VERSION,
                  ServingRecord, fit_table, load_table, read_serving_records,
                  recommend, save_table)
from .pareto import (FrontierPoint, frontier_points, frontier_rows,
                     pareto_mask_np, pareto_mask_torch)

__all__ = [
    "FeedbackPlacer", "STICKINESS_MIN", "STICKINESS_MAX",
    "ServingRecord", "fit_table", "save_table", "load_table", "recommend",
    "read_serving_records", "TABLE_VERSION", "TABLE_ENV_VAR",
    "DEFAULT_TABLE_PATH",
    "FrontierPoint", "frontier_points", "frontier_rows",
    "pareto_mask_np", "pareto_mask_torch",
]
