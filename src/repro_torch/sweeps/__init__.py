"""repro_torch.sweeps — resumable Monte-Carlo experiment engine on CUDA.

The evaluation plane on top of :mod:`repro_torch.workloads`: a
:class:`SweepSpec` declares a (scenario × overrides × algorithm × seed ×
tick) grid; :func:`run_sweep` expands it to a deterministic work list,
skips items already in the append-only :class:`SweepStore`, chunks the
rest to a memory budget, and evaluates accelerator chunks through
``evaluate_batch`` on every visible CUDA device (one contiguous sub-batch
per device — bit-identical per item to one device); :mod:`aggregate`
reduces stored values to mean/std/95%-CI approximation-ratio tables.
Keys, stores and tables are the reference's (:mod:`repro.sweeps`).

    python -m repro_torch.sweeps --scenario flash_crowd --seeds 0:32
"""
from .aggregate import (basic_stats, fig3_table, fig4_table, frontier_table,
                        ratio_frame, summarize, table)
from .shard import (HOST_PARITY_ATOL, SweepResult, auto_chunk_size,
                    bytes_per_item, run_sweep)
from .spec import (ACCEL_ALGOS, HOST_ALGOS, KINDS, SERVING_POLICIES,
                   SYNTHETIC, SweepSpec, WorkItem, envelope_for, materialize,
                   variant_key)
from .store import SweepStore, atomic_write

__all__ = [
    "SweepSpec", "WorkItem", "variant_key", "envelope_for", "materialize",
    "ACCEL_ALGOS", "HOST_ALGOS", "KINDS", "SERVING_POLICIES", "SYNTHETIC",
    "SweepStore", "atomic_write",
    "SweepResult", "run_sweep", "auto_chunk_size", "bytes_per_item",
    "HOST_PARITY_ATOL",
    "summarize", "table", "ratio_frame", "basic_stats", "fig3_table",
    "fig4_table", "frontier_table",
]
