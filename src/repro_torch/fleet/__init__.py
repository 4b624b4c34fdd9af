"""repro_torch.fleet — multi-worker sweep dispatch over a lease-based
queue (the port of :mod:`repro.fleet`).

The horizontal-scale layer between :mod:`repro_torch.sweeps` and the
hardware: a :class:`~repro_torch.sweeps.spec.SweepSpec` manifest becomes a
shared, directory-backed work queue (:mod:`~repro_torch.fleet.queue` —
atomic rename claims, owner+TTL lease files, heartbeat renewal,
expired-lease requeue), N independent worker processes
(:mod:`~repro_torch.fleet.worker`) drain it through the port's sweep engine
into private stores, and the coordinator
(:mod:`~repro_torch.fleet.coordinator`) merges them into one
:class:`~repro_torch.sweeps.store.SweepStore` — deduping by item hash and
verifying duplicate values bit-for-bit, so a fleet of any worker count
(including one SIGKILLed mid-chunk and reaped) aggregates byte-identically
to the single-process ``repro_torch.sweeps`` run of the same spec. On a
CUDA card each worker is a CUDA context of its own; the contexts share
the card by time-slicing.

The queue, task, lease, telemetry and ``spec.json`` documents are the
reference's byte for byte, so a root planned by either package is read by
the other's ``status``, ``obs tail`` and ``obs stitch``.

    python -m repro_torch.fleet plan --scenario flash_crowd --seeds 0:32 \\
        --root experiments/fleet/demo --store experiments/sweeps_torch/demo
    python -m repro_torch.fleet worker --root experiments/fleet/demo  # × N
    python -m repro_torch.fleet merge --root experiments/fleet/demo \\
        --store experiments/sweeps_torch/demo

or, all-local: ``python -m repro_torch.sweeps ... --fleet N``.
"""
from .coordinator import (FleetMergeConflict, merge, plan, reap, status,
                          worker_stores)
from .queue import DEFAULT_TTL_S, Lease, LeaseQueue, Task, default_owner
from .worker import (load_fleet_spec, run_worker, spawn_local_workers,
                     task_spec, worker_store_dir)

__all__ = [
    "DEFAULT_TTL_S", "Task", "Lease", "LeaseQueue", "default_owner",
    "task_spec", "run_worker", "spawn_local_workers", "worker_store_dir",
    "load_fleet_spec",
    "FleetMergeConflict", "plan", "status", "merge", "reap",
    "worker_stores",
]
