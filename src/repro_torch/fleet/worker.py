"""Fleet worker: claim → execute → append → release, until drained (the
port of :mod:`repro.fleet.worker`, on the port's sweep engine).

A worker is one process pointed at a fleet root. Its loop:

1. :meth:`~repro_torch.fleet.queue.LeaseQueue.claim` a task (atomic rename);
   when nothing is claimable it first :meth:`reap`\\ s expired leases —
   picking up the chunks of crashed workers — and exits once the queue is
   truly drained;
2. execute the task through the **existing sweep engine**:
   :func:`task_spec` rebuilds the task's single-group
   :class:`~repro_torch.sweeps.spec.SweepSpec` and
   :func:`~repro_torch.sweeps.shard.run_sweep` evaluates it on ``device``
   into the worker's
   *private* store (``<fleet_root>/workers/<owner>/``) — same chunking,
   same envelopes, same serving horizons, so per-item values are
   byte-identical to a single-process run of the whole sweep;
3. heartbeat the lease from a daemon thread every ``ttl / 3`` while
   executing, then mark the task done (atomic rename into ``done/``).

On a CUDA card every worker is a CUDA context of its own (about half a
gigabyte); N workers on one card share its SMs by time-slicing, so give
each a ``memory_budget_mb`` that lets N fit.

``SIGTERM``/``SIGINT`` trigger a **clean drain**: the current task runs to
completion (its results land durably and its lease is completed), then the
loop exits with the stop reason recorded. ``SIGKILL`` is the crash path
the queue is built for: the orphaned lease expires and any other worker's
``reap`` requeues the chunk.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch import obs
from repro_torch.sweeps.spec import SweepSpec
from repro_torch.sweeps.shard import run_sweep

from .queue import DEFAULT_TTL_S, Lease, LeaseQueue, Task, default_owner
from .telemetry import WorkerTelemetry

__all__ = ["task_spec", "run_worker", "spawn_local_workers",
           "worker_store_dir", "load_fleet_spec"]

_QUEUE_DIR = "queue"
_WORKERS_DIR = "workers"


def worker_store_dir(fleet_root: os.PathLike | str, owner: str) -> Path:
    return Path(fleet_root) / _WORKERS_DIR / owner


def load_fleet_spec(fleet_root: os.PathLike | str) -> SweepSpec:
    """The sweep spec this fleet was planned from (version-checked)."""
    path = Path(fleet_root) / "spec.json"
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"fleet root {fleet_root} has no readable "
                         f"spec.json — run `repro_torch.fleet plan` "
                         f"first") from e
    return SweepSpec.from_json(doc)


def task_spec(parent: SweepSpec, task: Task) -> SweepSpec:
    """The task's single-group sub-spec.

    Pins the group's scenario, override set (knobs already resolved at
    plan time — no tuning-table re-resolution drift), algorithm, the
    task's seed slice, and the *resolved* tick count, so the sub-spec
    expands to exactly the parent's item keys for this slice.
    """
    return SweepSpec(
        scenarios=(task.scenario,),
        seeds=task.seeds,
        n_ticks=task.n_ticks,
        algos=(task.algo,),
        override_grid=(task.overrides,),
        force_host=tuple(a for a in parent.force_host if a == task.algo),
        max_iters=parent.max_iters,
        kind=parent.kind,
    )


class _Heartbeat(threading.Thread):
    """Renews a lease every ``ttl / 3`` while the task executes."""

    def __init__(self, lease: Lease, interval: float):
        super().__init__(daemon=True)
        self.lease = lease
        self.interval = max(float(interval), 0.05)
        self._halt = threading.Event()  # NB: Thread reserves `_stop`

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            try:
                if not self.lease.renew():
                    return  # lease lost: stop beating, let the task finish
            except OSError:
                return

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5.0)


def run_worker(fleet_root: os.PathLike | str, *,
               owner: Optional[str] = None,
               ttl: float = DEFAULT_TTL_S,
               max_tasks: Optional[int] = None,
               memory_budget_mb: Optional[float] = None,
               device: Optional[str] = "cuda",
               install_signal_handlers: bool = True,
               wait: bool = False,
               poll_interval: float = 2.0,
               verbose: bool = False) -> Dict[str, Any]:
    """Drain the fleet queue from this process; returns a run summary.

    Exits when the queue has no claimable *or* reapable work left (other
    workers' live leases are not waited on — the coordinator's final
    ``merge``/``run_sweep`` pass covers stragglers), after ``max_tasks``
    tasks, or on a clean SIGTERM drain. With ``wait=True`` an empty
    queue is not an exit: the worker long-polls every ``poll_interval``
    seconds for the next plan wave (elastic fleets keep their workers
    across waves), so the only exits are SIGTERM/SIGINT (clean drain)
    and ``max_tasks``.

    Accelerator groups run on ``device`` (``"cuda"``, as the port's sweep
    CLI; ``"cpu"`` runs the plain PyTorch versions); host and serving
    groups need none.
    """
    fleet_root = Path(fleet_root)
    owner = owner or default_owner()
    spec = load_fleet_spec(fleet_root)
    queue = LeaseQueue(fleet_root / _QUEUE_DIR, owner=owner, ttl=ttl)
    store_dir = worker_store_dir(fleet_root, owner)
    store_dir.mkdir(parents=True, exist_ok=True)

    stop = {"reason": None}

    def _drain(signum, frame):  # noqa: ARG001 - signal signature
        stop["reason"] = signal.Signals(signum).name

    previous_handlers = {}
    if install_signal_handlers:
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous_handlers[sig] = signal.signal(sig, _drain)
        except ValueError:  # not the main thread: caller manages signals
            previous_handlers = {}

    try:
        return _worker_loop(queue, spec, store_dir, owner, stop,
                            max_tasks, memory_budget_mb, device, verbose,
                            telemetry=WorkerTelemetry(fleet_root, owner),
                            wait=wait, poll_interval=poll_interval)
    finally:
        # an in-process caller (tests, benchmarks) keeps its own Ctrl-C
        for sig, handler in previous_handlers.items():
            signal.signal(sig, handler)


def _poll_sleep(stop: Dict[str, Any], interval: float) -> None:
    """Sleep ``interval`` seconds in short slices so a SIGTERM drain
    request interrupts the long-poll promptly instead of after a full
    poll period."""
    deadline = time.perf_counter() + max(interval, 0.0)
    while stop["reason"] is None:
        remain = deadline - time.perf_counter()
        if remain <= 0:
            return
        time.sleep(min(remain, 0.2))


def _worker_loop(queue: LeaseQueue, spec: SweepSpec, store_dir: Path,
                 owner: str, stop: Dict[str, Any],
                 max_tasks: Optional[int],
                 memory_budget_mb: Optional[float],
                 device: Optional[str],
                 verbose: bool,
                 telemetry: Optional[WorkerTelemetry] = None,
                 wait: bool = False,
                 poll_interval: float = 2.0) -> Dict[str, Any]:
    executed: List[str] = []
    items = 0
    t0 = time.perf_counter()
    if telemetry is not None:
        telemetry.start()
    while stop["reason"] is None:
        if max_tasks is not None and len(executed) >= max_tasks:
            stop["reason"] = "max_tasks"
            break
        lease = queue.claim()
        if lease is None:
            # nothing claimable: pick up crashed workers' chunks, else done
            if queue.reap():
                continue
            if wait:
                # elastic fleets: survive the gap between plan waves
                _poll_sleep(stop, poll_interval)
                continue
            stop["reason"] = "drained"
            break
        task = lease.task
        sub = task_spec(spec, task)
        expect = {it.key() for it in sub.expand()}
        if expect != set(task.keys):
            lease.release()
            raise ValueError(
                f"task {task.name} expands to different item keys than "
                f"planned — code/schema skew between coordinator and "
                f"worker; re-plan the fleet")
        hb = _Heartbeat(lease, interval=queue.ttl / 3.0)
        hb.start()
        task_t0 = time.perf_counter()
        try:
            kwargs = {} if memory_budget_mb is None else \
                {"memory_budget_mb": memory_budget_mb}
            run_sweep(sub, store_dir=store_dir, device=device,
                      verbose=False, **kwargs)
        finally:
            hb.stop()
        items += len(task.keys)
        completed = lease.complete()
        executed.append(task.name)
        if telemetry is not None:
            telemetry.task_done(task.name, len(task.keys),
                                time.perf_counter() - task_t0)
        pub = obs.get_publisher()
        if pub is not None:
            # Live "worker" frame for the dashboard / `status --watch`.
            # Pending *items* is an estimate (pending tasks × this
            # worker's mean items/task) — the queue only counts tasks.
            try:
                n_pending = len(queue.pending())
            except OSError:
                n_pending = None
            elapsed = time.perf_counter() - t0
            pub.emit("worker", {
                "owner": owner,
                "task": task.name,
                "tasks_done": len(executed),
                "items_done": items,
                "items_per_s": round(items / elapsed, 6)
                if elapsed > 0 else 0.0,
                "queue_pending_tasks": n_pending,
                "queue_pending_items": None if n_pending is None
                else int(round(n_pending * items / len(executed))),
                "task_wall_s": round(time.perf_counter() - task_t0, 6),
            })
        if verbose:
            state = "done" if completed else "done (lease was reaped)"
            print(f"[fleet:{owner}] {task.name}: {len(task.keys)} item(s) "
                  f"{state}", flush=True)

    if telemetry is not None:
        telemetry.stop(stop["reason"] or "drained")
    summary = {"owner": owner, "tasks": executed, "n_tasks": len(executed),
               "n_items": items, "stop": stop["reason"],
               "wall_s": time.perf_counter() - t0,
               "store": str(store_dir)}
    if verbose:
        print(f"[fleet:{owner}] exit ({stop['reason']}): "
              f"{len(executed)} task(s), {items} item(s) in "
              f"{summary['wall_s']:.2f}s", flush=True)
    return summary


def spawn_local_workers(fleet_root: os.PathLike | str, n: int, *,
                        ttl: float = DEFAULT_TTL_S,
                        max_tasks: Optional[int] = None,
                        memory_budget_mb: Optional[float] = None,
                        device: Optional[str] = "cuda",
                        quiet: bool = True,
                        silence: bool = False) -> List[subprocess.Popen]:
    """Fork ``n`` local worker processes (``python -m repro_torch.fleet
    worker --device DEVICE``) against ``fleet_root`` — the ``--fleet N``
    convenience path. The caller waits on the returned processes and then
    merges. The environment is copied (``CUBLAS_WORKSPACE_CONFIG`` and
    ``REPRO_OBS*`` reach the workers). ``silence`` drops worker
    stdout/stderr entirely (benchmarks emitting structured output)."""
    import repro_torch

    env = dict(os.environ)
    pkg_root = str(Path(list(repro_torch.__path__)[0]).resolve().parent)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    sink = subprocess.DEVNULL if silence else None
    procs = []
    for i in range(int(n)):
        cmd = [sys.executable, "-m", "repro_torch.fleet", "worker",
               "--root", str(fleet_root), "--owner", f"local-{i}",
               "--ttl", str(ttl)]
        if device is not None:
            cmd += ["--device", str(device)]
        if max_tasks is not None:
            cmd += ["--max-tasks", str(max_tasks)]
        if memory_budget_mb is not None:
            cmd += ["--memory-budget-mb", str(memory_budget_mb)]
        if not quiet:
            cmd.append("--verbose")
        procs.append(subprocess.Popen(cmd, env=env, stdout=sink,
                                      stderr=sink))
    return procs
