"""Chunked, resumable sweep execution on one or more CUDA devices.

The execution core behind ``python -m repro_torch.sweeps``. For every
(scenario, overrides, algorithm) group of a :class:`~repro_torch.sweeps
.spec.SweepSpec`:

1. work items already present in the :class:`~repro_torch.sweeps.store
   .SweepStore` are skipped (resume is item-granular — chunk boundaries can
   change between runs without losing work);
2. pending items are split into chunks whose size is tuned to bound peak
   device memory (:func:`auto_chunk_size`) and rounded to the device
   count;
3. each accelerator chunk is grouped into geometric size buckets (or padded
   to the group's *static* envelope, derived from scenario config), each
   bucket's members are split into contiguous sub-batches, one per device,
   and every sub-batch runs through
   :func:`repro_torch.workloads.batched.evaluate_batch` (the ``qos_matrix``
   and ``greedy_argmax`` kernels on CUDA). Per-item results are
   bit-identical under any split: each item's computation is independent,
   and nothing crosses the batch;
4. results are appended to the store (npz shard + manifest line) as soon
   as the chunk completes, so a killed sweep resumes mid-group.

Host-only algorithms (``opt``, ``sck``, ``rnd``, ``agp_literal`` — and any
algorithm listed in ``spec.force_host``) run through the NumPy reference
implementations, one instance at a time, through the *same* chunk/store
pipeline; their values are byte-identical to :mod:`repro.sweeps.shard`'s.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device

from .spec import SweepSpec, envelope_for, materialize, variant_key
from .store import SweepStore

__all__ = [
    "SweepResult",
    "auto_chunk_size",
    "bytes_per_item",
    "run_sweep",
]

#: Default device-memory budget per in-flight chunk.
DEFAULT_MEMORY_BUDGET_MB = 512.0

#: Acceptance tolerance between float32 batched and float64 host-path σ —
#: the single source for the CLI's --validate (the reference's constant).
HOST_PARITY_ATOL = 1e-4

#: (path, algo, bucket shapes, devices, max_iters) combos already run —
#: lets per-item timings exclude the first call's library load and
#: allocator warm-up.
_WARMED: set = set()

#: Largest chunk worth re-running once for a warm timing.
_RETIME_MAX_B = 64

Device = Union[str, torch.device, None]


# ===========================================================================
# Chunk sizing
# ===========================================================================

def bytes_per_item(envelope: Tuple[int, int, int]) -> int:
    """Peak working-set estimate for one padded instance (the reference's:
    the per-edge masked QoS tensor ``[E, U, P]`` f32, plus the QoS and
    eligibility matrices and placement state)."""
    U, P, E = envelope
    return 4 * (U * P * (E + 4) + 4 * E * P + 8 * (U + P + E))


def auto_chunk_size(envelope: Tuple[int, int, int], n_devices: int = 1,
                    memory_budget_mb: float = DEFAULT_MEMORY_BUDGET_MB,
                    n_items: Optional[int] = None) -> int:
    """Largest chunk that fits the memory budget, rounded to the devices.

    Chunks are rounded *down* to a multiple of ``n_devices`` (so every
    device gets an equal share) except when the budget admits fewer items
    than devices.
    """
    fit = max(1, int(memory_budget_mb * 2**20) // bytes_per_item(envelope))
    if n_devices > 1 and fit >= n_devices:
        fit -= fit % n_devices
    if n_items is not None:
        fit = min(fit, max(1, int(n_items)))
    return fit


# ===========================================================================
# Accelerator path
# ===========================================================================

def _sweep_devices(device: Device, devices: Optional[Sequence[Device]]
                   ) -> List[torch.device]:
    """The devices an accelerator chunk is split over: ``devices`` when
    given, else every visible CUDA device for ``device=None``/``"cuda"``,
    else ``[device]``. A CUDA device that is not there raises."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices must name at least one device")
        return devs
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _split(idx: Sequence[int], n: int) -> List[List[int]]:
    """``idx`` in ``n`` contiguous runs, as equal as can be (empty runs
    dropped)."""
    q, r = divmod(len(idx), n)
    out, lo = [], 0
    for d in range(n):
        hi = lo + q + (d < r)
        if hi > lo:
            out.append(list(idx[lo:hi]))
        lo = hi
    return out


def _synchronize(devs: Sequence[torch.device]) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _eval_accel_chunk(instances: List, algo: str,
                      envelope: Tuple[int, int, int],
                      devs: Sequence[torch.device], max_iters: int,
                      bucketed: bool = True
                      ) -> Tuple[np.ndarray, str, float]:
    """Evaluate one chunk; returns (values [B], path, exec_seconds).

    With ``bucketed=True`` (the default) the chunk's instances are grouped
    into geometric size classes (:func:`repro_torch.workloads.batched
    .bucket_envelope`, capped by the group's static ``envelope``) and each
    bucket is padded and evaluated at its own envelope. Because the bucket
    envelope is a pure function of each instance's own dims, per-item
    results are independent of chunk composition, exactly as on the
    global-pad path (``bucketed=False``) — resume and re-chunk
    byte-identity are preserved. Each bucket's members are split into
    contiguous sub-batches over ``devs`` (one after the other: the greedy
    loop syncs with the host every iteration).

    ``exec_seconds`` is the steady-state execution wall time, read after a
    synchronize of every device: the first call per (path, shapes) also
    pays the kernel library's load and the allocator's warm-up, so a chunk
    of at most ``_RETIME_MAX_B`` items is re-run once and the re-run is
    what gets timed.
    """
    from repro_torch.workloads.batched import (bucket_indices,
                                               evaluate_batch, pad_instances)

    B = len(instances)
    if bucketed:
        groups = bucket_indices(instances, cap=envelope)
    else:
        groups = [(tuple(envelope), list(range(B)))]
    path = "batched" if len(devs) <= 1 else "per_device"

    def call():
        out = np.empty(B, dtype=np.float64)
        for benv, idx in groups:
            for dev, part in zip(devs, _split(idx, len(devs))):
                batch = pad_instances([instances[i] for i in part], *benv,
                                      device=dev)
                values, _ = evaluate_batch(batch, algo=algo,
                                           max_iters=max_iters)
                out[part] = values
        _synchronize(devs)
        return out

    t0 = time.perf_counter()
    values = call()
    exec_s = time.perf_counter() - t0
    warm_key = (path, algo, tuple((benv, len(idx)) for benv, idx in groups),
                tuple(str(d) for d in devs), max_iters)
    if B <= _RETIME_MAX_B and warm_key not in _WARMED:
        _WARMED.add(warm_key)
        t0 = time.perf_counter()
        values = call()
        exec_s = time.perf_counter() - t0
    return values, path, exec_s


# ===========================================================================
# Host path
# ===========================================================================

#: Decorrelates the RND baseline's draws from the instance-generation
#: stream (the work-item seed is also the synthetic instance's rng seed).
_RND_SEED_SALT = 0x5EED_BA5E


def _host_value(inst, algo: str, seed: int, tick: int) -> Tuple[float, float]:
    """(value, placement-time) via the NumPy reference implementations."""
    from repro_torch.core import (agp_literal_np, agp_np, egp_np, opt_np,
                                  qos_matrix_np, rnd_np, sck_np,
                                  schedule_value_np, sigma_np)

    # instances are shared across algo groups via run_sweep's inst_cache;
    # stash the QoS matrix on the instance so a 6-algorithm grid builds
    # Q once per instance, not once per (instance, algorithm)
    Q = getattr(inst, "_sweeps_qos_cache", None)
    if Q is None:
        Q = qos_matrix_np(inst)
        inst._sweeps_qos_cache = Q
    if algo == "rnd":
        t0 = time.perf_counter()
        _, y = rnd_np(inst, seed=(seed * 1_000_003 + tick) ^ _RND_SEED_SALT)
        dt = time.perf_counter() - t0
        return float(schedule_value_np(inst, y, Q)), dt
    fn = {"egp": egp_np, "agp": agp_np, "agp_literal": agp_literal_np,
          "opt": opt_np, "sck": sck_np}[algo]
    t0 = time.perf_counter()
    x = fn(inst, Q)
    dt = time.perf_counter() - t0
    return float(sigma_np(inst, x, Q)), dt


def _note_chunk(executor: str, n_items: int, wall_s: float) -> None:
    """Feed chunk throughput into the active tracer (a no-op when off)."""
    rate = n_items / wall_s if wall_s > 0 else None
    tracer = obs.get_tracer()
    if tracer is not None:
        tracer.metrics.counter("sweep.items", executor=executor).inc(n_items)
        tracer.metrics.counter("sweep.chunks", executor=executor).inc()
        if rate is not None:
            tracer.metrics.histogram("sweep.items_per_s",
                                     executor=executor).observe(rate)
            tracer.sample("sweep.items_per_s", rate)
    # the reference also publishes a "chunk" frame to the live stream here;
    # the port's obs has no stream yet (ROADMAP queue A item 8)


# ===========================================================================
# The engine
# ===========================================================================

@dataclasses.dataclass
class SweepResult:
    """Collected sweep output, shaped for aggregation.

    ``values[(variant, algo)]`` and ``times[(variant, algo)]`` are
    ``[n_seeds, n_ticks]`` float64 arrays in the spec's seed/tick order;
    incomplete cells (``max_chunks`` stopped the run early) are NaN.
    """

    spec: SweepSpec
    values: Dict[Tuple[str, str], np.ndarray]
    times: Dict[Tuple[str, str], np.ndarray]
    execution: Dict[str, Any]

    @property
    def complete(self) -> bool:
        return all(not np.isnan(v).any() for v in self.values.values())

    def rows(self) -> List[Dict[str, Any]]:
        """Flat per-item records (scenario, algo, seed, tick, value, time)."""
        out = []
        for (variant, algo), vals in self.values.items():
            ts = self.times[(variant, algo)]
            seeds = self.spec.seeds
            for i, seed in enumerate(seeds):
                for t in range(vals.shape[1]):
                    out.append({"scenario": variant, "algo": algo,
                                "seed": int(seed), "tick": t,
                                "value": float(vals[i, t]),
                                "time_s": float(ts[i, t])})
        return out


def run_sweep(spec: SweepSpec, store_dir=None, *,
              chunk_size: Optional[int] = None,
              memory_budget_mb: float = DEFAULT_MEMORY_BUDGET_MB,
              device: Device = None,
              devices: Optional[Sequence[Device]] = None,
              max_chunks: Optional[int] = None,
              bucketed: bool = True,
              verbose: bool = False) -> SweepResult:
    """Run (or resume) a sweep; returns the collected :class:`SweepResult`.

    ``store_dir=None`` runs fully in memory (no resume). With a store,
    completed items are skipped and newly computed chunks are persisted as
    soon as they finish. ``max_chunks`` stops after that many computed
    chunks — the result is then partial (NaN cells) but everything
    computed is durable. ``bucketed`` pads each accelerator chunk per
    geometric size class instead of one global envelope (item keys, store
    bytes, and resume semantics are identical either way).

    Accelerator groups run on ``device`` (``None``: CUDA, raising without
    it) split over ``devices`` (default: every visible CUDA device). A
    sweep whose groups are all host-executor needs no device.
    """
    store = SweepStore(store_dir) if store_dir is not None else None
    if store is not None:
        store.write_spec(spec.to_json())
    memory: Dict[str, Tuple[float, float]] = {}  # key -> (value, time)

    groups = spec.groups()
    needs_accel = any(spec.executor_of(a) == "accel" for _, _, a in
                      (g for g, _ in groups))
    devs: List[torch.device] = []
    backend = "host"
    if needs_accel:
        devs = _sweep_devices(device, devices)
        backend = devs[0].type
    n_devices = max(1, len(devs))

    # several algorithms sweep the same (scenario, overrides, seed, tick)
    # items — cache materialized instances across algo groups so e.g. the
    # 6-algorithm Fig-3 grid builds each instance once, not 6 times
    inst_cache: Dict[Tuple, Any] = {}

    def get_instances(scenario, overrides, pairs):
        if len(spec.algos) == 1:
            return materialize(scenario, overrides, pairs)
        row = (scenario, overrides)
        missing = [p for p in pairs if (row, p) not in inst_cache]
        if missing:
            for p, inst in zip(missing,
                               materialize(scenario, overrides, missing)):
                inst_cache[(row, p)] = inst
        return [inst_cache[(row, p)] for p in pairs]

    computed = skipped = 0
    paths = set()
    stopped = False
    for (scenario, overrides, algo), items in groups:
        executor = spec.executor_of(algo)
        keys = [it.key() for it in items]
        pending = [(it, k) for it, k in zip(items, keys)
                   if not (store is not None and k in store) and
                   k not in memory]
        skipped += len(items) - len(pending)
        if not pending:
            continue

        envelope = envelope_for(scenario, overrides)
        group_dev = n_devices if executor == "accel" else 1
        cs = chunk_size or auto_chunk_size(envelope, group_dev,
                                           memory_budget_mb, len(pending))
        for lo in range(0, len(pending), cs):
            if max_chunks is not None and computed >= max_chunks:
                stopped = True
                break
            chunk = pending[lo:lo + cs]
            chunk_items = [it for it, _ in chunk]
            chunk_keys = [k for _, k in chunk]
            with obs.span("sweep.materialize", items=len(chunk)):
                insts = get_instances(
                    scenario, overrides,
                    [(it.seed, it.tick) for it in chunk_items])
            t0 = time.perf_counter()
            with obs.span("sweep.chunk", executor=executor,
                          scenario=scenario, algo=algo, items=len(chunk)):
                if executor == "accel":
                    vals, path, exec_s = _eval_accel_chunk(
                        insts, algo, envelope, devs, spec.max_iters,
                        bucketed=bucketed)
                    wall = time.perf_counter() - t0
                    # per-item time is steady-state execution
                    times = np.full(len(chunk), exec_s / len(chunk))
                else:
                    path = "host"
                    vt = [_host_value(inst, algo, it.seed, it.tick)
                          for inst, it in zip(insts, chunk_items)]
                    wall = time.perf_counter() - t0
                    vals = np.array([v for v, _ in vt])
                    times = np.array([t for _, t in vt])
            _note_chunk(executor, len(chunk), wall)
            paths.add(path)
            meta = {"scenario": scenario, "overrides": dict(overrides),
                    "algo": algo, "executor": executor, "path": path,
                    "envelope": list(envelope), "n_devices": group_dev,
                    "bucketed": bool(bucketed and executor == "accel"),
                    "wall_s": round(wall, 6), "B": len(chunk)}
            if store is not None:
                store.add_chunk(chunk_keys, vals, times, meta)
            for k, v, dt in zip(chunk_keys, vals, times):
                memory[k] = (float(v), float(dt))
            computed += 1
            if verbose:
                print(f"[sweeps] {variant_key(scenario, overrides)}/{algo} "
                      f"chunk {len(chunk):4d} items via {path} "
                      f"({wall:.3f}s)", flush=True)
        if stopped:
            break

    # ---- collect --------------------------------------------------------
    def lookup(key: str) -> Tuple[float, float]:
        if key in memory:
            return memory[key]
        if store is not None and key in store:
            return store.value(key), store.time(key)
        return float("nan"), float("nan")

    values: Dict[Tuple[str, str], np.ndarray] = {}
    times_out: Dict[Tuple[str, str], np.ndarray] = {}
    for (scenario, overrides, algo), items in groups:
        T = spec.ticks_for(scenario, overrides)
        vk = variant_key(scenario, overrides)
        pairs = [lookup(it.key()) for it in items]
        arr = np.array([v for v, _ in pairs], np.float64)
        ts = np.array([t for _, t in pairs], np.float64)
        values[(vk, algo)] = arr.reshape(len(spec.seeds), T)
        times_out[(vk, algo)] = ts.reshape(len(spec.seeds), T)

    execution = {
        "backend": backend,
        "n_devices": n_devices,
        "devices": [str(d) for d in devs],
        "path": ("per_device" if "per_device" in paths else
                 "batched" if "batched" in paths else
                 "host" if "host" in paths else "cached"),
        "paths": sorted(paths),
        "chunks_computed": computed,
        "items_skipped": skipped,
        "store": None if store is None else str(store.root),
    }
    return SweepResult(spec=spec, values=values, times=times_out,
                       execution=execution)
