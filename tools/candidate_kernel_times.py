#!/usr/bin/env python3
"""Time B2 and the whole top-k candidate build of one checkout on a CUDA
card, at the main path's instance.

    python3 tools/candidate_kernel_times.py [--root DIR] [--reps N]

Builds the kernel library of the checkout at ``--root`` (default: the one
this script sits in; its ``src/`` is imported, and the library is built
into its ``build/``), makes ``synthetic_instance(1_000_000, n_edges=1000,
seed=0)`` (the §VI-B catalog: M = 10 implementations a service at most)
and times, each as the median of ``--reps`` calls between two CUDA events
and as device time from ``torch.profiler``:

* B2's kernel: ``topk_candidates_cuda`` (the fused build) where the
  checkout has it, else ``qos_candidates_cuda`` on the candidates'
  attributes gathered beforehand (the kernel alone, without its gathers);
* the candidate build as the tick calls it,
  ``qos_candidates_from_instance(ti, table)``, with the impl table as a
  host array (uploaded in every build), and, where the checkout takes one,
  as an int32 tensor already on the card; also on the host's clock (a
  build and a synchronize), and as device time: every device activity of
  a build (kernels and copies), with their count.

Prints one JSON line with the card's name and power limit. To compare two
versions, run it for each checkout in turn on one card within one run
(parent, change, change, parent): each run is its own process, so each
imports its own package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MAIN = dict(n_users=1_000_000, n_edges=1000, seed=0)


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median host-clock milliseconds of ``fn()`` followed by
    ``torch.cuda.synchronize()``, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_activity(fn, reps: int):
    """``(device ms per call, device activities per call, names)`` over
    ``reps`` calls of ``fn()`` after two warm-up calls, from
    ``torch.profiler``: every kernel and copy, summed and divided by
    ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None, None, []
    return (sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3,
            len(evs) / reps, sorted({e.name[:60] for e in evs}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("candidate_kernel_times: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.core import (TorchInstance, impl_table_np,
                                  synthetic_instance)
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.qos_matrix import ops

    _, info = load_library()
    dev = torch.device("cuda")
    inst = synthetic_instance(MAIN["n_users"], n_edges=MAIN["n_edges"],
                              seed=MAIN["seed"])
    ti = TorchInstance.from_pies(inst, dev)
    table_np = impl_table_np(inst.sm_service, inst.S)
    table = torch.from_numpy(table_np.astype(np.int32)).to(dev)
    dm = float(inst.delta_max)
    ms = {}
    fused = hasattr(ops, "topk_candidates_cuda")
    if fused:
        kargs = (ti.u_service, ti.u_alpha, ti.u_delta, ti.u_share_k,
                 ti.u_share_w, table, ti.sm_acc, ti.sm_k, ti.sm_w)

        def kernel():
            return ops.topk_candidates_cuda(*kargs, delta_max=dm)

        name = "topk_candidates_kernel"
    else:
        cand = table[ti.u_service.long()]
        valid = cand >= 0
        safe = cand.clamp_min(0).long()
        kargs = (ti.u_alpha, ti.u_delta, ti.u_share_k, ti.u_share_w,
                 ti.sm_acc[safe].contiguous(), ti.sm_k[safe].contiguous(),
                 ti.sm_w[safe].contiguous(),
                 valid.to(torch.float32).contiguous())

        def kernel():
            return ops.qos_candidates_cuda(*kargs, delta_max=dm)

        name = "qos_candidates_kernel"
    ms["b2_kernel"] = time_ms(kernel, args.reps)
    ms["b2_kernel_device"], _, _ = device_activity(kernel, args.reps)
    builds = {"build_host_table": table_np}
    if fused:
        builds["build_card_table"] = table
    activity = {}
    for label, tab in builds.items():
        def build(tab=tab):
            return ops.qos_candidates_from_instance(ti, tab)

        ms[label] = time_ms(build, args.reps)
        ms[label + "_host"] = host_ms(build, args.reps)
        dev_ms, n_act, names = device_activity(build, args.reps)
        ms[label + "_device"] = dev_ms
        activity[label] = dict(per_build=n_act, names=names)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "card": card, "instance": MAIN,
                      "U": inst.U, "P": inst.P, "M": int(table.shape[1]),
                      "b2_kernel": name, "build_s": info["build_s"],
                      "ms": ms, "device_activity": activity}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
