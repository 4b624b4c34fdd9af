#!/usr/bin/env python3
"""Time the SSD scan's backward kernel (``ssd_scan_bwd_cuda``) of one
checkout on a CUDA card.

    python3 tools/ssd_bwd_kernel_times.py [--root DIR] [--reps N]

Builds the kernel library of the checkout at ``--root`` (default: the one
this script sits in; its ``src/`` is imported, and the library is built
into its ``build/``), then, at the mamba2-2.7b training shape (x and dy [8,
1024, 80, 64], b/c [8, 1024, 128], chunk 256) and zamba2-2.7b's (N = 64),
with the forward's entering states and chunk decay from the checkout's B8,
reads one backward call as:

* the median of ``--reps`` calls between two CUDA events;
* the device time of all its launches per call, and of each kernel by
  name (``torch.profiler``);
* the device memory it takes above its inputs (peak during one call less
  the memory held before it).

Prints one JSON line with the card's name and power limit. To compare two
versions, run it for each checkout in turn on one card within one run
(parent, change, change, parent): each run is its own process, so each
imports its own package.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

#: (label, B, L, H, P, N, chunk)
SHAPES = (("mamba2", 8, 1024, 80, 64, 128, 256),
          ("zamba2", 8, 1024, 80, 64, 64, 256))


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


def kernel_name(key: str) -> str:
    """A profiler key without its return type, namespaces and arguments."""
    m = re.search(r"(\w+(?:<[^>(]*>)?)\(", key)
    return m.group(1) if m else key


def device_ms(fn, reps: int) -> dict:
    """Device milliseconds per call of each kernel ``fn()`` launches, by
    name (without its argument list), over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {kernel_name(e.key): e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.self_device_time_total}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_kernel_times: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels._build import load_library

    _, info = load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, B, L, H, P, N, chunk in SHAPES:
        x = torch.randn((B, L, H, P), generator=gen, device=dev)
        dtA = -(0.01 + 0.39 * torch.rand((B, L, H), generator=gen,
                                         device=dev))
        b = torch.randn((B, L, N), generator=gen, device=dev)
        c = torch.randn((B, L, N), generator=gen, device=dev)
        dy = torch.randn((B, L, H, P), generator=gen, device=dev)
        steps = ss.ssd_scan_cuda_steps(x, dtA, b, c, chunk=chunk)
        ent, dec = steps["entering_states"], steps["chunk_decay"]
        del steps

        def call():
            return ss.ssd_scan_bwd_cuda(x, dtA, b, c, dy, chunk=chunk,
                                        entering_states=ent,
                                        chunk_decay=dec)

        ms = time_ms(call, args.reps)
        by_kernel = device_ms(call, args.reps)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        grads = call()
        torch.cuda.synchronize()
        extra_gb = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        del grads, x, dtA, b, c, dy, ent, dec
        torch.cuda.empty_cache()
        out[label] = dict(shape=[B, L, H, P, N, chunk], ms=ms,
                          device_ms=sum(by_kernel.values()) or None,
                          device_ms_by_kernel=by_kernel,
                          call_memory_gb=extra_gb)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "card": card,
                      "build_s": info["build_s"], "ssd_scan_bwd": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
