#!/usr/bin/env python3
"""Time the greedy-argmax (B3) and SSD scan (B8) kernels of one checkout on
a CUDA card.

    python3 tools/argmax_ssd_kernel_times.py [--root DIR] [--reps N]

Builds the kernel library of the checkout at ``--root`` (default: the one
this script sits in; its ``src/`` is imported, and the library is built
into its ``build/``), then times at the main-path shapes:

* B3 ``greedy_argmax_cuda`` on a [1000, 537] benefit map with a bool mask
  (the 10⁶-user tick's), beside ``torch.max(dim=1)`` on the same values
  pre-masked: each as the median of ``--reps`` calls between two CUDA
  events, and as the median device time of its kernel alone
  (``torch.profiler``), since the event time of so short a call holds the
  host's dispatch too;
* B8 ``ssd_scan_cuda`` in float32 at the mamba2-2.7b serving shape (x [8,
  1024, 80, 64], b/c [8, 1024, 128], chunk 256) and zamba2-2.7b's (N =
  64), between CUDA events.

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
from pathlib import Path

ARGMAX_SHAPE = (1000, 537)
#: (label, B, L, H, P, N, chunk)
SSD_SHAPES = (("mamba2", 8, 1024, 80, 64, 128, 256),
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


def device_ms(fn, name_part: str, reps: int):
    """Median device milliseconds of the kernels whose name holds
    ``name_part``, one per call, over ``reps`` calls (None if the profiler
    records none)."""
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
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation and name_part in e.name]
    return statistics.median(us) / 1e3 if us else None


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
        print("argmax_ssd_kernel_times: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.qos_matrix import ops

    _, info = load_library()
    dev = torch.device("cuda")
    ms = {}

    rng = np.random.default_rng(4)
    E, P = ARGMAX_SHAPE
    v = rng.normal(size=(E, P)).astype(np.float32)
    v[:, ::3] = np.round(v[:, ::3])
    m = rng.random((E, P)) < 0.5
    m[::7] = False
    v, m = torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev)
    premasked = torch.where(m, v, -1e30)
    ms["greedy_argmax"] = time_ms(lambda: ops.greedy_argmax_cuda(v, m),
                                  args.reps)
    ms["greedy_argmax_device"] = device_ms(
        lambda: ops.greedy_argmax_cuda(v, m), "greedy_argmax_kernel",
        args.reps)
    ms["torch_max"] = time_ms(lambda: torch.max(premasked, dim=1),
                              args.reps)
    ms["torch_max_device"] = device_ms(
        lambda: torch.max(premasked, dim=1), "reduce", args.reps)

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, B, L, H, P, N, chunk in SSD_SHAPES:
        x = torch.randn((B, L, H, P), generator=gen, device=dev)
        dtA = -(0.01 + 0.39 * torch.rand((B, L, H), generator=gen,
                                         device=dev))
        b = torch.randn((B, L, N), generator=gen, device=dev)
        c = torch.randn((B, L, N), generator=gen, device=dev)
        ms[f"ssd_scan_{label}"] = time_ms(
            lambda: ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk), args.reps)
        del x, dtA, b, c
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "card": card,
                      "argmax_shape": ARGMAX_SHAPE,
                      "ssd_shapes": SSD_SHAPES,
                      "build_s": info["build_s"], "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
