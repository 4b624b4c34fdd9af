#!/usr/bin/env python3
"""Run one sweep split over every visible CUDA device and again on the
first device alone, and hold the two bit-identical.

    python3 tools/sweep_per_device.py [--users 2000] [--seeds 8]

The spec: EGP and AGP (evaluate_batch, the qos_matrix and greedy_argmax
kernels) on the paper's §VI-B synthetic instances at ``--users`` users and
on the flash_crowd and edge_failure scenarios, seeds ``0..--seeds-1``.
Prints the card, each run's wall time and execution record, and exits
nonzero when a value differs or fewer than two devices are visible.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()

    import torch

    from repro_torch.sweeps import SweepSpec, run_sweep

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("sweep_per_device: needs two or more CUDA devices",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    specs = [
        SweepSpec(scenarios=("synthetic",), algos=("egp", "agp"),
                  override_grid=({"n_users": args.users},),
                  seeds=range(args.seeds)),
        SweepSpec(scenarios=("flash_crowd", "edge_failure"),
                  algos=("egp", "agp"), seeds=range(args.seeds)),
    ]
    ok = True
    for spec in specs:
        runs = {}
        # one device, all devices, one device again: each timed warm
        for label, kw in (("one", dict(device="cuda:0")),
                          ("all", dict()), ("one again",
                                            dict(device="cuda:0"))):
            t0 = time.perf_counter()
            res = run_sweep(spec, **kw)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            runs[label] = (time.perf_counter() - t0, res)
        same = all(
            runs["all"][1].values[k].tobytes() == v.tobytes()
            for k, v in runs["one"][1].values.items())
        ok &= same
        print(json.dumps({
            "scenarios": list(spec.scenarios),
            "items": len(spec.expand()),
            "wall_s": {k: s for k, (s, _) in runs.items()},
            "execution": {k: r.execution for k, (_, r) in runs.items()},
            "bit_identical": same}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
