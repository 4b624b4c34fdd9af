"""Readings that a cell's limits are set from, on the card, in one
process: the numbers ``correct`` compares for the program on each seed
(a short window each), and on the control seeds those of the control (the
reference in float8) and, for training, of the faults read against the
reference (half of each batch left out). Writes one JSON line per seed,
then the largest program reading and the smallest control and fault
readings of each number::

    python3 bench/tools/calibrate.py --workload <cell> --seeds 1 2 3 \
        --control-seeds 4 5 6 --seconds 3
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _service(record: dict):
    """For generate traffic: calls, their mean time in the server and the
    largest wait past a call's due time, seconds."""
    calls = record.get("calls")
    if not calls:
        return None
    return {"calls": len(calls),
            "mean_s": sum(c["end"] - c["start"] for c in calls) / len(calls),
            "max_wait_s": max(c["start"] - c["due"] for c in calls)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--calls-per-s", type=float, default=None,
                    help="offer generate calls at this rate instead of the "
                    "traffic's (the sweep for a cell's rate)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from bench import harness

    harness.cache_env(ROOT)
    _, cell, config, traffic = harness.cell_parts(args.workload, ROOT)
    device, kind, _ = harness._device(True, cell["chips"])
    harness._program_in_checkout(ROOT)
    if args.calls_per_s is not None:
        traffic = dict(traffic, calls_per_s=args.calls_per_s)
    driver = harness.load_module(ROOT / "bench" / "drivers" /
                                 f"{traffic['driver']}.py", "bench_driver")
    program, control = {}, {}
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, ctrl in runs:
        t = time.perf_counter()
        out = driver.run(harness.Ctx(args.workload, config, traffic, seed,
                                     args.seconds, False, device, t,
                                     control=ctrl))
        line = {"seed": seed, "numbers": out["numbers"],
                "where": out.get("where"), "e2e": out["e2e"],
                "setup_s": out["setup_s"],
                "control": out.get("control"),
                "service": _service(out["record"]),
                "seconds": time.perf_counter() - t, "device": kind}
        print(json.dumps(line), flush=True)
        for k, v in out["numbers"].items():
            program[k] = max(program.get(k, 0.0), v)
        for name, nums in (out.get("control") or {}).items():
            for k, v in nums.items():
                key = f"{name}.{k}"
                control[key] = min(control.get(key, float("inf")), v)
    print(json.dumps({"lower": program, "upper_candidates": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
