#!/usr/bin/env python3
"""Print the dry run's records as one markdown table (the one in PERF.md).

    python3 tools/dryrun_table.py [--dir experiments/dryrun_torch] [--gb 80]

One row per (arch, shape) of ``repro_torch.launch.shapes.all_cells()``,
the two meshes side by side: per rank, ``per_device_hbm_bytes`` (GB, 1e9
bytes) with its argument / temporary split, ``dot_flops`` (TFLOP) and the
collectives' operand bytes on the wire (GB); then each cell's trace
seconds. A skipped cell gets its reason; a missing or failed record says
so. Cells whose per-rank bytes exceed ``--gb`` are listed after the
table. Every figure is a prediction of the dry run on fake tensors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

MESHES = ("pod16x16", "pod2x16x16")


def _cell(rec) -> str:
    if rec is None:
        return "no record"
    if rec["status"] != "ok":
        return rec["status"]
    m, c = rec["memory"], rec["corrected"]
    return (f"{m['per_device_hbm_bytes'] / 1e9:.2f} "
            f"({m['argument_size_in_bytes'] / 1e9:.2f} / "
            f"{m['temp_size_in_bytes'] / 1e9:.2f}) | "
            f"{c['dot_flops'] / 1e12:.4g} | "
            f"{c['collectives']['total_operand_bytes'] / 1e9:.4g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=str(ROOT / "experiments" /
                                         "dryrun_torch"))
    ap.add_argument("--gb", type=float, default=80.0)
    args = ap.parse_args()
    from repro_torch.launch.shapes import all_cells

    d = Path(args.dir)
    head = " | ".join(f"{m} GB (args / temp) | TFLOP | wire GB"
                      for m in MESHES)
    print(f"| arch | shape | kind | {head} | trace s |")
    print("| --- | --- | --- |" + " --- | --- | --- |" * len(MESHES)
          + " --- |")
    over, skipped, total_s = [], [], 0.0
    for arch, shape, ok, why in all_cells():
        if not ok:
            skipped.append(f"{arch} {shape}")
            continue
        recs = {}
        for m in MESHES:
            p = d / f"{arch}__{shape}__{m}.json"
            recs[m] = json.loads(p.read_text()) if p.exists() else None
        kind = next((r["kind"] for r in recs.values()
                     if r and r["status"] == "ok"), "?")
        secs = [r["trace_s"] for r in recs.values()
                if r and r["status"] == "ok"]
        total_s += sum(secs)
        print(f"| {arch} | {shape} | {kind} | "
              + " | ".join(_cell(recs[m]) for m in MESHES)
              + f" | {' / '.join(f'{s:.0f}' for s in secs)} |")
        for m, r in recs.items():
            if r and r["status"] == "ok" and \
                    r["memory"]["per_device_hbm_bytes"] > args.gb * 1e9:
                over.append(f"{arch} {shape} {m} "
                            f"{r['memory']['per_device_hbm_bytes'] / 1e9:.2f}"
                            " GB")
    print(f"\nskipped (the reference's reasons): {', '.join(skipped)}")
    print(f"over {args.gb:g} GB a rank: {', '.join(over) or 'none'}")
    print(f"trace seconds in all: {total_s:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
