#!/usr/bin/env python3
"""Time two ways of building the port's kernel library on a machine with
``nvcc``: one ``nvcc -c`` per ``.cu`` source, all started together, then a
link (what ``repro_torch.kernels._build`` does), against a single ``nvcc
-shared`` call over every source. Each build starts from nothing in a fresh
temporary directory; the order of the two alternates between repetitions.

    python3 tools/kernel_build_times.py [--reps 2]

Prints one line per build and, last, a JSON object with the seconds of
each.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    from repro_torch.kernels import _build as b

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    sources = b._sources()
    cu = [str(s) for s in sources if s.suffix == ".cu"]
    nvcc = b.find_nvcc()

    def parallel(out: Path) -> None:
        b._compile(sources, out)

    def single(out: Path) -> None:
        subprocess.run([nvcc, *b.NVCC_FLAGS, "-shared", "-o", str(out), *cu],
                       check=True, capture_output=True)

    times = {"parallel": [], "single": []}
    for rep in range(args.reps):
        order = ("parallel", "single") if rep % 2 == 0 else ("single",
                                                              "parallel")
        for name in order:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                (parallel if name == "parallel" else single)(
                    Path(tmp) / "lib.so")
                times[name].append(time.perf_counter() - t0)
            print(f"{name}: {times[name][-1]:.2f} s", flush=True)
    print(json.dumps({"sources": [Path(c).name for c in cu], **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
