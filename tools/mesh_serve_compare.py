#!/usr/bin/env python3
"""chip_smoke.py's phase 26 (serving on a device mesh, without and with
the mesh, float32 and bfloat16) for the checkout at ROOT, cut to the
models named, on a ``(world // MODEL, MODEL)`` mesh of every card:

    python3 tools/mesh_serve_compare.py ROOT MODEL [ARCH ...]

ARCH defaults to smollm_360m and mamba2_2p7b. To compare two commits on
the same cards, unpack the parent with ``git archive`` into a directory
that ``.gitignore`` lists and run parent, change, change, parent in one
call. The model list is set at import, so the spawned ranks (which
re-import this script) serve the same models.
"""
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1])
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as c  # noqa: E402

c.SERVE_MESH = tuple((a, None) for a in sys.argv[3:]
                     or ("smollm_360m", "mamba2_2p7b"))

if __name__ == "__main__":
    import torch

    print(f"[pair] {ROOT} model={sys.argv[2]}", flush=True)
    c.phase_build()
    t = time.perf_counter()
    c.phase_serve_mesh(torch.device("cuda"), model=int(sys.argv[2]),
                       seq=False, block=False)
    print(f"[pair] {ROOT} took {time.perf_counter() - t:.1f} s", flush=True)
