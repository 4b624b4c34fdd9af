#!/usr/bin/env python3
"""Time the mesh collectives of ``repro_torch.distributed.collectives`` on
one card.

    python3 tools/mesh_collective_times.py [--reps N]

One NCCL rank (``world_size=1``, a ``file://`` rendezvous), the
``(data=1, model=1)`` host mesh, and a bf16 ``[8, 1024, 960]`` tensor
(smollm-360m's residual stream at 8 x 1,024 tokens). For ``psum``,
``psum_scatter`` and ``all_gather`` over the model axis, for NCCL's own
``all_reduce``, ``all_gather_into_tensor`` and ``all_to_all_single`` on
the same group (the port's psum is an all-to-all and an all-gather) and
for a device copy: the host
milliseconds a call (``N`` calls back to back, then one sync) and the
device milliseconds a call (CUDA events around the ``N`` calls). On one
rank every collective is an identity, so what it costs is overhead. Prints
the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]


def timed(fn, reps: int) -> dict:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / reps
    return {"host_ms": host, "device_ms": start.elapsed_time(end) / reps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                world_size=1, rank=0)
        try:
            mesh = make_host_mesh(model=1)
            x = torch.randn(8, 1024, 960, device="cuda").to(torch.bfloat16)
            group = mesh.get_group("model")
            ops = {
                "psum": lambda: C.psum(x, "model", mesh=mesh),
                "psum_scatter": lambda: C.psum_scatter(x, "model", 1,
                                                       mesh=mesh),
                "all_gather": lambda: C.all_gather(x, "model", 1, mesh=mesh),
                "nccl_all_reduce": lambda: dist.all_reduce(x.clone(),
                                                           group=group),
                "nccl_all_gather": lambda: dist.all_gather_into_tensor(
                    torch.empty_like(x), x, group=group),
                "nccl_all_to_all": lambda: dist.all_to_all_single(
                    torch.empty_like(x), x, group=group),
                "copy": lambda: x.clone(),
            }
            out = {name: timed(fn, args.reps) for name, fn in ops.items()}
        finally:
            dist.destroy_process_group()
    print(json.dumps({"shape": [8, 1024, 960], "dtype": "bfloat16",
                      "reps": args.reps, "ops": out}), flush=True)


if __name__ == "__main__":
    main()
