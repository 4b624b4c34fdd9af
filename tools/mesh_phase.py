#!/usr/bin/env python3
"""Run chip_smoke.py's phase 25 (training on a device mesh) alone.

    python3 tools/mesh_phase.py [--model 1 2] [--profile]   # NCCL
    python3 tools/mesh_phase.py --cpu 4 [--model 1 2]

On the card: builds the kernel library (phase 1), then for each
``--model`` degree spawns ``torch.cuda.device_count()`` NCCL ranks of
``chip_smoke.mesh_rank`` on a ``(world // model, model)`` mesh
(``chip_smoke.phase_mesh``), which log each model's float32 gradients and
bf16 steps with and without the mesh. On a machine with four cards
``--model 1 2`` runs (4, 1) and (2, 2). ``--profile`` adds, for the models at
full depth, one bf16 step without and with the mesh under
``torch.profiler`` (wall ms, device busy ms, NCCL kernels, the mesh
step's largest host operations; ``chip_smoke._mesh_profile``). Prints the
card's name and power limit first.

Each rank also trains MESH_SHARDED with the state stored as its blocks
(``shard_train_state``) beside the replicated state, and writes and
restores a sharded checkpoint. On a machine with four cards ``--model 1 2
4`` runs (4, 1), (2, 2) and (1, 4).

``--cpu N`` rehearses the same ranks on the CPU: N gloo processes, the
models' smoke configs in place of the published ones, and small
gradient and step shapes (no kernels; the launch counts read 0).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def rehearsal_rank(rank: int, world: int, init_file: str, out_dir: str,
                   model: int) -> None:
    """``chip_smoke.mesh_rank`` on the CPU at the smoke configs."""
    import torch

    import chip_smoke as c
    import repro_torch.configs as configs
    import repro_torch.launch.train as train
    from repro_torch.configs import get_smoke_config

    torch.set_num_threads(1)
    configs.get_config = train.get_config = get_smoke_config
    c.GRAD_B, c.GRAD_S, c.TRAIN_B, c.TRAIN_S = 2, 32, 8, 64
    c.mesh_rank(rank, world, init_file, out_dir, model, "cpu")


def rehearse(world: int, model: int) -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(rehearsal_rank,
                           args=(world, f"{tmp}/pg", tmp, model),
                           nprocs=world, join=True, start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            out = json.load(f)
    print(f"[mesh] cpu rehearsal, {world} gloo ranks, mesh {out['mesh']}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for arch, r in out["models"].items():
        grads = {k: (v["loss_err"], v["grad_err"])
                 for k, v in r["grads"].items() if k.startswith("sp")}
        losses = {k: v["losses"] for k, v in r["steps"].items()}
        print(f"[mesh] {arch}: (loss, worst leaf) {grads}; losses {losses}",
              flush=True)
    for arch, r in out["sharded"].items():
        print(f"[mesh] {arch} state as blocks: losses "
              f"{r['sharded']['losses']} (replicated "
              f"{r['replicated']['losses']}); worst block {r['worst']}; "
              f"state bytes {r['sharded']['state_bytes']} of "
              f"{r['replicated']['state_bytes']}"
              + ("; checkpoint restored bit-equal" if "checkpoint" in r
                 else ""), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=int, nargs="+", default=[1],
                    help="model-parallel degrees, one run each")
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="rehearse with N gloo ranks on the CPU")
    ap.add_argument("--profile", action="store_true",
                    help="profile one step each way (card only)")
    args = ap.parse_args()
    if args.cpu:
        for model in args.model:
            rehearse(args.cpu, model)
        return
    import torch

    import chip_smoke as c

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    t0 = time.perf_counter()
    c.phase_build()
    print(f"[mesh] build {time.perf_counter() - t0:.1f} s", flush=True)
    for model in args.model:
        t0 = time.perf_counter()
        c.phase_mesh(torch.device("cuda"), model=model,
                     profile=args.profile)
        print(f"[mesh] phase 25 at model={model}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
