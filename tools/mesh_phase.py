#!/usr/bin/env python3
"""Run chip_smoke.py's phase 25 (training on a device mesh) or phase 26
(serving on it) alone.

    python3 tools/mesh_phase.py [--model 1 2] [--profile]   # NCCL
    python3 tools/mesh_phase.py --serve [--model 1 2 4]
    python3 tools/mesh_phase.py --cpu 4 [--model 1 2] [--serve]

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

``--serve`` runs phase 26 in place of phase 25: B7's block variant on
the card (``chip_smoke._b7_block_check``), then for each ``--model``
degree the ranks of ``chip_smoke.mesh_serve_rank``, which serve each
SERVE_MESH model without and with the mesh, and also the batch-1
SERVE_SEQ_CASES with the KV slots over the batch axes (on four cards at
``--model 1`` each rank holds a quarter of the slots), holding every B7
block call against its plain version.

``--gap-seeds N`` (card only; after the phase) reads mixtral-8x7b's bf16
first-step loss gap (2 of 32 layers, SP on, the mesh against one
microbatch a data rank) at each ``--model`` degree for seeds 0 .. N-1:
the diagnostic of phase 25's first-step gate (MESH_FIRST_TOL).

``--moe-routing`` (card only) reads what moves mixtral-8x7b's (4 of 32
layers) float32 prefill logits between the mesh and one device: each
layer's routing (the tokens whose top-k experts differ, the assignments
kept for capacity that differ) and the last position's logits, at its
capacity factor and at one that drops nothing.

``--cpu N`` rehearses the same ranks on the CPU: N gloo processes, the
models' smoke configs in place of the published ones, and small
gradient, step and serving shapes (no kernels; the launch counts read
0).
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


def rehearsal_serve_rank(rank: int, world: int, init_file: str,
                         out_dir: str, model: int) -> None:
    """``chip_smoke.mesh_serve_rank`` on the CPU at the smoke configs, the
    batch-1 cases included (mixtral's 16-slot ring wrapped by a 40-token
    prompt)."""
    import torch

    import chip_smoke as c
    import repro_torch.configs as configs
    from repro_torch.configs import get_smoke_config

    torch.set_num_threads(1)
    configs.get_config = lambda arch, **kw: get_smoke_config(arch, **kw)
    c.SERVE_B, c.SERVE_PROMPT, c.SERVE_SEQ, c.SERVE_STEPS = 4, 16, 24, 4
    c.SERVE_SEQ_CASES = (("mixtral_8x7b", None, 40, 48),
                         ("zamba2_2p7b", None, 20, 24))
    c.mesh_serve_rank(rank, world, init_file, out_dir, model, "cpu", True)


def gap_rank(rank: int, world: int, init_file: str, out_dir: str,
             model: int, seeds: int) -> None:
    """Phase 25's mixtral bf16 steps cut to the first one, for each seed:
    the mesh's loss against one device's (``chip_smoke._mesh_steps``)."""
    import torch
    import torch.distributed as dist

    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    out = {}
    try:
        mesh = make_host_mesh(model=model, device="cuda")
        cfg = get_config("mixtral_8x7b").with_(remat=True, n_layers=2)
        c.MESH_STEPS = 1
        for seed in range(seeds):
            c.SEED = seed
            runs, _ = c._mesh_steps(dev, cfg, mesh, "mixtral_8x7b", 2, True)
            one, on = runs["one"]["losses"][0], runs["mesh"]["losses"][0]
            out[seed] = dict(one=one, mesh=on, gap=abs(on - one) / abs(one))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def routing_rank(rank: int, world: int, init_file: str, out_dir: str,
                 model: int) -> None:
    """mixtral's float32 prefill at phase 26's shape without and with the
    mesh, its routing recorded (``models.layers.moe_route``), at its own
    capacity factor and at 8 (no assignment dropped)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import MeshContext

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    out = {}
    orig = layers.moe_route
    try:
        ctx = MeshContext(make_host_mesh(model=model, device="cuda"),
                          ("data",))
        base = get_config("mixtral_8x7b", n_layers=4).with_(dtype="float32")
        params = T.init_params(base, torch.Generator(device=dev)
                               .manual_seed(c.SEED))
        tokens = torch.as_tensor(np.random.default_rng(c.SEED).integers(
            0, base.vocab_size, (c.SERVE_B, c.SERVE_PROMPT)), device=dev)
        for cf in (base.capacity_factor, 8.0):
            cfg = base.with_(capacity_factor=cf)
            runs = {}
            for on in (False, True):
                routes = []

                def spy(x, router, cfg_, capacity, routes=routes):
                    r = orig(x, router, cfg_, capacity)
                    routes.append((r.idx.sort(-1).values.cpu(),
                                   r.kept.cpu()))
                    return r

                layers.moe_route = spy
                blocks, pctx = T.shard_batch({"tokens": tokens}, ctx) if on \
                    else ({"tokens": tokens}, None)
                cache, ring = T.init_cache(cfg, c.SERVE_B, c.SERVE_SEQ, dev,
                                           ctx=pctx)
                logits, _ = T.prefill(params, cfg, blocks["tokens"], cache,
                                      ring, ctx=pctx)
                logits = T.gather_logits(logits, pctx, cfg)
                runs[on] = (logits.float().cpu(), routes)
                layers.moe_route = orig
            (l0, r0), (l1, r1) = runs[False], runs[True]
            out[str(cf)] = dict(
                logit_err=float((l1 - l0).abs().max() / l0.abs().max()),
                flips=[int((a[0] != b[0]).any(-1).sum())
                       for a, b in zip(r0, r1)],
                kept=[int((a[1] != b[1]).sum()) for a, b in zip(r0, r1)],
                dropped=[int((~a[1]).sum()) for a in r0])
        dist.barrier()
    finally:
        layers.moe_route = orig
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def moe_routing(model: int) -> None:
    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mp.start_processes(routing_rank, args=(world, f"{tmp}/pg", tmp,
                                               model),
                           nprocs=world, join=True, start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            out = json.load(f)
    for cf, r in out.items():
        print(f"[mesh] routing model={model} capacity factor {cf}: mixtral "
              f"float32 prefill logits {r['logit_err']:.3g} of the largest "
              f"|logit| off one device; tokens whose top-k differ by layer "
              f"{r['flips']}, kept assignments that differ {r['kept']}, "
              f"dropped on one device {r['dropped']}", flush=True)


def gap_seeds(model: int, seeds: int) -> None:
    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mp.start_processes(gap_rank, args=(world, f"{tmp}/pg", tmp, model,
                                           seeds),
                           nprocs=world, join=True, start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            out = json.load(f)
    for seed, r in out.items():
        print(f"[mesh] gap model={model} seed {seed}: mixtral bf16 first "
              f"loss {r['mesh']:.6f} on the mesh, {r['one']:.6f} without, "
              f"gap {r['gap']:.3g} (gate 1e-4)", flush=True)


def rehearse(world: int, model: int, serve: bool = False) -> None:
    import torch.multiprocessing as mp

    import chip_smoke as c

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(rehearsal_serve_rank if serve else rehearsal_rank,
                           args=(world, f"{tmp}/pg", tmp, model),
                           nprocs=world, join=True, start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    if serve:
        c._log_serve_mesh(ranks, time.perf_counter() - t0)
        return
    out = ranks[0]
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
    ap.add_argument("--serve", action="store_true",
                    help="phase 26 (serving on the mesh) in place of 25")
    ap.add_argument("--gap-seeds", type=int, default=0, metavar="N",
                    help="mixtral's bf16 first-step gap over N seeds")
    ap.add_argument("--moe-routing", action="store_true",
                    help="mixtral's float32 prefill routing on and off the "
                         "mesh (card only; no phase)")
    args = ap.parse_args()
    if args.cpu:
        for model in args.model:
            rehearse(args.cpu, model, args.serve)
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
    if args.moe_routing:
        for model in args.model:
            moe_routing(model)
        return
    if args.serve:
        t0 = time.perf_counter()
        c._b7_block_check(torch.device("cuda"))
        print(f"[mesh] B7 block variant: {time.perf_counter() - t0:.1f} s",
              flush=True)
    failed = []
    for model in args.model:
        t0 = time.perf_counter()
        try:
            if args.serve:
                c.phase_serve_mesh(torch.device("cuda"), model=model,
                                   seq=True, block=False)
            else:
                c.phase_mesh(torch.device("cuda"), model=model,
                             profile=args.profile)
        except RuntimeError as e:       # a gate: the other degrees still run
            failed.append(f"model={model}: {e}")
            print(f"[mesh] FAILED at model={model}: {e}", flush=True)
        print(f"[mesh] phase {26 if args.serve else 25} at model={model}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for model in args.model if args.gap_seeds else ():
        gap_seeds(model, args.gap_seeds)
    if failed:
        sys.exit("[mesh] " + "; ".join(failed))


if __name__ == "__main__":
    main()
