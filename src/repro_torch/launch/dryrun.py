"""Multi-pod dry run of the port: trace every (arch × shape × mesh) cell on
fake tensors, one rank of the production mesh, and write what the step
costs that rank. The port of ``repro.launch.dryrun``. Run:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod/--single-pod] [--out DIR]

Each cell starts a fake process group of 256 ranks (``pod16x16``) or 512
(``pod2x16x16``) at rank 0 (``torch.distributed``'s ``fake`` backend: no
other process, no socket, collectives that move nothing), builds
:func:`~repro_torch.launch.mesh.make_production_mesh` on it, builds the
cell (:func:`~repro_torch.launch.specs.build_cell`: this rank's blocks of
the state, parameters and cache) in a ``FakeTensorMode`` and traces one
step with :func:`~repro_torch.analysis.step_cost.trace_step`. It
allocates no tensor bytes, launches nothing on a card and needs no
``nvcc``: the kernel wrappers record their calls on fake tensors. The
group is destroyed and the collectives' groups forgotten after each cell.

**Why rank 0 stands for every rank.** ``layers.leaf_split`` keeps a size
that does not divide its axis whole instead of padding it, so every rank
of a production mesh holds blocks of the same shapes (GSPMD's last rank
would hold a padded one); :func:`run_cell` asserts it for the traced
cell, comparing rank 0's leaf shapes with rank ``world − 1``'s, both
worked out from the specs (no second trace).

On a PyTorch built without CUDA a fake CUDA tensor can be made but not
indexed, copied or differentiated (those need CUDA's device guard), so
there the cell is traced on fake ``meta`` tensors, which the kernel
wrappers take as the card's (``kernels._build.on_card``); the record's
``traced_on`` says which.

Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--out``), never to the reference's ``experiments/dryrun/``. Their keys
are the reference's — ``arch``, ``shape``, ``mesh``, ``status`` (``ok``,
``skip``, ``fail``), ``skip_reason``, ``kind``, ``devices``, ``memory``,
``collectives``, ``corrected``, ``n_params``, ``n_active_params`` — with
``trace_s`` in place of ``lower_s``/``compile_s``, and ``wire`` (the
``torch.distributed`` calls, and the port's own operations under
``by_op``) and ``kernels`` (the hand kernels' calls, FLOPs and bytes)
added. XLA's raw ``cost_analysis`` and ``hlo_lines`` have no counterpart
(there is no HLO; the trace counts every operation as it runs), nor has
``--keep-hlo``. ``collectives`` and ``corrected["collectives"]`` are the
same table here: the trace needs no trip-count correction.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

__all__ = ["ARTIFACT_DIR", "main", "run_cell", "trace_device"]


def trace_device() -> str:
    """The device the fake tensors stand on: ``cuda`` where PyTorch is
    built with CUDA, else ``meta`` (module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def _rank_shape(whole, split, mesh, rank: int):
    """The block shape rank ``rank`` holds of a leaf of ``whole`` shape
    split as ``split`` (``leaf_split``'s axes per dimension), narrowing a
    meta tensor at that rank's coordinates."""
    coords = dict(zip(mesh.mesh_dim_names,
                      np.unravel_index(rank, tuple(mesh.shape))))
    t = torch.empty(whole, device="meta")
    for dim, axes in enumerate(split):
        if axes is None:
            continue
        n, idx = 1, 0
        for a in axes:
            k = mesh.size(mesh.mesh_dim_names.index(a))
            n, idx = n * k, idx * k + int(coords[a])
        b = whole[dim] // n
        t = t.narrow(dim, idx * b, b)
    return tuple(t.shape)


def _check_uniform(args, mesh, ctx) -> int:
    """Assert that rank 0 and rank ``world − 1`` hold blocks of the same
    shapes, and that rank 0's are the blocks built; returns the leaves
    checked."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    world = int(np.prod(tuple(mesh.shape)))
    leaves = []
    for a in args:
        model = a.params if hasattr(a, "params") else a
        if isinstance(model, torch.nn.Module):
            for name, p in model.named_parameters():
                leaves.append((name, p.shape, p.pspec, p.whole_shape))
        if isinstance(a, T.Cache) and a.layout is not None:
            for f in ("kv_k", "kv_v", "ssm"):
                leaves.append((f, getattr(a, f).shape, a.layout.specs[f],
                               a.layout.shapes[f]))
    for name, shape, spec, whole in leaves:
        split = L.leaf_split(ctx, spec, whole)
        first = _rank_shape(whole, split, mesh, 0)
        last = _rank_shape(whole, split, mesh, world - 1)
        if not first == last == tuple(shape):
            raise AssertionError(f"{name}: rank 0 holds {first}, rank "
                                 f"{world - 1} {last}, built {tuple(shape)}")
    return len(leaves)


def run_cell(arch: str, shape: str, multi_pod: bool, save: bool = True,
             out=None) -> dict:
    """Trace one cell; returns its record (and writes it under ``out``,
    default :data:`ARTIFACT_DIR`, with ``save``). A skipped cell's record
    says why and is not written, as in the reference."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    # the fake backend: torch's test utility, the one import of it
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis import trace_step
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_production_mesh, mesh_devices
    from repro_torch.launch.shapes import cell_plan
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.layers import MeshContext

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    ok, why = cell_plan(arch, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "status": "skip", "skip_reason": why}
    if not ok:
        return rec

    t0 = time.time()
    device = trace_device()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
        baxes = ("pod", "data") if multi_pod else ("data",)
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, meta = build_cell(arch, shape, mesh, multi_pod,
                                          device=device)
            _check_uniform(args, mesh, MeshContext(mesh, baxes))
            cost, _ = trace_step(step, *args)
            del step, args
        devices = mesh_devices(mesh)
    finally:
        dist.destroy_process_group()
        C.reset_groups()

    cfg = meta["config"]
    corrected = cost.as_dict()
    rec.update({
        "status": "ok",
        "kind": meta["kind"],
        "devices": devices,
        "traced_on": device,
        "trace_s": round(time.time() - t0, 1),
        "memory": cost.memory,
        "collectives": corrected["collectives"],
        "corrected": corrected,
        "wire": {**cost.wire, "by_op": cost.by_op},
        "kernels": cost.kernels,
        "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params,
    })
    if save:
        _write(out, f"{arch}__{shape}__{mesh_name}.json", rec)
    return rec


def _write(out, name: str, rec: dict) -> None:
    d = Path(out) if out is not None else ARTIFACT_DIR
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps(rec, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", default=None,
                    dest="multi_pod")
    ap.add_argument("--single-pod", action="store_false", dest="multi_pod")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)

    from repro_torch.launch.shapes import all_cells

    if args.all:
        cells = [(a, s) for a, s, ok, _ in all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.multi_pod is None else [args.multi_pod]
    out_dir = Path(args.out) if args.out else ARTIFACT_DIR

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            name = f"{arch}__{shape}__{mesh_name}.json"
            if args.skip_existing and (out_dir / name).exists():
                prev = json.loads((out_dir / name).read_text())
                if prev.get("status") in ("ok", "skip"):
                    print(f"[cached] {arch} {shape} {mesh_name}: "
                          f"{prev['status']}")
                    continue
            try:
                rec = run_cell(arch, shape, mp, out=out_dir)
                if rec["status"] == "skip":
                    print(f"[skip]   {arch} {shape} {mesh_name}: "
                          f"{rec['skip_reason']}")
                else:
                    mem = rec["memory"].get("per_device_hbm_bytes")
                    memg = f"{mem / 2**30:.2f}GiB" if mem else "?"
                    fl = rec["corrected"]["flops"]
                    cb = rec["corrected"]["collectives"][
                        "total_operand_bytes"]
                    print(f"[ok]     {arch} {shape} {mesh_name}: "
                          f"mem/dev={memg} flops/dev={fl:.3e} "
                          f"coll/dev={cb / 2**30:.2f}GiB "
                          f"(trace {rec['trace_s']}s)", flush=True)
            except Exception as e:
                failures += 1
                print(f"[FAIL]   {arch} {shape} {mesh_name}: {e}",
                      flush=True)
                traceback.print_exc()
                _write(out_dir, name, {"arch": arch, "shape": shape,
                                       "mesh": mesh_name, "status": "fail",
                                       "error": str(e)})
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
