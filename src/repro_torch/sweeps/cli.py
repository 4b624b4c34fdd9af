"""Command-line entry point: ``python -m repro_torch.sweeps``.

Examples::

    # 32-seed flash-crowd sweep on the GPU, resumable under
    # experiments/sweeps_torch/
    python -m repro_torch.sweeps --scenario flash_crowd --seeds 0:32

    # two scenarios × 8 seeds, EGP vs AGP, with host-path validation
    python -m repro_torch.sweeps --scenario steady,flash_crowd --seeds 0:8 \\
        --algos egp,agp --validate

    # paper §VI-B synthetic instances at two sizes, ratios vs exact OPT
    python -m repro_torch.sweeps --scenario synthetic --override n_users=50 \\
        --override n_users=100 --algos egp,agp,sck,opt --seeds 0:10

    # the plain PyTorch versions on the CPU
    python -m repro_torch.sweeps --scenario steady --device cpu --validate

Interrupting a stored run and re-invoking the same command resumes it:
completed chunks are read back from the manifest, not recomputed. The
flags are the reference's (``python -m repro.sweeps``) without ``--fleet``
and ``--stream``, plus ``--device``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .aggregate import summarize, table
from .shard import DEFAULT_MEMORY_BUDGET_MB, HOST_PARITY_ATOL, run_sweep
from .spec import KINDS, SweepSpec

__all__ = ["main", "parse_seeds", "build_spec", "add_spec_arguments"]

#: Apart from the reference's experiments/sweeps/, so the two packages'
#: float32 values never land in one store by default.
_DEFAULT_STORE_ROOT = Path("experiments") / "sweeps_torch"

#: tolerance for --validate (float32 batched vs float64 host path)
VALIDATE_ATOL = HOST_PARITY_ATOL


def parse_seeds(text: str) -> Tuple[int, ...]:
    """``"0:32"`` → range(0, 32); ``"0,3,7"`` → (0, 3, 7); ``"5"`` → (5,)."""
    text = text.strip()
    if ":" in text:
        lo, hi = text.split(":", 1)
        lo, hi = int(lo or 0), int(hi)
        if hi <= lo:
            raise argparse.ArgumentTypeError(f"empty seed range {text!r}")
        return tuple(range(lo, hi))
    return tuple(int(s) for s in text.split(",") if s.strip())


def _parse_override(text: str) -> Tuple[str, Any]:
    if "=" not in text:
        raise argparse.ArgumentTypeError(
            f"--override expects key=value, got {text!r}")
    k, v = text.split("=", 1)
    for conv in (int, float):
        try:
            return k.strip(), conv(v)
        except ValueError:
            continue
    return k.strip(), v.strip()


def _split_csv(values: List[str]) -> List[str]:
    out: List[str] = []
    for v in values:
        out.extend(s.strip() for s in v.split(",") if s.strip())
    return out


def add_spec_arguments(ap: argparse.ArgumentParser) -> None:
    """The sweep-grid flags (the reference's --override grammar)."""
    ap.add_argument("--scenario", action="append", required=True,
                    help="scenario name(s); repeat or comma-separate "
                         "(registered scenarios or 'synthetic')")
    ap.add_argument("--kind", choices=list(KINDS), default="sigma",
                    help="sigma: analytic objective (default); serving "
                         "(realized QoS through the serving engine) is not "
                         "in the port yet and exits with an error")
    ap.add_argument("--seeds", type=parse_seeds, default=(0,),
                    help="'a:b' range or comma list (default: 0)")
    ap.add_argument("--ticks", type=int, default=None,
                    help="horizon length (default: scenario's n_ticks)")
    ap.add_argument("--algos", action="append", default=None,
                    help="algorithms to sweep (default: egp)")
    ap.add_argument("--override", action="append", metavar="K=V",
                    help="scenario/instance-size override; repeating the "
                         "same key forms a grid axis")
    ap.add_argument("--force-host", action="append", default=None,
                    help="run these accel-capable algos on the host path")
    ap.add_argument("--max-iters", type=int, default=512,
                    help="accelerator greedy-loop iteration cap (part of "
                         "every work-item hash)")


def build_spec(args: argparse.Namespace) -> SweepSpec:
    if args.algos is None:
        args.algos = ["egp"]
    overrides = [_parse_override(o) for o in (args.override or [])]
    # repeated overrides of the same key form a grid axis; distinct keys
    # combine into every grid point
    grid: List[Tuple[Tuple[str, Any], ...]] = [()]
    by_key: Dict[str, List[Any]] = {}
    for k, v in overrides:
        by_key.setdefault(k, []).append(v)
    for k, vals in by_key.items():
        grid = [g + ((k, v),) for v in vals for g in grid]
    return SweepSpec(
        scenarios=tuple(_split_csv(args.scenario)),
        seeds=args.seeds,
        n_ticks=args.ticks,
        algos=tuple(_split_csv(args.algos)),
        override_grid=tuple(grid),
        force_host=tuple(_split_csv(args.force_host or [])),
        max_iters=args.max_iters,
        kind=getattr(args, "kind", "sigma"),
    )


def _validate(spec: SweepSpec, result) -> float:
    """Max |batched − host| σ over every accelerator-evaluated item.

    Never-computed (NaN) cells count as infinite divergence — a partial
    run must not report a vacuous validation success.
    """
    from repro_torch.sweeps.spec import materialize, variant_key
    from repro_torch.workloads import evaluate_host

    worst = 0.0
    for (scenario, overrides, algo), items in spec.groups():
        if spec.executor_of(algo) != "accel":
            continue
        insts = materialize(scenario, overrides,
                            [(it.seed, it.tick) for it in items])
        host = evaluate_host(insts, algo=algo)
        got = result.values[(variant_key(scenario, overrides), algo)].ravel()
        diff = np.nan_to_num(np.abs(got - host), nan=np.inf)
        worst = max(worst, float(diff.max()) if diff.size else 0.0)
    return worst


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweeps",
        description="Resumable Monte-Carlo sweeps over the PIES scenario "
                    "registry on CUDA devices.")
    add_spec_arguments(ap)
    ap.add_argument("--device", default="cuda",
                    help="device of the accelerator algorithms (default: "
                         "cuda, split over every visible CUDA device; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--out", default=None,
                    help="store directory (default: "
                         "experiments/sweeps_torch/<store-key>, stable "
                         "across --seeds/--ticks extensions); use "
                         "--no-store to disable")
    ap.add_argument("--no-store", action="store_true",
                    help="run fully in memory (no resume)")
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--memory-budget-mb", type=float,
                    default=DEFAULT_MEMORY_BUDGET_MB)
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="stop after N computed chunks (smoke/testing)")
    ap.add_argument("--ref", default="auto",
                    help="ratio reference algorithm (default: auto = opt "
                         "if swept, else per-item best)")
    ap.add_argument("--validate", action="store_true",
                    help="check accelerator values against the NumPy host "
                         f"path (atol {VALIDATE_ATOL})")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the aggregate summary as JSON")
    ap.add_argument("--obs", default=None, metavar="PATH",
                    help="enable repro_torch.obs tracing and save the raw "
                         "artifact at PATH")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import obs
    if args.obs:
        obs.enable()
    else:
        obs.enable_from_env()  # REPRO_OBS=1

    try:
        spec = build_spec(args)
    except NotImplementedError as exc:
        ap.error(str(exc))
    store_dir = None
    if not args.no_store:
        # keyed on the seed/tick-independent axes: extending --seeds or
        # --ticks reuses the same store and resumes instead of recomputing
        store_dir = Path(args.out) if args.out else \
            _DEFAULT_STORE_ROOT / spec.store_key()

    result = run_sweep(spec, store_dir=store_dir,
                       chunk_size=args.chunk_size,
                       memory_budget_mb=args.memory_budget_mb,
                       device=args.device,
                       max_chunks=args.max_chunks,
                       verbose=not args.quiet)

    summary = summarize(result, ref=args.ref)
    validate_failed = False
    if args.validate:
        worst = _validate(spec, result)
        summary["validate_max_abs_diff"] = worst
        validate_failed = not (worst <= VALIDATE_ATOL)  # NaN/inf fail too

    # always show the table and persist --json — a validation failure must
    # not throw away an otherwise-complete sweep's aggregate
    if not args.quiet:
        ex = result.execution
        where = f"{ex['n_devices']} {ex['backend']} device(s) via " \
            f"{ex['path']}" if ex["backend"] != "host" else "host path"
        print(f"[sweeps] {ex['chunks_computed']} chunk(s) computed, "
              f"{ex['items_skipped']} item(s) resumed from store; {where}"
              + (f"; store: {ex['store']}" if ex["store"] else ""))
    print(table(result, ref=args.ref))
    if args.validate:
        if validate_failed:
            print(f"VALIDATION FAILED: max|batched − host| = "
                  f"{summary['validate_max_abs_diff']:.2e} > "
                  f"{VALIDATE_ATOL}", file=sys.stderr)
        else:
            print(f"validated against host path: max|Δσ| = "
                  f"{summary['validate_max_abs_diff']:.2e} <= "
                  f"{VALIDATE_ATOL}")

    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(summary, indent=1))
    if args.obs:
        Path(args.obs).parent.mkdir(parents=True, exist_ok=True)
        obs.save(args.obs)
        if not args.quiet:
            tr = obs.get_tracer()
            print(f"[obs] saved {tr.n_spans} span(s) to {args.obs}")
    if validate_failed:
        return 1
    return 0 if result.complete or args.max_chunks is not None else 2


if __name__ == "__main__":
    sys.exit(main())
