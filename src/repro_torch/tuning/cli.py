"""Command-line entry point: ``python -m repro_torch.tuning`` (the port of
``python -m repro.tuning``; ``--device`` takes the place of ``--jax``).

Subcommands::

    # reduce a kind="serving" sweep store to per-scenario recommended
    # (switching_cost, stickiness) settings; writes <store>/tuning_table
    # .json unless --out points elsewhere (e.g. the packaged default
    # table src/repro_torch/tuning/tables/default.json)
    python -m repro_torch.tuning fit --store experiments/sweeps_torch/<key>

    # accuracy/latency + QoS/miss-rate Pareto frontiers from the same
    # store (--device routes the dominance check through the batched
    # device path: CUDA, or the device named)
    python -m repro_torch.tuning pareto --store \
        experiments/sweeps_torch/<key> --device

    # what the serving engine will recommend right now
    python -m repro_torch.tuning show [--table PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.sweeps.aggregate import frontier_table

from .fit import (DEFAULT_TABLE_PATH, fit_table, load_table, save_table)
from .pareto import frontier_points, frontier_rows

__all__ = ["main"]


def _cmd_fit(args: argparse.Namespace) -> int:
    table = fit_table(args.store, policy=args.policy)
    out = Path(args.out) if args.out else \
        Path(args.store) / "tuning_table.json"
    save_table(table, out)
    rows = table["scenarios"]
    print(f"[tuning] fitted {len(rows)} scenario(s) from {args.store} "
          f"-> {out}")
    print(f"{'scenario':<22} {'sw_cost':>8} {'stickiness':>10} "
          f"{'mean qos':>9} {'±95%':>7} {'n':>5} {'grid':>5}")
    for name in sorted(rows):
        r = rows[name]
        print(f"{name:<22} {r['switching_cost']:>8.2f} "
              f"{r['stickiness']:>10.2f} {r['mean_qos']:>9.4f} "
              f"{r['ci95']:>7.4f} {r['n']:>5d} {r['grid_points']:>5d}")
    return 0


def _cmd_pareto(args: argparse.Namespace) -> int:
    frontiers = frontier_points(
        args.store,
        scenarios=args.scenario.split(",") if args.scenario else None,
        use_device=args.device is not False, device=args.device or None)
    rows = frontier_rows(frontiers)
    print(frontier_table(rows))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


def _cmd_show(args: argparse.Namespace) -> int:
    table = load_table(args.table)
    if table is None:
        where = args.table or DEFAULT_TABLE_PATH
        print(f"[tuning] no lookup table at {where} — serving runs fall "
              f"back to the HorizonConfig defaults", file=sys.stderr)
        return 1
    print(f"[tuning] table v{table['table_version']} "
          f"(sweep schema v{table.get('sweep_schema_version', '?')}) "
          f"from {table.get('source', '?')}")
    for name in sorted(table.get("scenarios", {})):
        r = table["scenarios"][name]
        print(f"  {name:<22} switching_cost={r['switching_cost']:<6g} "
              f"stickiness={r['stickiness']:<6g} "
              f"(mean qos {r['mean_qos']:.4f} ±{r['ci95']:.4f}, "
              f"n={r['n']}, {r['grid_points']} grid points, "
              f"fit policy {r['policy']})")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning",
        description="Sweep-driven auto-tuner: fit per-scenario placer "
                    "knobs, extract Pareto frontiers, inspect the shipped "
                    "lookup table.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    fit = sub.add_parser("fit", help="fit a per-scenario knob lookup table "
                                     "from a kind='serving' sweep store")
    fit.add_argument("--store", required=True,
                     help="sweep store directory (see python -m "
                          "repro_torch.sweeps --kind serving)")
    fit.add_argument("--out", default=None,
                     help="table path (default: <store>/tuning_table.json; "
                          "point at "
                          "src/repro_torch/tuning/tables/default.json "
                          "to refresh the shipped table)")
    fit.add_argument("--policy", default="edf",
                     help="queue policy whose realized values drive the "
                          "fit (default: edf; scenarios without it pool "
                          "all stored policies)")
    fit.set_defaults(fn=_cmd_fit)

    par = sub.add_parser("pareto", help="non-dominated (QoS, miss) and "
                                        "(accuracy, latency) frontiers")
    par.add_argument("--store", required=True)
    par.add_argument("--scenario", default=None,
                     help="comma-separated subset (default: all stored)")
    par.add_argument("--device", nargs="?", const=None, default=False,
                     metavar="DEVICE",
                     help="batched dominance check on a device instead of "
                          "the NumPy reference: CUDA when no DEVICE is "
                          "named (raises without a card), e.g. 'cpu' "
                          "otherwise")
    par.add_argument("--json", default=None, metavar="PATH",
                     help="also write the frontier rows as JSON")
    par.set_defaults(fn=_cmd_pareto)

    show = sub.add_parser("show", help="print the active lookup table")
    show.add_argument("--table", default=None,
                      help="table path (default: $REPRO_TUNING_TABLE or "
                           "the packaged default)")
    show.set_defaults(fn=_cmd_show)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
