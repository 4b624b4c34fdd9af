"""Run one cell once: ``python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

It finds the cell in ``BENCHMARK.json``, its configuration, traffic mix
(whose ``driver`` names the module in ``drivers/`` that runs it) and
limits by name, checks that the card is there (a run without one exits 2
and prints no result), sets up, warms up, measures, decides ``correct``
against the plain reference, and prints the result as the last line of
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), each read by ``metrics/<metric>.py``
from the window's record or from the profiled portion that follows it. The numbers compared stand beside their limits in
the line's last key and in the last lines of standard error.

Every cache the run writes is in the checkout: the port's kernel library
under ``build/repro_torch/``, anything Triton, torch or the CUDA driver
would keep under ``build/bench_cache/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that may not be loaded when the result prints:
#: JAX, its libraries, and the JAX package the port was made from.
BARRED = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a missing file, a barred
    import); it exits non-zero and prints no result line."""


@dataclasses.dataclass
class Ctx:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    #: calibration only: also read the control and the faults
    control: bool = False


def cache_env(root: Path = ROOT) -> None:
    """Point every cache a library might write at fixed directories in
    the checkout."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def barred_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is
    barred, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BARRED))


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"{path} is missing")
    return json.loads(path.read_text())


def find_cell(name: str, root: Path = ROOT) -> dict:
    bench = load_json(root / "BENCHMARK.json")
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return {"bench": bench, "cell": cell}
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def cell_parts(name: str, root: Path = ROOT):
    """``(bench, cell, config, traffic)`` of a cell, each found by name."""
    found = find_cell(name, root)
    bench, cell = found["bench"], found["cell"]
    conf = next((c for c in bench["configs"] if c["name"] == cell["config"]),
                None)
    if conf is None:
        raise Refused(f"no configuration {cell['config']!r}")
    config = load_json(root / conf["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``):
    those listing it, or listing no cells but moving (per-layer) an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])
            and ("workloads" in m or m["moves"] in names)]


def load_module(path: Path, name: str):
    if not path.is_file():
        raise Refused(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(metrics: list, view, root: Path = ROOT) -> dict:
    """Each per-layer metric's reader on the traced run; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(root / "bench" / "metrics" / f"{m['name']}.py",
                             f"bench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _device(require_card: bool, chips: int):
    import torch

    if not require_card:
        return torch.device("cpu"), "cpu", 0
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: this benchmark "
                      "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards; "
                      f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0), torch.cuda.get_device_name(0), chips


def _program_in_checkout(root: Path) -> None:
    """Put the checkout's ``src`` first on the path and refuse a
    ``repro_torch`` found anywhere else."""
    src = root / "src"
    sys.path.insert(0, str(src))
    try:
        import repro_torch
    except ImportError as e:
        raise Refused(f"the program is not in this checkout ({e})") from e
    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise Refused(f"repro_torch was found at {where}, outside {src}")


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, t_start: float, *, root: Path = ROOT,
        require_card: bool = True) -> dict:
    """One run of a cell: returns the result line's object. Raises
    :class:`Refused` where no result may be printed."""
    args = parse(argv)
    cache_env(root)
    bench, cell, config, traffic = cell_parts(args.workload, root)
    device, kind, count = _device(require_card, cell["chips"])
    print(f"device: {kind} x{count} ({device})", flush=True)
    _program_in_checkout(root)
    driver = load_module(root / "bench" / "drivers" /
                         f"{traffic['driver']}.py",
                         f"bench_driver_{traffic['driver']}")
    from bench import checks
    limits = load_json(root / "bench" / "limits" /
                       f"{args.workload}.json")["limits"]
    ctx = Ctx(args.workload, config, traffic, args.seed, args.seconds,
              bool(args.trace), device, t_start)
    out = driver.run(ctx)
    correct, shown = checks.verdict(out["numbers"], limits)
    correct = correct and out["failed"] == 0
    if args.trace:
        from bench.costs import PEAKS
        from bench.costs import kernels as costs_kernels
        from bench.costs import model as costs_model
        view = SimpleNamespace(cell=args.workload, config=config,
                               traffic=traffic, trace=out["trace"],
                               record=out["record"], peaks=PEAKS,
                               kernels=costs_kernels, model=costs_model)
        metrics = read_per_layer(metrics_of(bench, args.workload,
                                            "per_layer"), view, root)
    else:
        metrics = {}
        for m in metrics_of(bench, args.workload, "end_to_end"):
            value = out["setup_s"] if m["name"] == "setup_s" \
                else out["e2e"].get(m["name"])
            if value is None:
                raise Refused(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if require_card else "cpu", "kind": kind,
           "count": count, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if args.trace:
        from bench.tracing import breakdown
        tr = out["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
    result["where"] = out.get("where", {})
    result["not_compared"] = {k: v for k, v in out["numbers"].items()
                              if k not in limits}
    result["checks"] = shown
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    try:
        result = run(sys.argv[1:] if argv is None else argv, t_start)
        barred = barred_modules()
        if barred:
            raise Refused(f"barred modules were loaded: {barred}")
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
