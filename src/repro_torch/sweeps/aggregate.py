"""Host-side reduction of sweep results.

Turns a :class:`~repro_torch.sweeps.shard.SweepResult` into per-(scenario,
algorithm) statistics — mean/std/95%-CI of the raw σ objective and of the
*approximation ratio* against a reference:

* ``ref="auto"`` — the exact optimum (``opt``) when it was swept,
  otherwise the per-instance max across the swept algorithms (so the best
  algorithm's ratio is exactly 1.0 and the others are relative, which is
  the Fig-3 presentation without a 20-hour solver run);
* ``ref="<algo>"`` — a fixed reference algorithm (e.g. ``sck`` to get the
  paper's Fig-4 "EGP ≈ 1.5× SCK" framing).

``fig3_table``/``fig4_table`` render the classic figure-shaped text tables,
byte for byte the reference's (:mod:`repro.sweeps.aggregate`) on the same
values.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from .shard import SweepResult

__all__ = ["basic_stats", "summarize", "ratio_frame", "table",
           "fig3_table", "fig4_table", "frontier_table"]

#: normal-approximation 95% confidence half-width multiplier
_Z95 = 1.959963984540054


def _nan_quiet(fn, *args, **kwargs):
    """nan-reductions over partial results (all-NaN / empty cells are a
    legitimate state after --max-chunks or a killed run) without numpy's
    RuntimeWarning noise; NaN propagates and _stats handles it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*args, **kwargs)


def basic_stats(a: np.ndarray) -> Dict[str, float]:
    """NaN-dropping mean/std/95%-CI of a value set — the single source of
    the confidence arithmetic for every table here."""
    a = np.asarray(a, np.float64).ravel()
    a = a[~np.isnan(a)]
    n = a.size
    mean = float(a.mean()) if n else float("nan")
    std = float(a.std(ddof=1)) if n > 1 else 0.0
    ci = _Z95 * std / np.sqrt(n) if n > 1 else 0.0
    return {"n": int(n), "mean": mean, "std": std, "ci95": float(ci)}


_stats = basic_stats


def ratio_frame(result: SweepResult, ref: str = "auto"
                ) -> Dict[Tuple[str, str], np.ndarray]:
    """Per-item approximation ratios, same shapes as ``result.values``."""
    variants = sorted({v for v, _ in result.values})
    out: Dict[Tuple[str, str], np.ndarray] = {}
    for variant in variants:
        algos = [a for v, a in result.values if v == variant]
        stack = np.stack([result.values[(variant, a)] for a in algos])
        if ref == "auto":
            denom = (result.values[(variant, "opt")]
                     if "opt" in algos
                     else _nan_quiet(np.nanmax, stack, axis=0))
        else:
            if ref not in algos:
                raise ValueError(f"ratio reference {ref!r} was not swept "
                                 f"for {variant!r} (have {algos})")
            denom = result.values[(variant, ref)]
        denom = np.maximum(denom, 1e-9)
        for a in algos:
            out[(variant, a)] = result.values[(variant, a)] / denom
    return out


def summarize(result: SweepResult, ref: str = "auto") -> Dict:
    """Per-(scenario, algorithm) mean/std/95%-CI of σ and of the ratio."""
    ratios = ratio_frame(result, ref=ref)
    cells = {}
    for (variant, algo), vals in result.values.items():
        cells[(variant, algo)] = {
            "sigma": _stats(vals),
            "ratio": _stats(ratios[(variant, algo)]),
            "mean_time_s": float(_nan_quiet(
                np.nanmean, result.times[(variant, algo)])),
        }
    return {
        "ref": ref,
        "cells": {f"{v}/{a}": c for (v, a), c in cells.items()},
        "execution": result.execution,
        "spec": result.spec.to_json(),
    }


def table(result: SweepResult, ref: str = "auto") -> str:
    """The default CLI table: one row per (scenario, algorithm)."""
    ratios = ratio_frame(result, ref=ref)
    lines = [f"{'scenario':<28} {'algo':<12} {'n':>5} "
             f"{'mean σ':>10} {'±95%':>8} {'ratio':>7} {'±95%':>7}"]
    for (variant, algo), vals in result.values.items():
        s, r = _stats(vals), _stats(ratios[(variant, algo)])
        lines.append(f"{variant:<28} {algo:<12} {s['n']:>5d} "
                     f"{s['mean']:>10.3f} {s['ci95']:>8.3f} "
                     f"{r['mean']:>7.4f} {r['ci95']:>7.4f}")
    return "\n".join(lines)


def fig3_table(result: SweepResult, ref: str = "auto") -> str:
    """Fig-3a-shaped: algorithms × mean approximation ratio per scenario."""
    ratios = ratio_frame(result, ref=ref)
    variants = sorted({v for v, _ in result.values})
    algos = list(dict.fromkeys(a for _, a in result.values))
    head = f"{'scenario':<28}" + "".join(f"{a:>12}" for a in algos)
    lines = [head]
    for v in variants:
        row = f"{v:<28}"
        for a in algos:
            if (v, a) in ratios:
                row += f"{_stats(ratios[(v, a)])['mean']:>12.4f}"
            else:
                row += f"{'—':>12}"
        lines.append(row)
    return "\n".join(lines)


def frontier_table(rows: "Dict[str, List[Dict]]") -> str:
    """Fig-style Pareto-frontier table (arXiv:2011.08381's accuracy/time
    view) from ``frontier_rows`` output (the reference's
    :func:`repro.tuning.pareto.frontier_rows` shape).

    One row per stored (switching_cost × stickiness × policy) operating
    point, grouped by scenario and sorted by realized latency;
    ``QF``/``AF`` mark membership of the (QoS ↑, miss ↓) and
    (accuracy ↑, latency ↓) frontiers with a ``*``.
    """
    lines = [f"{'scenario':<22} {'sw_cost':>7} {'stick':>6} {'policy':<9} "
             f"{'qos':>7} {'miss':>6} {'acc':>6} {'lat_s':>8} "
             f"{'QF':>3} {'AF':>3}"]
    for scenario in sorted(rows):
        # NaN latency (a point that served nothing) sorts last, stably
        pts = sorted(rows[scenario],
                     key=lambda p: (np.isnan(p["mean_latency_s"]),
                                    p["mean_latency_s"], -p["mean_qos"]))
        for p in pts:
            lines.append(
                f"{scenario:<22} {p['switching_cost']:>7.2f} "
                f"{p['stickiness']:>6.2f} {p['policy']:<9} "
                f"{p['mean_qos']:>7.4f} {p['miss_rate']:>6.3f} "
                f"{p['mean_accuracy']:>6.3f} {p['mean_latency_s']:>8.4f} "
                f"{'*' if p['qos_frontier'] else '':>3} "
                f"{'*' if p['acc_lat_frontier'] else '':>3}")
    return "\n".join(lines)


def fig4_table(results: "List[Tuple[str, SweepResult]]",
               algo: str = "egp", ref: str = "sck") -> str:
    """Fig-4-shaped scaling table: one labelled sweep per row (e.g. one per
    instance size), reporting mean σ and the ``algo``/``ref`` ratio."""
    lines = [f"{'label':<16} {'mean ' + algo:>12} {'mean ' + ref:>12} "
             f"{algo + '/' + ref:>10}"]
    for label, result in results:
        va = np.concatenate([v.ravel() for (vr, a), v in
                             result.values.items() if a == algo])
        vr_ = np.concatenate([v.ravel() for (vr, a), v in
                              result.values.items() if a == ref])
        r = float(np.nanmean(va) / max(np.nanmean(vr_), 1e-9))
        lines.append(f"{label:<16} {np.nanmean(va):>12.2f} "
                     f"{np.nanmean(vr_):>12.2f} {r:>10.3f}")
    return "\n".join(lines)
