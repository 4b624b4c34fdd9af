"""Command-line entry point: ``python -m repro_torch.obs`` (the port of
``python -m repro.obs``: the same subcommands, flags, stdout and exit
codes on the same files).

Operates on the artifacts either package produces::

    # summarize a saved obs artifact (spans, counters, histograms)
    python -m repro_torch.obs report experiments/obs/trace.json

    # convert to Chrome-trace / Perfetto JSON (open in ui.perfetto.dev)
    python -m repro_torch.obs export experiments/obs/trace.json \\
        --format chrome-trace --out /tmp/trace_chrome.json

    # metrics snapshot as versioned JSONL
    python -m repro_torch.obs export experiments/obs/trace.json \\
        --format jsonl --out /tmp/metrics.jsonl

    # live rate/ETA of a running fleet (worker telemetry + queue)
    python -m repro_torch.obs tail --root experiments/fleet/demo --interval 2

    # live terminal dashboard over telemetry streams (REPRO_OBS_STREAM)
    python -m repro_torch.obs dash --stream /tmp/stream.jsonl
    python -m repro_torch.obs dash --root experiments/fleet/demo  # workers

    # stitch every worker artifact of a fleet run into ONE Chrome trace
    python -m repro_torch.obs stitch --root experiments/fleet/demo \\
        --out /tmp/fleet_chrome.json

    # evaluate SLOs against a stream / artifact / benchmark JSON
    python -m repro_torch.obs slo --stream /tmp/stream.jsonl
    python -m repro_torch.obs slo --bench BENCH_latest.json --spec slos.json

    # causal chain of one sampled request (reqtrace export or stream)
    python -m repro_torch.obs explain --uid 1234 --trace /tmp/reqtrace.json

    # greedy decision provenance for a placement epoch
    python -m repro_torch.obs why --tick 3 --ledger /tmp/ledger.jsonl

Artifacts come from ``python -m repro_torch.sweeps ... --obs PATH``, from
``REPRO_OBS=1 REPRO_OBS_DIR=...`` in any instrumented process, or from
``Tracer.save`` directly. Streams come from ``REPRO_OBS_STREAM`` /
``--stream`` (see :mod:`repro_torch.obs.stream`). ``tail``, ``dash --root``
and ``stitch`` read a fleet root (``python -m repro_torch.fleet``, or the
reference's, whose layout is the same).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from .metrics import METRICS_SCHEMA_VERSION
from .trace import load_artifact, to_chrome_trace, validate_chrome_trace

__all__ = ["main", "report_text", "span_summaries"]


def span_summaries(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-span-name aggregate rows from a raw artifact (exact
    percentiles — the artifact carries every live span)."""
    names = doc.get("names", [])
    spans = doc.get("spans", {})
    ids = np.asarray(spans.get("name", []), np.int64)
    t0 = np.asarray(spans.get("t0_ns", []), np.float64)
    t1 = np.asarray(spans.get("t1_ns", []), np.float64)
    rows = []
    for nid in sorted(set(ids.tolist())):
        dur_ms = (t1[ids == nid] - t0[ids == nid]) / 1e6
        rows.append({
            "name": names[nid], "count": int(dur_ms.size),
            "total_ms": float(dur_ms.sum()),
            "mean_ms": float(dur_ms.mean()),
            "p50_ms": float(np.percentile(dur_ms, 50)),
            "p95_ms": float(np.percentile(dur_ms, 95)),
            "p99_ms": float(np.percentile(dur_ms, 99)),
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def report_text(doc: Dict[str, Any]) -> str:
    """The ``obs report`` table: spans by total time, then counters and
    histogram digests."""
    out = []
    rows = span_summaries(doc)
    if rows:
        out.append(f"{'span':<32} {'count':>7} {'total_ms':>10} "
                   f"{'mean_ms':>9} {'p50_ms':>9} {'p95_ms':>9} "
                   f"{'p99_ms':>9}")
        for r in rows:
            out.append(f"{r['name']:<32} {r['count']:>7d} "
                       f"{r['total_ms']:>10.3f} {r['mean_ms']:>9.3f} "
                       f"{r['p50_ms']:>9.3f} {r['p95_ms']:>9.3f} "
                       f"{r['p99_ms']:>9.3f}")
    else:
        out.append("(no spans recorded)")
    dropped = doc.get("dropped_spans", 0)
    if dropped:
        out.append(f"! ring wrapped: {dropped} oldest span(s) dropped")
    counters = doc.get("counters", {})
    if counters:
        out.append("")
        out.append("counters:")
        for name, v in sorted(counters.items()):
            out.append(f"  {name:<38} {v:g}")
    hists = [m for m in doc.get("metrics", [])
             if m.get("kind") == "histogram"]
    if hists:
        out.append("")
        out.append(f"{'histogram':<38} {'count':>7} {'mean':>10} "
                   f"{'p50':>10} {'p95':>10} {'p99':>10}")
        for m in hists:
            labels = ",".join(f"{k}={v}"
                              for k, v in sorted(m["labels"].items()))
            label = m["name"] + ("{" + labels + "}" if labels else "")
            out.append(f"{label:<38} {m['count']:>7d} {m['mean']:>10.4g} "
                       f"{m['p50']:>10.4g} {m['p95']:>10.4g} "
                       f"{m['p99']:>10.4g}")
    return "\n".join(out)


def _cmd_report(args: argparse.Namespace) -> int:
    print(report_text(load_artifact(args.artifact)))
    return 0


def _cmd_export(args: argparse.Namespace) -> int:
    doc = load_artifact(args.artifact)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.format == "chrome-trace":
        chrome = to_chrome_trace(doc)
        n = validate_chrome_trace(chrome)
        out.write_text(json.dumps(chrome))
        print(f"[obs] wrote {n} duration event(s) "
              f"({len(chrome['traceEvents'])} total) to {out} — load in "
              f"ui.perfetto.dev or chrome://tracing")
    else:  # jsonl
        lines = [json.dumps(rec, separators=(",", ":"))
                 for rec in doc.get("metrics", [])]
        for name, value in sorted(doc.get("counters", {}).items()):
            lines.append(json.dumps(
                {"metrics_schema": METRICS_SCHEMA_VERSION,
                 "kind": "counter", "name": name, "labels": {},
                 "value": value}, separators=(",", ":")))
        for row in span_summaries(doc):
            lines.append(json.dumps(
                {"metrics_schema": METRICS_SCHEMA_VERSION,
                 "kind": "span_summary", "labels": {}, **row},
                separators=(",", ":")))
        out.write_text("".join(line + "\n" for line in lines))
        print(f"[obs] wrote {len(lines)} metric record(s) to {out}")
    return 0


def _fleet_line(status: Dict[str, Any]) -> str:
    q = status["queue"]
    parts = [f"pending {q['pending']}", f"leased {q['leased']}",
             f"done {q['done']}"]
    if status.get("remaining_items") is not None:
        parts.append(f"remaining {status['remaining_items']} item(s)")
    rate = status.get("rate_items_per_s")
    if rate:
        parts.append(f"{rate:.2f} items/s")
    eta = status.get("eta_s")
    if eta is not None:
        parts.append(f"ETA {eta:.0f}s")
    return "[obs tail] " + ", ".join(parts)


def _cmd_tail(args: argparse.Namespace) -> int:
    from repro_torch.fleet.coordinator import status  # deferred: heavy import

    while True:
        out = status(args.root)
        print(_fleet_line(out), flush=True)
        for name, w in sorted(out.get("telemetry", {}).items()):
            wall = w.get("last_task_wall_s")
            print(f"  {name:<24} {w.get('items_done', 0):>6} item(s) "
                  f"{w.get('items_per_s', 0.0):>7.2f} items/s"
                  + (f"  last chunk {wall:.2f}s" if wall else ""),
                  flush=True)
        if args.once:
            return 0
        q = out["queue"]
        if q["pending"] == 0 and q["leased"] == 0:
            print("[obs tail] queue drained", flush=True)
            return 0
        time.sleep(args.interval)


def _dash_specs(args: argparse.Namespace) -> List[str]:
    """--stream specs plus every per-worker stream under --root."""
    specs = list(args.stream or [])
    if getattr(args, "root", None):
        specs += [str(p) for p in
                  sorted((Path(args.root) / "stream").glob("*.jsonl"))]
    return specs


def _cmd_dash(args: argparse.Namespace) -> int:
    from .dash import run_dash
    from .slo import DEFAULT_SLOS, load_slos

    specs = _dash_specs(args)
    if not specs:
        print("[obs] dash: no streams — pass --stream SPEC and/or --root "
              "FLEET_ROOT (workers publish streams when REPRO_OBS_STREAM "
              "is set)", file=sys.stderr)
        return 2
    slos = load_slos(args.spec) if args.spec else DEFAULT_SLOS
    return run_dash(specs, interval=args.interval, timeout_s=args.timeout,
                    once=args.once, max_frames=args.max_frames, slos=slos,
                    clear=not args.no_clear and sys.stdout.isatty())


def _cmd_stitch(args: argparse.Namespace) -> int:
    from .aggregate import stitch_fleet

    summary = stitch_fleet(args.root, out=args.out)
    print(f"[obs] stitched {summary['n_artifacts']} worker artifact(s) "
          f"into {summary['n_events']} validated event(s)"
          + (f" -> {args.out}" if args.out else ""))
    for label, pid in sorted(summary["workers"].items()):
        print(f"  {label:<28} pid {pid}")
    hists = [m for m in summary["metrics"] if m.get("kind") == "histogram"]
    if hists:
        print(f"  rolled-up histograms: "
              + ", ".join(sorted({m['name'] for m in hists})))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        doc = {k: v for k, v in summary.items() if k != "chrome_trace"}
        Path(args.json).write_text(json.dumps(doc, indent=1))
    return 0


def _cmd_explain(args: argparse.Namespace) -> int:
    from .reqtrace import explain_uid, load_reqtrace

    doc = load_reqtrace(args.trace)
    print(explain_uid(doc, args.uid, tick=args.tick))
    return 0


def _cmd_why(args: argparse.Namespace) -> int:
    from .ledger import load_ledger, why_text

    recs = load_ledger(args.ledger)
    if args.tick is not None:
        recs = [r for r in recs if r.get("tick") == args.tick]
    if not recs:
        have = sorted({r.get("tick") for r in load_ledger(args.ledger)})
        raise ValueError(
            f"no decision record for tick {args.tick} in {args.ledger}"
            f" (ticks with records: {have})" if args.tick is not None
            else f"no decision records in {args.ledger}")
    for rec in recs[-1:] if args.tick is None else recs:
        print(why_text(rec, edge=args.edge))
    return 0


def _cmd_slo(args: argparse.Namespace) -> int:
    from .slo import DEFAULT_SLOS, evaluate_slos, load_slos
    from .stream import read_stream

    slos = load_slos(args.spec) if args.spec else list(DEFAULT_SLOS)
    frames: List[Dict[str, Any]] = []
    for spec in args.stream or []:
        frames.extend(read_stream(spec, follow=False))
    metrics = counters = None
    if args.artifact:
        doc = load_artifact(args.artifact)
        metrics = doc.get("metrics", [])
        counters = doc.get("counters", {})
    bench = json.loads(Path(args.bench).read_text()) if args.bench else None
    reports = evaluate_slos(slos, frames=frames, metrics=metrics,
                            counters=counters, bench=bench)
    for r in reports:
        print(r.line())
    failed = [r for r in reports if not r.ok]
    if failed:
        print(f"[obs] {len(failed)} SLO(s) violated", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect and export repro_torch.obs trace artifacts; "
                    "tail a running fleet's telemetry.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="text summary of a saved artifact")
    rp.add_argument("artifact")
    rp.set_defaults(fn=_cmd_report)

    ex = sub.add_parser("export", help="convert an artifact to "
                                       "chrome-trace or metrics JSONL")
    ex.add_argument("artifact")
    ex.add_argument("--format", choices=("chrome-trace", "jsonl"),
                    default="chrome-trace")
    ex.add_argument("--out", required=True)
    ex.set_defaults(fn=_cmd_export)

    tl = sub.add_parser("tail", help="live fleet rate/ETA from worker "
                                     "telemetry")
    tl.add_argument("--root", required=True, help="fleet root directory")
    tl.add_argument("--interval", type=float, default=2.0)
    tl.add_argument("--once", action="store_true",
                    help="print one status line and exit")
    tl.set_defaults(fn=_cmd_tail)

    da = sub.add_parser("dash", help="live terminal dashboard over "
                                     "telemetry streams")
    da.add_argument("--stream", action="append", metavar="SPEC",
                    help="stream to tail: JSONL path, unix:/path, or "
                         "tcp:host:port; repeatable")
    da.add_argument("--root", default=None,
                    help="fleet root — tails every <root>/stream/*.jsonl")
    da.add_argument("--spec", default=None, metavar="PATH",
                    help="SLO spec JSON (default: built-in serving SLOs)")
    da.add_argument("--interval", type=float, default=1.0)
    da.add_argument("--timeout", type=float, default=10.0,
                    help="idle seconds before a stream is considered over")
    da.add_argument("--once", action="store_true",
                    help="drain what is buffered, render one screen, exit "
                         "(exit 2 when no frames arrived)")
    da.add_argument("--max-frames", type=int, default=None)
    da.add_argument("--no-clear", action="store_true")
    da.set_defaults(fn=_cmd_dash)

    sti = sub.add_parser("stitch", help="merge a fleet's per-worker obs "
                                        "artifacts into one Chrome trace")
    sti.add_argument("--root", required=True, help="fleet root directory")
    sti.add_argument("--out", default=None, metavar="PATH",
                     help="write the stitched Chrome trace JSON here")
    sti.add_argument("--json", default=None, metavar="PATH",
                     help="write the stitch summary (workers, counters, "
                          "rolled-up metrics) here")
    sti.set_defaults(fn=_cmd_stitch)

    exp = sub.add_parser("explain", help="reconstruct one request's "
                                         "causal chain from a reqtrace "
                                         "export or stream")
    exp.add_argument("--uid", type=int, required=True,
                     help="request uid (see `obs dash` requests pane or "
                          "the reqtrace export's kept uids)")
    exp.add_argument("--tick", type=int, default=None,
                     help="disambiguate when the uid appears in several "
                          "ticks (uids are unique per run; optional)")
    exp.add_argument("--trace", required=True, metavar="PATH",
                     help="reqtrace snapshot JSON or stream JSONL")
    exp.set_defaults(fn=_cmd_explain)

    wh = sub.add_parser("why", help="greedy decision provenance for one "
                                    "placement epoch: per-pick marginal "
                                    "gains, gain curve, (1-1/e) "
                                    "certificate")
    wh.add_argument("--tick", type=int, default=None,
                    help="placement epoch to explain (default: latest)")
    wh.add_argument("--edge", type=int, default=None,
                    help="only show picks for this edge")
    wh.add_argument("--ledger", required=True, metavar="PATH",
                    help="decision-ledger JSONL or stream JSONL")
    wh.set_defaults(fn=_cmd_why)

    sl = sub.add_parser("slo", help="evaluate SLOs against streams, an "
                                    "artifact, or a benchmark JSON; exit "
                                    "1 on violation")
    sl.add_argument("--spec", default=None, metavar="PATH",
                    help="SLO spec JSON (default: built-in serving SLOs)")
    sl.add_argument("--stream", action="append", metavar="SPEC",
                    help="stream(s) to evaluate tick/metrics frames from")
    sl.add_argument("--artifact", default=None, metavar="PATH",
                    help="saved obs artifact for hist./counter. metrics")
    sl.add_argument("--bench", default=None, metavar="PATH",
                    help="benchmark --json document for bench.*")
    sl.set_defaults(fn=_cmd_slo)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError) as e:
        print(f"[obs] error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
