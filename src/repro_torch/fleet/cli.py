"""Command-line entry point: ``python -m repro_torch.fleet`` (the port of
``python -m repro.fleet``: its subcommands and flags, plus ``worker
--device``).

The multi-worker face of :mod:`repro_torch.sweeps` — same grid grammar,
but the work list becomes a shared lease queue that any number of worker
processes (one host or many, over a shared filesystem) drain into one
store::

    # 1. coordinator: expand the grid into the fleet's task queue
    python -m repro_torch.fleet plan --kind serving --scenario flash_crowd \\
        --seeds 0:32 --override switching_cost=0 --override \\
        switching_cost=2 --root experiments/fleet/demo \\
        --store experiments/sweeps_torch/demo

    # 2. workers: run as many as you like, anywhere that sees the root
    #    (sigma-kind groups run on --device, default cuda)
    python -m repro_torch.fleet worker --root experiments/fleet/demo

    # 3. watch / recover / combine
    python -m repro_torch.fleet status --root experiments/fleet/demo  # --watch
    #    (with REPRO_OBS_STREAM set, --watch tails the workers' live
    #     telemetry streams under <root>/stream/ — see
    #     repro_torch.obs.stream)
    python -m repro_torch.fleet reap   --root experiments/fleet/demo
    python -m repro_torch.fleet merge  --root experiments/fleet/demo \\
        --store experiments/sweeps_torch/demo

(Or let ``python -m repro_torch.sweeps ... --fleet N`` do all of it
locally.)

A SIGKILLed worker's lease expires and any other worker (or ``reap``)
requeues its chunk; ``merge`` dedups by item hash and verifies duplicate
values bit-for-bit, so the merged store is byte-identical in aggregate to
a single-process run of the same spec.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.sweeps.cli import add_spec_arguments, build_spec

from .coordinator import merge, plan, reap, status
from .queue import DEFAULT_TTL_S
from .worker import run_worker

__all__ = ["main"]


def _cmd_plan(args: argparse.Namespace) -> int:
    spec = build_spec(args)
    out = plan(spec, args.root, target_store=args.store,
               seeds_per_task=args.seeds_per_task)
    print(f"[fleet] planned {out['n_tasks']} task(s) / {out['n_items']} "
          f"item(s) under {out['fleet_root']} "
          f"(spec {out['fingerprint']}; {out['skipped_tasks']} task(s) "
          f"already queued, {out['skipped_items']} item(s) already in "
          f"the target store)")
    return 0


def _cmd_worker(args: argparse.Namespace) -> int:
    from repro_torch import obs
    from .queue import default_owner
    obs.enable_from_env()  # REPRO_OBS=1 propagated by spawn_local_workers
    owner = args.owner or default_owner()
    # REPRO_OBS_STREAM=1 → per-worker JSONL under <root>/stream/ (the
    # dashboard and `status --watch` tail these); explicit specs
    # (unix:/tcp:/path) are honored as given.
    obs.enable_stream_from_env(
        default_path=str(Path(args.root) / "stream" / f"{owner}.jsonl"),
        source=owner)
    summary = run_worker(args.root, owner=owner, ttl=args.ttl,
                         max_tasks=args.max_tasks,
                         memory_budget_mb=args.memory_budget_mb,
                         device=args.device, wait=args.wait,
                         poll_interval=args.poll_interval,
                         verbose=args.verbose)
    if not args.verbose:
        print(f"[fleet:{summary['owner']}] {summary['n_tasks']} task(s), "
              f"{summary['n_items']} item(s), stop={summary['stop']}")
    return 0


def _print_status(out: dict) -> None:
    q = out["queue"]
    print(f"[fleet] queue: {q['pending']} pending, {q['leased']} leased "
          f"({q['expired']} expired), {q['done']} done"
          + (f", {len(q['poisoned'])} POISONED ({', '.join(q['poisoned'])})"
             if q.get("poisoned") else "")
          + (f"; spec items: {out['n_spec_items']}"
             if out.get("n_spec_items") is not None else ""))
    rate = out.get("rate_items_per_s") or 0.0
    eta = out.get("eta_s")
    line = (f"[fleet] remaining: {out.get('remaining_items', 0)} item(s)")
    if rate > 0:
        line += f" at {rate:.2f} items/s (live workers)"
    if eta is not None:
        line += f", ETA {eta:.0f}s"
    print(line)
    tele = out.get("telemetry", {})
    for name, n in sorted(out["workers"].items()):
        w = tele.get(name)
        extra = ""
        if w is not None:
            extra = (f"  [{w.get('state')}] "
                     f"{w.get('items_per_s', 0.0):.2f} items/s")
            wall = w.get("last_task_wall_s")
            if wall is not None:
                extra += f", last chunk {wall:.2f}s"
        print(f"  worker {name:<24} {n:>6d} item(s){extra}")
    if "target_items" in out:
        missing = out.get("target_missing")
        print(f"  target store: {out['target_items']} item(s)"
              + (f", {missing} missing" if missing is not None else ""))


def _cmd_status(args: argparse.Namespace) -> int:
    if getattr(args, "watch", False):
        return _watch_status(args)
    out = status(args.root, target_store=args.store)
    _print_status(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


def _watch_status(args: argparse.Namespace) -> int:
    """``status --watch``: live refresh until the queue drains.

    Prefers the workers' live telemetry streams (``<root>/stream/*.jsonl``
    — present when the fleet runs with ``REPRO_OBS_STREAM``); without
    them it degrades to plain heartbeat polling of the telemetry files,
    exactly like repeated ``status`` calls. Exits 0 when no pending or
    leased work remains.
    """
    import time

    from repro_torch.obs.dash import DashState, render
    from repro_torch.obs.stream import StreamError, read_stream

    root = Path(args.root)
    interval = max(float(getattr(args, "interval", 2.0)), 0.05)
    clear = sys.stdout.isatty()
    out = None

    def _drain_streams() -> None:
        streams = sorted((root / "stream").glob("*.jsonl"))
        if not streams:
            return
        state = DashState()
        for p in streams:
            try:
                for frame in read_stream(str(p), follow=False):
                    state.update(frame)
            except (StreamError, OSError):
                continue  # torn tail of a live file; retry next tick
        if state.n_frames:
            print()
            print(render(state))

    while True:
        out = status(args.root, target_store=args.store)
        if clear:
            sys.stdout.write("\x1b[H\x1b[2J")
        _print_status(out)
        q = out["queue"]
        if q["pending"] == 0 and q["leased"] == 0:
            # Final flush: workers emit their last frames (bye, metrics
            # rollups) around the moment the queue drains — re-read the
            # streams once after observing the drain so those frames make
            # the final screen instead of being dropped on exit.
            time.sleep(min(interval, 0.2))
            _drain_streams()
            break
        _drain_streams()
        time.sleep(interval)
    if args.json and out is not None:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


def _cmd_reap(args: argparse.Namespace) -> int:
    names = reap(args.root, ttl=args.ttl)
    print(f"[fleet] requeued {len(names)} expired lease(s)"
          + (": " + ", ".join(names) if names else ""))
    return 0


def _cmd_merge(args: argparse.Namespace) -> int:
    out = merge(args.root, args.store)
    print(f"[fleet] merged {out['merged_items']} item(s) from "
          f"{len(out['workers'])} worker store(s); "
          f"{out['duplicate_items']} duplicate(s) verified bit-for-bit; "
          f"target now holds {out['target_items']} item(s)"
          + (f", {out['missing_items']} still missing"
             if out.get("missing_items") else ""))
    return 0 if not out.get("missing_items") else 2


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Multi-worker sweep dispatch: one spec, one lease "
                    "queue, N workers, one crash-safe merged store.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("plan", help="expand a sweep grid into the fleet "
                                     "task queue")
    add_spec_arguments(pl)
    pl.add_argument("--root", required=True,
                    help="fleet root directory (queue + worker stores)")
    pl.add_argument("--store", default=None,
                    help="target store: seeds already complete there are "
                         "not enqueued")
    pl.add_argument("--seeds-per-task", type=int, default=1,
                    help="seeds per claimable task (default: 1; lease "
                         "TTL is a worker property — see worker --ttl)")
    pl.set_defaults(fn=_cmd_plan)

    wk = sub.add_parser("worker", help="claim/execute/append until the "
                                       "queue drains (SIGTERM = clean "
                                       "drain after the current task)")
    wk.add_argument("--root", required=True)
    wk.add_argument("--owner", default=None,
                    help="worker id (default: <host>-<pid>)")
    wk.add_argument("--ttl", type=float, default=DEFAULT_TTL_S)
    wk.add_argument("--max-tasks", type=int, default=None,
                    help="exit after N tasks (smoke/testing)")
    wk.add_argument("--memory-budget-mb", type=float, default=None,
                    help="accelerator memory budget per in-flight chunk "
                         "(default: the sweep engine's)")
    wk.add_argument("--device", default="cuda",
                    help="device of the accelerator algorithms (default: "
                         "cuda; 'cpu' runs the plain PyTorch versions)")
    wk.add_argument("--wait", action="store_true",
                    help="long-poll an empty queue for the next plan "
                         "wave instead of exiting (elastic fleets); "
                         "exit via SIGTERM drain or --max-tasks")
    wk.add_argument("--poll-interval", type=float, default=2.0,
                    help="--wait polling period in seconds")
    wk.add_argument("--verbose", action="store_true")
    wk.set_defaults(fn=_cmd_worker)

    st = sub.add_parser("status", help="queue + worker-store accounting")
    st.add_argument("--root", required=True)
    st.add_argument("--store", default=None)
    st.add_argument("--json", default=None, metavar="PATH")
    st.add_argument("--watch", action="store_true",
                    help="refresh until the queue drains; tails the "
                         "workers' live streams (<root>/stream/*.jsonl) "
                         "when present, else polls heartbeats")
    st.add_argument("--interval", type=float, default=2.0,
                    help="--watch refresh period in seconds")
    st.set_defaults(fn=_cmd_status)

    rp = sub.add_parser("reap", help="requeue expired leases (crash "
                                     "recovery)")
    rp.add_argument("--root", required=True)
    rp.add_argument("--ttl", type=float, default=None,
                    help="TTL for leases whose block never landed")
    rp.set_defaults(fn=_cmd_reap)

    mg = sub.add_parser("merge", help="dedup/verify worker stores into "
                                      "the target store")
    mg.add_argument("--root", required=True)
    mg.add_argument("--store", required=True)
    mg.set_defaults(fn=_cmd_merge)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as e:
        # operator-facing failures (missing queue, spec mismatch, merge
        # conflict) — report, don't traceback
        print(f"[fleet] error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
