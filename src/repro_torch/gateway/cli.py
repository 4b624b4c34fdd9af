"""``python -m repro_torch.gateway`` — serve / loadgen / replay / soak.

The operational entry points of the live control plane:

* ``serve`` — bind the TCP ingest socket and run the gateway until the
  stream ends (``eos``) or the horizon completes; mount a telemetry
  stream with ``--stream`` (or ``REPRO_OBS_STREAM``) and watch it live
  with ``python -m repro_torch.obs dash``.
* ``loadgen`` — aim the open-loop trace replayer at a running gateway.
* ``replay`` — the determinism check, in-process: run the same seeded
  trace through the virtual-clock gateway *and* the offline horizon and
  compare result digests byte-for-byte (exit 1 on divergence).
* ``soak`` — the judged wall-clock soak (exit 1 when the run is not
  bounded / clean); ``--json`` prints the full report.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import List, Optional

__all__ = ["main"]


def _hconfig(args: argparse.Namespace):
    from repro_torch.serving.horizon import (HorizonConfig,
                                       split_serving_overrides)
    overrides = {}
    for item in args.override or []:
        k, _, v = item.partition("=")
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    scen_ov, serving = split_serving_overrides(overrides)
    return HorizonConfig(scenario=args.scenario, policy=args.policy,
                         seed=args.seed, n_ticks=args.n_ticks,
                         overrides=tuple(sorted(scen_ov.items())),
                         **serving)


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scenario", default="trace_replay_bursty")
    p.add_argument("--policy", default="feedback")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-ticks", type=int, default=None)
    p.add_argument("--override", action="append", metavar="K=V",
                   help="scenario/serving override (repeatable)")
    p.add_argument("--speed", type=float, default=1.0,
                   help="RPS multiplier over the trace's native rate")
    p.add_argument("--reqtrace", default=None, metavar="PATH",
                   help="enable per-request causal tracing and save the "
                        "sampled traces here (feed to `repro_torch.obs "
                        "explain`)")
    p.add_argument("--reqtrace-sample", type=int, default=16,
                   metavar="N", help="hash-sample 1-in-N ordinary "
                                     "requests (misses/drops/requeues "
                                     "are always kept; default 16)")
    p.add_argument("--ledger", default=None, metavar="PATH",
                   help="enable the greedy decision ledger and save the "
                        "JSONL here (feed to `repro_torch.obs why`)")


def _enable_v3(args: argparse.Namespace):
    """Turn on reqtrace/ledger per the flags; return the saver."""
    from repro_torch.obs import ledger as _ledger
    from repro_torch.obs import reqtrace as _reqtrace

    if getattr(args, "reqtrace", None):
        _reqtrace.enable_request_tracing(sample_every=args.reqtrace_sample)
    if getattr(args, "ledger", None):
        _ledger.enable_ledger()

    def _save() -> None:
        if getattr(args, "reqtrace", None):
            rt = _reqtrace.disable_request_tracing()
            if rt is not None:
                rt.save(args.reqtrace)
                print(f"[gateway] reqtrace: {len(rt.kept())} sampled "
                      f"trace(s) -> {args.reqtrace}", flush=True)
        if getattr(args, "ledger", None):
            led = _ledger.disable_ledger()
            if led is not None:
                led.save(args.ledger)
                print(f"[gateway] ledger: {len(led.records())} epoch "
                      f"record(s) -> {args.ledger}", flush=True)

    return _save


def _cmd_serve(args: argparse.Namespace) -> int:
    from repro_torch import obs
    from .server import Gateway, GatewayConfig

    if args.stream:
        obs.enable_stream(args.stream, source="gateway")
    else:
        obs.enable_stream_from_env()
    save_v3 = _enable_v3(args)
    host, _, port = args.listen.rpartition(":")
    gw = Gateway(GatewayConfig(
        horizon=_hconfig(args),
        mode="virtual" if args.virtual else "wall",
        speed=args.speed, max_ingress=args.max_ingress))

    async def _serve():
        task = asyncio.ensure_future(gw.serve(host or "127.0.0.1",
                                              int(port)))
        while gw.bound_port is None and not task.done():
            await asyncio.sleep(0.01)
        if gw.bound_port is not None:
            print(f"[gateway] ingest on {host or '127.0.0.1'}:"
                  f"{gw.bound_port} ({gw.config.mode} mode, "
                  f"x{gw.config.speed:g})", flush=True)
        return await task

    result = asyncio.run(_serve())
    save_v3()
    print(f"[gateway] done: {len(result.per_tick)} tick(s), "
          f"{result.served}/{result.submitted} served, "
          f"qos {result.mean_realized_qos:.4f}, "
          f"miss {result.miss_rate:.4f}", flush=True)
    return 0


def _cmd_loadgen(args: argparse.Namespace) -> int:
    from .loadgen import tcp_loadgen

    host, _, port = args.connect.rpartition(":")
    report = asyncio.run(tcp_loadgen(
        host or "127.0.0.1", int(port), _hconfig(args),
        speed=args.speed, n_ticks=args.n_ticks,
        max_wall_s=args.max_wall_s))
    print(json.dumps(report.to_json()), flush=True)
    return 0


def _cmd_replay(args: argparse.Namespace) -> int:
    from repro_torch.serving.horizon import run_horizon
    from .control import result_digest
    from .loadgen import run_loadgen
    from .server import Gateway, GatewayConfig

    hconfig = _hconfig(args)
    save_v3 = _enable_v3(args)
    gw = Gateway(GatewayConfig(horizon=hconfig, mode="virtual"))

    async def _replay():
        async def send(line: str) -> None:
            gw.submit_line(line)

        task = asyncio.ensure_future(gw.run())
        await run_loadgen(send, hconfig, wall=False)
        return await task

    live = asyncio.run(_replay())
    save_v3()   # live-run traces only — the offline half runs untraced
    offline = run_horizon(hconfig)
    d_live, d_off = result_digest(live), result_digest(offline)
    match = d_live == d_off
    print(f"live    {d_live}\noffline {d_off}\n"
          f"parity: {'OK — byte-identical' if match else 'FAIL'}",
          flush=True)
    return 0 if match else 1


def _cmd_soak(args: argparse.Namespace) -> int:
    from repro_torch import obs
    from .soak import run_soak

    # REPRO_OBS_STREAM=<spec> → per-tick gateway frames stream live
    # during the soak (tail them with `python -m repro_torch.obs dash`)
    obs.enable_stream_from_env(source="gateway")
    save_v3 = _enable_v3(args)
    overrides = {}
    for item in args.override or []:
        k, _, v = item.partition("=")
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    report = run_soak(args.scenario, seed=args.seed, policy=args.policy,
                      speed=args.speed, duration_s=args.duration,
                      tcp=args.tcp, max_ingress=args.max_ingress,
                      overrides=overrides)
    save_v3()
    if args.json:
        print(json.dumps(report.to_json(), indent=2), flush=True)
    else:
        print(report.line(), flush=True)
    return 0 if report.ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.gateway",
        description="live serving control plane")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the asyncio gateway")
    _add_run_args(p)
    p.add_argument("--listen", default="127.0.0.1:0",
                   metavar="HOST:PORT")
    p.add_argument("--virtual", action="store_true",
                   help="eot-driven virtual clock (deterministic replay)")
    p.add_argument("--max-ingress", type=int, default=65536)
    p.add_argument("--stream", default=None,
                   help="telemetry stream spec (file / unix:… / tcp:…)")
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("loadgen", help="replay a trace at a gateway")
    _add_run_args(p)
    p.add_argument("--connect", required=True, metavar="HOST:PORT")
    p.add_argument("--max-wall-s", type=float, default=None)
    p.set_defaults(fn=_cmd_loadgen)

    p = sub.add_parser("replay",
                       help="virtual-clock parity check vs offline")
    _add_run_args(p)
    p.set_defaults(fn=_cmd_replay)

    p = sub.add_parser("soak", help="judged wall-clock soak run")
    _add_run_args(p)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--tcp", action="store_true",
                   help="route ingest over a real TCP socket")
    p.add_argument("--max-ingress", type=int, default=65536)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_soak)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
