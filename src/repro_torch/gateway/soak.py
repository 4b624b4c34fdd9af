"""Soak harness: sustained high-RPS wall-clock runs, judged.

The acceptance bar for the live control plane is operational, not just
statistical: at ``speed×`` the trace's native request rate, sustained
for a wall-clock duration, the gateway must (a) keep its backlog
**bounded** — no monotonic queue growth, which is the signature of a
control loop that has fallen behind its arrival process — and (b) keep
its event loop honest: tick boundaries fire close to their deadlines
(p99 loop lag) and requests clear ingest quickly (p99 admission
latency). :func:`run_soak` wires an open-loop generator
(:mod:`repro_torch.gateway.loadgen`) straight into a wall-mode
:class:`~repro_torch.gateway.server.Gateway` inside one event loop — or over
a real TCP socket — runs for the requested duration, and renders a
pass/fail :class:`SoakReport`. The verdict judges the host's wall clock
(how busy its cores are), not the control loop's arithmetic.

Boundedness test: the scheduler-backlog trajectory at tick boundaries
is split in half; the run is *bounded* when the later half's mean depth
is no worse than the earlier half's mean plus one tick's worth of
arrivals (steady state or draining — growth slower than that cannot
compound), and the maximum never hits the ingress bound.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from typing import Any, Dict, Optional

from repro_torch.serving.horizon import HorizonConfig

from .loadgen import run_loadgen, tcp_loadgen
from .server import Gateway, GatewayConfig

__all__ = ["SoakReport", "run_soak"]


@dataclasses.dataclass
class SoakReport:
    """One judged soak run (all latencies wall-clock milliseconds)."""

    scenario: str
    seed: int
    policy: str
    speed: float
    requested_s: float       # wall budget asked for
    wall_s: float            # wall actually spent
    ticks: int
    sent: int                # envelopes the generator delivered
    admitted: int            # envelopes the control loop admitted
    dropped_ingress: int
    late: int
    sustained_rps: float     # admitted / wall_s
    p99_admission_ms: float
    p99_loop_lag_ms: float
    max_queue_depth: int     # scheduler backlog, max over boundaries
    final_queue_depth: int
    max_ingress_depth: int
    bounded: bool            # no monotonic backlog growth (see module doc)

    @property
    def ok(self) -> bool:
        return (self.bounded and self.ticks > 0
                and self.dropped_ingress == 0)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d

    def line(self) -> str:
        state = "OK " if self.ok else "FAIL"
        return (f"[{state}] soak {self.scenario}/s{self.seed} "
                f"x{self.speed:g}: {self.sustained_rps:.1f} req/s over "
                f"{self.wall_s:.1f}s ({self.ticks} ticks, "
                f"{self.admitted} admitted), p99 admission "
                f"{self.p99_admission_ms:.1f} ms, p99 lag "
                f"{self.p99_loop_lag_ms:.1f} ms, queue max/final "
                f"{self.max_queue_depth}/{self.final_queue_depth}"
                f"{'' if self.bounded else ' UNBOUNDED'}")


def _bounded(depths, per_tick_arrivals: float, max_ingress: int,
             max_depth: int) -> bool:
    if len(depths) < 2:
        return True
    if max_depth >= max_ingress:
        return False
    half = len(depths) // 2
    early = sum(depths[:half]) / half
    late = sum(depths[half:]) / (len(depths) - half)
    return late <= early + per_tick_arrivals


async def _soak(hconfig: HorizonConfig, *, speed: float,
                duration_s: float, tcp: bool,
                max_ingress: int) -> SoakReport:
    n_ticks = max(1, math.ceil(duration_s * speed
                               / hconfig.tick_duration))
    hconfig = dataclasses.replace(hconfig, n_ticks=n_ticks)
    gw = Gateway(GatewayConfig(horizon=hconfig, mode="wall", speed=speed,
                               max_ingress=max_ingress))
    t0 = time.monotonic()
    if tcp:
        server_task = asyncio.ensure_future(gw.serve())
        while gw.bound_port is None:      # bind races the first connect
            await asyncio.sleep(0.005)
        lg_task = asyncio.ensure_future(tcp_loadgen(
            "127.0.0.1", gw.bound_port, hconfig, speed=speed,
            n_ticks=n_ticks, max_wall_s=duration_s))
    else:
        async def send(line: str) -> None:
            gw.submit_line(line)

        server_task = asyncio.ensure_future(gw.run())
        lg_task = asyncio.ensure_future(run_loadgen(
            send, hconfig, speed=speed, n_ticks=n_ticks,
            max_wall_s=duration_s))
    lg = await lg_task
    await server_task
    wall_s = time.monotonic() - t0

    depths = [e["queue_depth"] for e in gw.tick_log]
    admitted = int(gw.counters["gateway.admitted"])
    per_tick = lg.sent / max(lg.ticks, 1)
    return SoakReport(
        scenario=hconfig.scenario, seed=hconfig.seed,
        policy=hconfig.policy, speed=speed, requested_s=duration_s,
        wall_s=wall_s, ticks=len(gw.tick_log), sent=lg.sent,
        admitted=admitted,
        dropped_ingress=int(gw.counters["gateway.dropped_ingress"]),
        late=int(gw.counters["gateway.late"]),
        sustained_rps=admitted / wall_s if wall_s > 0 else 0.0,
        p99_admission_ms=gw.registry.histogram(
            "gateway.admission_ms").quantile(0.99),
        p99_loop_lag_ms=gw.registry.histogram(
            "gateway.loop_lag_ms").quantile(0.99),
        max_queue_depth=max(depths, default=0),
        final_queue_depth=depths[-1] if depths else 0,
        max_ingress_depth=gw.max_ingress_depth,
        bounded=_bounded(depths, per_tick, max_ingress,
                         max(depths, default=0)))


def run_soak(scenario: str = "trace_replay_bursty", *, seed: int = 0,
             policy: str = "feedback", speed: float = 10.0,
             duration_s: float = 30.0, tcp: bool = False,
             max_ingress: int = 65536,
             overrides: Optional[Dict[str, Any]] = None) -> SoakReport:
    """Run one judged wall-clock soak (see module docstring)."""
    from repro_torch.serving.horizon import split_serving_overrides

    scen_ov, serving = split_serving_overrides(overrides or {})
    hconfig = HorizonConfig(scenario=scenario, policy=policy,
                            seed=int(seed),
                            overrides=tuple(sorted(scen_ov.items())),
                            **serving)
    return asyncio.run(_soak(hconfig, speed=speed, duration_s=duration_s,
                             tcp=tcp, max_ingress=max_ingress))
