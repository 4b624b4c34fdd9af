"""Open-loop wall-clock load generator replaying scenario traces.

The generator owns the *demand* side of the live control plane: it
materializes each tick's user set from the same seeded scenario machinery
the offline horizon uses (``Scenario.instance_at`` + the serving
driver's arrival-time padding), serializes every request as a wire
envelope (:mod:`repro_torch.gateway.control`), and delivers it **open-loop**:
each envelope is sent at its scheduled wall time ``arrival / speed``
regardless of whether the gateway has kept up. Open-loop is the honest
load model — a closed-loop generator silently self-throttles against a
slow server and hides exactly the overload the soak test exists to
measure (cf. the coordinated-omission literature).

``speed`` is the RPS multiplier: ``speed=10`` replays the trace at 10×
its native rate (one simulated tick every ``tick_duration / 10`` wall
seconds). The virtual mode sends every envelope back-to-back with no
pacing at all — the ``eot`` sentinels alone define tick boundaries, so
a virtual replay is deterministic and as fast as the CPU allows.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Awaitable, Callable, List, Optional

import numpy as np

from repro_torch.serving.horizon import HorizonConfig, _arrival_times

from .control import RequestEnvelope, eos_frame, eot_frame

__all__ = ["LoadgenReport", "tick_envelopes", "run_loadgen",
           "tcp_loadgen"]

#: async callable delivering one wire line to the gateway
SendFn = Callable[[str], Awaitable[None]]


@dataclasses.dataclass
class LoadgenReport:
    """What one load-generation run actually delivered."""

    ticks: int
    sent: int               # request envelopes delivered
    wall_s: float           # wall-clock duration of the run
    target_rps: float       # scheduled request rate (speed-scaled)
    achieved_rps: float     # sent / wall_s

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def tick_envelopes(scenario, config: HorizonConfig, tick: int,
                   mobility_cache: Optional[np.ndarray] = None
                   ) -> List[RequestEnvelope]:
    """Tick ``tick``'s request envelopes from the seeded scenario.

    Uses the exact same generator calls as the offline horizon
    (``instance_at`` + ``_arrival_times``), so a lossless delivery of
    these envelopes reconstructs, on the gateway side, instances
    byte-identical to what ``run_horizon`` would have materialized.
    """
    inst = scenario.instance_at(config.seed, tick,
                                mobility_cache=mobility_cache)
    times = _arrival_times(scenario, config.seed, tick, inst.U,
                           config.tick_duration)
    return [RequestEnvelope(tick=tick, u=u, edge=int(inst.u_edge[u]),
                            service=int(inst.u_service[u]),
                            alpha=float(inst.u_alpha[u]),
                            delta=float(inst.u_delta[u]),
                            arrival=float(times[u]))
            for u in range(inst.U)]


async def run_loadgen(send: SendFn, config: HorizonConfig, *,
                      speed: float = 1.0, n_ticks: Optional[int] = None,
                      wall: bool = True,
                      max_wall_s: Optional[float] = None,
                      send_eos: bool = True) -> LoadgenReport:
    """Replay the configured scenario into ``send``, one line at a time.

    ``wall=True`` paces each envelope to its scheduled wall time
    ``arrival / speed`` (open-loop; a late generator sends immediately
    and never skips); ``wall=False`` streams everything back-to-back
    for deterministic virtual-clock replay. ``max_wall_s`` stops the
    replay at a wall-clock budget (soak runs), always finishing the
    current tick + its ``eot`` so the gateway never sees a torn tick.
    """
    import asyncio

    from repro_torch.workloads import get_scenario

    scenario = get_scenario(config.scenario, **dict(config.overrides))
    T = int(n_ticks or config.n_ticks or scenario.n_ticks)
    cache = scenario.mobility_trajectory(config.seed, T)
    t0 = time.monotonic()
    sent = 0
    ticks = 0
    for t in range(T):
        envs = tick_envelopes(scenario, config, t, mobility_cache=cache)
        for env in envs:
            if wall:
                due = t0 + env.arrival / speed
                delay = due - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
            await send(env.to_line())
            sent += 1
        await send(eot_frame(t, len(envs)))
        ticks += 1
        if max_wall_s is not None and time.monotonic() - t0 >= max_wall_s:
            break
    if send_eos:
        await send(eos_frame())
    wall_s = time.monotonic() - t0
    native_rps = sent / (ticks * config.tick_duration) if ticks else 0.0
    return LoadgenReport(
        ticks=ticks, sent=sent, wall_s=wall_s,
        target_rps=native_rps * speed if wall else float("inf"),
        achieved_rps=sent / wall_s if wall_s > 0 else float("inf"))


async def tcp_loadgen(host: str, port: int, config: HorizonConfig,
                      **kwargs: Any) -> LoadgenReport:
    """Aim :func:`run_loadgen` at a gateway's TCP ingest socket."""
    import asyncio

    reader, writer = await asyncio.open_connection(host, port)
    del reader  # ingest is one-way; the gateway never writes back

    async def send(line: str) -> None:
        writer.write(line.encode())
        await writer.drain()

    try:
        return await run_loadgen(send, config, **kwargs)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
