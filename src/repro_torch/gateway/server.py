"""The asyncio request gateway: live driver of the serving control loop.

``serving.horizon`` runs the paper's control loop offline — materialize
tick, place (EGP + hysteresis / feedback), route (OMS), execute
(continuous batching) — as fast as the CPU allows. This module runs the
*same* loop (literally the same
:class:`~repro_torch.serving.horizon.TickController`) against requests that
physically arrive over an asyncio ingest path, paced by a pluggable
clock:

* **wall mode** — tick boundaries fire at real deadlines
  ``t0 + (t+1) · tick_duration / speed``; whatever envelopes arrived by
  the deadline are admitted as tick ``t``'s instance
  (:func:`~repro_torch.gateway.control.instance_from_requests`), an empty
  window degrades to
  :meth:`~repro_torch.serving.horizon.TickController.step_idle`, and the
  gateway measures *event-loop lag* (how late each boundary actually
  ran) and *admission latency* (socket receipt → control-loop
  admission) on log-bucketed histograms.
* **virtual mode** — no wall pacing at all: tick ``t`` steps exactly
  when its ``eot`` sentinel is ingested, so the boundary is a property
  of the byte stream, not of task scheduling, and a seeded replay
  produces ``TickReport``\\ s byte-identical to the offline horizon on
  the same ``(config, seed)`` (tested).

Simulation time stays virtual throughout: the scheduler still runs on
simulation seconds, the wall clock only decides *when* control steps
fire. Telemetry flows out through the obs stream protocol — per-tick
``gateway`` frames plus periodic ``metrics`` frames carrying the
gateway histograms — so ``python -m repro_torch.obs dash`` renders a live
server with zero changes to stored artifacts.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Dict, List, Optional

from repro_torch import obs
from repro_torch.obs import reqtrace as _reqtrace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.horizon import (HorizonConfig, HorizonResult,
                                   TickController)

from .control import RequestEnvelope, instance_from_requests, parse_frame

__all__ = ["WallClock", "VirtualClock", "GatewayConfig", "Gateway"]


class WallClock:
    """Real time: ``now()`` is monotonic seconds since construction."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    async def sleep(self, dt: float) -> None:
        if dt > 0:
            await asyncio.sleep(dt)


class VirtualClock:
    """Simulated time: ``sleep`` advances instantly, ``now`` follows.

    Yields to the event loop once per sleep so concurrently scheduled
    tasks still interleave — but nothing in the deterministic replay
    path depends on *how* they interleave (tick boundaries are
    ``eot``-driven, see the module docstring).
    """

    def __init__(self):
        self._t = 0.0

    def now(self) -> float:
        return self._t

    async def sleep(self, dt: float) -> None:
        if dt > 0:
            self._t += dt
        await asyncio.sleep(0)


@dataclasses.dataclass
class GatewayConfig:
    """One gateway deployment = a horizon config + live-serving knobs."""

    horizon: HorizonConfig = dataclasses.field(
        default_factory=HorizonConfig)
    #: ``"wall"`` (real deadlines) or ``"virtual"`` (eot-driven replay)
    mode: str = "wall"
    #: RPS multiplier: one control tick every ``tick_duration/speed``
    #: wall seconds (wall mode only)
    speed: float = 1.0
    #: ingress queue bound — ``req`` frames beyond it are dropped and
    #: counted, sentinels are always accepted (backpressure must never
    #: wedge shutdown)
    max_ingress: int = 65536
    #: emit a ``metrics`` stream frame every N ticks
    metrics_every: int = 10
    #: wall mode: give the first frame this long to arrive before
    #: declaring the run empty
    start_timeout_s: float = 30.0

    def __post_init__(self):
        if self.mode not in ("wall", "virtual"):
            raise ValueError(f"unknown gateway mode {self.mode!r}")
        if self.speed <= 0:
            raise ValueError(f"speed must be > 0, got {self.speed}")


class Gateway:
    """Asyncio ingest + the shared serving control loop.

    One instance is single-use: feed it lines (:meth:`submit_line` from
    any reader task, or point :meth:`serve` at a TCP port) and await
    :meth:`run` for the :class:`~repro_torch.serving.horizon.HorizonResult` —
    the same result type, with the same semantics, as the offline
    driver.
    """

    def __init__(self, config: GatewayConfig):
        self.config = config
        self.ctl = TickController(config.horizon)
        self.clock = VirtualClock() if config.mode == "virtual" \
            else WallClock()
        self.queue: "asyncio.Queue[Dict[str, Any]]" = asyncio.Queue()
        self.registry = MetricsRegistry()
        self._lag_hist = self.registry.histogram("gateway.loop_lag_ms")
        self._adm_hist = self.registry.histogram("gateway.admission_ms")
        self.counters: Dict[str, float] = {
            "gateway.requests": 0, "gateway.admitted": 0,
            "gateway.dropped_ingress": 0, "gateway.late": 0,
            "gateway.malformed": 0, "gateway.ticks": 0,
        }
        self.max_ingress_depth = 0
        #: per-tick operational log (what the soak report aggregates)
        self.tick_log: List[Dict[str, Any]] = []
        self._t0: Optional[float] = None   # wall origin: first frame
        self.bound_port: Optional[int] = None

    # -- ingest ------------------------------------------------------------
    def submit_line(self, line: str) -> None:
        obj = parse_frame(line)
        if obj is None:
            self.counters["gateway.malformed"] += 1
            return
        self.submit(obj)

    def submit(self, obj: Dict[str, Any]) -> None:
        """Enqueue one parsed frame (thread of the event loop only)."""
        if obj.get("type") == "req":
            self.counters["gateway.requests"] += 1
            if self.queue.qsize() >= self.config.max_ingress:
                self.counters["gateway.dropped_ingress"] += 1
                return
            obj["_recv"] = self.clock.now()
        self.queue.put_nowait(obj)
        depth = self.queue.qsize()
        if depth > self.max_ingress_depth:
            self.max_ingress_depth = depth

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                self.submit_line(line.decode("utf-8", errors="replace"))
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- the control loop --------------------------------------------------
    def _step_tick(self, t: int, envs: List[RequestEnvelope],
                   lag_ms: float, admission_ms: List[float]) -> None:
        cfg = self.config
        rt = _reqtrace._REQTRACER
        # the controller assigns tick t's uids as ctl.uid + env.u —
        # capture the base before step() advances it
        uid_base = self.ctl.uid
        if rt is not None and cfg.mode == "wall":
            for env in sorted(envs, key=lambda e: e.u):
                recv = getattr(env, "_recv", None)
                if recv is not None:
                    # socket-receipt time on the wall clock (simulation
                    # timestamps follow at admit)
                    rt.event(uid_base + env.u, "receipt", float(recv),
                             clock="wall", tick=t)
        if envs:
            inst, times = instance_from_requests(
                self.ctl.scenario, cfg.horizon.seed, t, envs)
            self.ctl.step(t, inst, times)
            self.counters["gateway.admitted"] += len(envs)
        else:
            self.ctl.step_idle(t)
        self.counters["gateway.ticks"] += 1
        if cfg.mode == "wall":
            self._lag_hist.observe(lag_ms)
            if rt is not None and len(admission_ms) == len(envs):
                # admission histogram exemplars link buckets to uids
                # (bucket counts identical to the observe_many path).
                # Kept-status is unknowable at admission time, so only
                # hash-sampled uids — which always survive to the kept
                # ring — get an exemplar; tail-kept specials don't.
                for env, ms in zip(envs, admission_ms):
                    uid = uid_base + env.u
                    self._adm_hist.observe(
                        ms, exemplar=rt.exemplar(uid, t)
                        if rt._hash_keep(uid) else None)
            else:
                self._adm_hist.observe_many(admission_ms)
        entry = {
            "tick": t, "admitted": len(envs),
            "ingress_depth": self.queue.qsize(),
            "queue_depth": self.ctl.boundary[-1][0],
            "in_flight": self.ctl.boundary[-1][1],
            "loop_lag_ms": round(lag_ms, 3),
        }
        self.tick_log.append(entry)
        pub = obs.get_publisher()
        if pub is not None:
            pub.emit("gateway", {
                "scenario": cfg.horizon.scenario,
                "seed": cfg.horizon.seed,
                "policy": cfg.horizon.policy,
                "mode": cfg.mode, "speed": cfg.speed, **entry,
                "requests": int(self.counters["gateway.requests"]),
                "dropped_ingress":
                    int(self.counters["gateway.dropped_ingress"]),
                "late": int(self.counters["gateway.late"]),
            })
            if (t + 1) % cfg.metrics_every == 0:
                self._emit_metrics(pub)

    def _emit_metrics(self, pub) -> None:
        pub.emit("metrics", {
            "metrics": self.registry.snapshot(),
            "counters": {k: float(v) for k, v in self.counters.items()},
            "n_spans": 0,
        })

    async def _run_virtual(self) -> None:
        pend: Dict[int, List[RequestEnvelope]] = {}
        t = 0
        while t < self.ctl.n_ticks:
            obj = await self.queue.get()
            kind = obj.get("type")
            if kind == "req":
                pend.setdefault(int(obj["tick"]), []).append(
                    RequestEnvelope.from_wire(obj))
            elif kind == "eot":
                # the determinism hinge: the boundary is this frame
                k = int(obj["tick"])
                while t <= min(k, self.ctl.n_ticks - 1):
                    self._step_tick(t, pend.pop(t, []), 0.0, [])
                    t += 1
            elif kind == "eos":
                break

    async def _run_wall(self) -> None:
        cfg = self.config
        tick_wall = cfg.horizon.tick_duration / cfg.speed
        pend: Dict[int, List[RequestEnvelope]] = {}
        eos = False
        try:
            first = await asyncio.wait_for(self.queue.get(),
                                           cfg.start_timeout_s)
        except asyncio.TimeoutError:
            return  # no traffic ever arrived: an empty, clean run
        # the wall origin is first-byte time, so gateway and generator
        # agree on tick phase regardless of who started first
        self._t0 = self.clock.now()
        eos = self._ingest_wall(first, pend, 0)
        t = 0
        while t < self.ctl.n_ticks:
            deadline = self._t0 + (t + 1) * tick_wall
            while not eos:
                remain = deadline - self.clock.now()
                if remain <= 0:
                    break
                try:
                    obj = await asyncio.wait_for(self.queue.get(), remain)
                except asyncio.TimeoutError:
                    break
                eos = self._ingest_wall(obj, pend, t)
            now = self.clock.now()
            lag_ms = max(0.0, (now - deadline) * 1e3)
            envs = pend.pop(t, [])
            admission_ms = [(now - e._recv) * 1e3 for e in envs]  # type: ignore[attr-defined]
            self._step_tick(t, envs, lag_ms, admission_ms)
            t += 1
            if eos and not any(k >= t for k in pend):
                break

    def _ingest_wall(self, obj: Dict[str, Any],
                     pend: Dict[int, List[RequestEnvelope]],
                     current_tick: int) -> bool:
        """Route one frame into the pending-tick buffers; True on eos."""
        kind = obj.get("type")
        if kind == "eos":
            return True
        if kind == "req":
            k = int(obj["tick"])
            if k < current_tick:
                # its control tick already stepped; admitting it into a
                # later tick would corrupt that tick's user indexing
                self.counters["gateway.late"] += 1
                return False
            env = RequestEnvelope.from_wire(obj)
            env._recv = float(obj.get("_recv", self.clock.now()))  # type: ignore[attr-defined]
            pend.setdefault(k, []).append(env)
        return False  # eot is advisory in wall mode: deadlines rule

    async def run(self) -> HorizonResult:
        """Drive the control loop to completion and finalize."""
        cfg = self.config
        with obs.span("gateway.run", scenario=cfg.horizon.scenario,
                      policy=cfg.horizon.policy, mode=cfg.mode,
                      seed=cfg.horizon.seed):
            if cfg.mode == "virtual":
                await self._run_virtual()
            else:
                await self._run_wall()
            result = self.ctl.finalize()
        pub = obs.get_publisher()
        if pub is not None:
            self._emit_metrics(pub)
        return result

    async def serve(self, host: str = "127.0.0.1",
                    port: int = 0) -> HorizonResult:
        """Bind a TCP ingest socket, run to completion, tear down."""
        server = await asyncio.start_server(self._on_client, host, port)
        self.bound_port = server.sockets[0].getsockname()[1]
        try:
            return await self.run()
        finally:
            server.close()
            await server.wait_closed()
