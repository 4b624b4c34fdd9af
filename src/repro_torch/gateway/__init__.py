"""repro_torch.gateway — the live serving control plane (the port of
:mod:`repro.gateway`: the same wire protocol, frames and digests).

Promotes :mod:`repro_torch.serving.horizon` from an offline driver to a real
async service: an asyncio gateway (:mod:`~repro_torch.gateway.server`) ingests
request envelopes over a one-line-per-frame JSON protocol
(:mod:`~repro_torch.gateway.control`), batches them into control ticks, and
runs the placement → routing → execution loop — the *same*
:class:`~repro_torch.serving.horizon.TickController` the offline horizon
uses — paced by a wall or virtual clock. An open-loop load generator
(:mod:`~repro_torch.gateway.loadgen`) replays the seeded scenario traces at
configurable RPS multipliers, and the soak harness
(:mod:`~repro_torch.gateway.soak`) judges sustained high-RPS runs for bounded
backlog and honest event-loop latency.

Determinism invariant (tested): on the virtual clock, a seeded replay
produces ``TickReport``\\ s byte-identical to ``run_horizon`` on the
same ``(config, seed)`` — and to the reference's gateway and horizon.
Telemetry rides the :mod:`repro_torch.obs.stream` protocol, so
``python -m repro_torch.obs dash`` works against a live gateway unchanged.

CLI: ``python -m repro_torch.gateway serve|loadgen|replay|soak``.
"""
from .control import (GATEWAY_PROTOCOL_VERSION, RequestEnvelope,
                      eos_frame, eot_frame, instance_from_requests,
                      parse_frame, result_digest)
from .loadgen import LoadgenReport, run_loadgen, tcp_loadgen, tick_envelopes
from .server import Gateway, GatewayConfig, VirtualClock, WallClock
from .soak import SoakReport, run_soak

__all__ = [
    "GATEWAY_PROTOCOL_VERSION",
    "RequestEnvelope",
    "eot_frame",
    "eos_frame",
    "parse_frame",
    "instance_from_requests",
    "result_digest",
    "LoadgenReport",
    "tick_envelopes",
    "run_loadgen",
    "tcp_loadgen",
    "Gateway",
    "GatewayConfig",
    "WallClock",
    "VirtualClock",
    "SoakReport",
    "run_soak",
]
