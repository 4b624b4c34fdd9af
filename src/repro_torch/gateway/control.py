"""Gateway wire protocol and request → instance reconstruction.

The gateway's ingest speaks a one-line-per-frame JSON protocol
(:data:`GATEWAY_PROTOCOL_VERSION`), deliberately shaped like the
:mod:`repro_torch.obs.stream` wire format but in the *opposite* direction —
requests flow in, telemetry flows out::

    {"v": 1, "type": "req", "tick": 3, "u": 0, "edge": 2, "service": 7,
     "alpha": 0.42, "delta": 1.9, "arrival": 3.125}
    {"v": 1, "type": "eot", "tick": 3, "n": 41}
    {"v": 1, "type": "eos"}

``req`` carries everything the control plane needs to know about one
user request: its service, QoS attributes (α, δ), home edge, and the
absolute *virtual* arrival timestamp (simulation seconds — the wall
clock only paces delivery, it never enters the control state). ``eot``
(end-of-tick) is the determinism hinge: in virtual-clock mode the
gateway steps tick ``t`` exactly when ``eot(t)`` is ingested, so tick
boundaries are a property of the byte stream, not of asyncio task
scheduling. ``eos`` requests a graceful shutdown (drain + finalize).

:func:`instance_from_requests` is the inverse of
``Scenario.instance_at``: it rebuilds the tick's
:class:`~repro_torch.core.instance.PIESInstance` from the request envelopes
that physically arrived, against the same per-seed infrastructure and
catalog draws and the same dead-edge capacity zeroing. Because JSON
floats round-trip binary64 exactly (``repr`` is shortest-roundtrip) and
the envelopes are re-sorted into user order, a lossless replay of a
seeded trace reconstructs instances bit-identical to the offline
generator — which is what makes gateway-vs-horizon byte parity possible
at all.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.instance import PIESInstance
from repro_torch.serving.horizon import HorizonResult

__all__ = [
    "GATEWAY_PROTOCOL_VERSION",
    "RequestEnvelope",
    "eot_frame",
    "eos_frame",
    "parse_frame",
    "instance_from_requests",
    "result_digest",
]

#: Version stamp of the ingest wire protocol (every frame carries it).
GATEWAY_PROTOCOL_VERSION = 1


@dataclasses.dataclass
class RequestEnvelope:
    """One user request on the wire — the gateway's unit of ingest."""

    tick: int        # control tick the request belongs to
    u: int           # user index within the tick (canonical ordering)
    edge: int        # home edge (post-rehoming: where the user *is*)
    service: int     # requested service
    alpha: float     # QoS accuracy weight α_i
    delta: float     # deadline δ_i (seconds)
    arrival: float   # absolute virtual arrival time (simulation seconds)

    def to_wire(self) -> Dict[str, Any]:
        return {"v": GATEWAY_PROTOCOL_VERSION, "type": "req",
                "tick": self.tick, "u": self.u, "edge": self.edge,
                "service": self.service, "alpha": self.alpha,
                "delta": self.delta, "arrival": self.arrival}

    def to_line(self) -> str:
        return json.dumps(self.to_wire(), separators=(",", ":"),
                          sort_keys=True) + "\n"

    @classmethod
    def from_wire(cls, obj: Dict[str, Any]) -> "RequestEnvelope":
        return cls(tick=int(obj["tick"]), u=int(obj["u"]),
                   edge=int(obj["edge"]), service=int(obj["service"]),
                   alpha=float(obj["alpha"]), delta=float(obj["delta"]),
                   arrival=float(obj["arrival"]))


def eot_frame(tick: int, n: int) -> str:
    """End-of-tick sentinel: all ``n`` of tick ``tick``'s requests sent."""
    return json.dumps({"v": GATEWAY_PROTOCOL_VERSION, "type": "eot",
                       "tick": int(tick), "n": int(n)},
                      separators=(",", ":"), sort_keys=True) + "\n"


def eos_frame() -> str:
    """End-of-stream sentinel: drain and shut down gracefully."""
    return json.dumps({"v": GATEWAY_PROTOCOL_VERSION, "type": "eos"},
                      separators=(",", ":"), sort_keys=True) + "\n"


def parse_frame(line: str) -> Optional[Dict[str, Any]]:
    """Parse one wire line; ``None`` on a torn/foreign/blank line.

    A live ingest socket must degrade on garbage, not crash the control
    loop — the caller counts rejects on a ``gateway.malformed`` counter.
    """
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
    except json.JSONDecodeError:
        return None
    if not isinstance(obj, dict):
        return None
    if int(obj.get("v", -1)) != GATEWAY_PROTOCOL_VERSION:
        return None
    if obj.get("type") not in ("req", "eot", "eos"):
        return None
    return obj


def instance_from_requests(scenario, seed: int, tick: int,
                           envelopes: Sequence[RequestEnvelope]
                           ) -> Tuple[PIESInstance, np.ndarray]:
    """Rebuild tick ``tick``'s PIES instance from arrived envelopes.

    The inverse of ``Scenario.instance_at``: per-seed infrastructure and
    catalog come from the scenario's memoized draws (they are static
    across the horizon, so the gateway need not trust the wire for
    them); the user set — edges, services, α, δ — comes entirely from
    the envelopes, re-sorted into canonical user order; dead edges at
    ``tick`` have their deployment capacity zeroed exactly like the
    offline generator. Returns ``(instance, times)`` where ``times`` is
    the [U] float64 array of carried arrival timestamps, ready to pass
    to :meth:`~repro_torch.serving.horizon.TickController.step`.
    """
    if not envelopes:
        raise ValueError(f"tick {tick}: cannot build an instance from "
                         f"zero envelopes (use step_idle)")
    envs = sorted(envelopes, key=lambda e: e.u)
    if [e.u for e in envs] != list(range(len(envs))):
        raise ValueError(
            f"tick {tick}: envelope user indices are not the contiguous "
            f"range 0..{len(envs) - 1} — lost or duplicated requests "
            f"cannot be admitted as a coherent control tick")
    K, W, R = scenario.infrastructure(seed)
    sm_service, sm_acc, sm_k, sm_w, sm_r = scenario.catalog(seed)
    dead = scenario.dead_edges_at(tick)
    R = R.copy()
    if dead:
        R[np.asarray(dead)] = 0.0
    inst = PIESInstance(
        K=K, W=W, R=R,
        sm_service=sm_service, sm_acc=sm_acc,
        sm_k=sm_k, sm_w=sm_w, sm_r=sm_r,
        u_edge=np.array([e.edge for e in envs], np.int64),
        u_service=np.array([e.service for e in envs], np.int64),
        u_alpha=np.array([e.alpha for e in envs], np.float64),
        u_delta=np.array([e.delta for e in envs], np.float64),
        delta_max=scenario.delta_max,
    )
    inst.validate()
    times = np.array([e.arrival for e in envs], np.float64)
    return inst, times


def result_digest(result: HorizonResult) -> str:
    """SHA-256 over the byte-exact content of a horizon result.

    Covers every per-request (uid, impl, arrival, finish) tuple and
    every per-tick report field — the parity test's one-line equality
    check between the live gateway and the offline horizon.
    """
    h = hashlib.sha256()
    reqs = result.requests
    h.update(np.array([r.uid for r in reqs], np.int64).tobytes())
    h.update(np.array([r.impl for r in reqs], np.int64).tobytes())
    h.update(np.array([r.arrival for r in reqs], np.float64).tobytes())
    h.update(np.array([r.finish for r in reqs], np.float64).tobytes())
    for rep in result.per_tick:
        h.update(repr(dataclasses.astuple(rep)).encode())
    return h.hexdigest()
