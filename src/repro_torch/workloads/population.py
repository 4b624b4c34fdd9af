"""Population dynamics: popularity, churn, and mobility.

All draws are pure functions of ``(seed, tick, user-slot)`` built on a
vectorized splitmix64 counter hash, so any worker can materialize the
population at any tick without shared state or stream replay:

* :func:`hash_uniform` — the counter-based U(0,1) primitive;
* :class:`ZipfPopularity` — Zipf service popularity with hot-spot drift
  (the rank-1 "hot" service rotates every ``drift_period`` ticks);
* :class:`ChurnModel` — per-slot user churn: slot ``u`` is re-rolled every
  ``lifetime`` ticks at a slot-specific phase, so each tick a ~``1/lifetime``
  fraction of users leave and are replaced — attributes are a function of
  the slot's *generation* ``(tick + phase_u) // lifetime``, which makes the
  process O(1)-seekable (no history walk);
* :class:`MarkovMobility` — users random-walk across edge clouds (a ring
  topology: geographic adjacency) with per-tick move probability
  ``p_move``. The chain is genuinely Markov, so seeking to tick ``t``
  replays ``t`` vectorized transition steps — O(t·U) but deterministic:
  the step-``k`` coin flips are hashed from ``(seed, k, u)``, never from a
  stateful stream. Migration permutes coverage only; it conserves the
  user population (no slot is created or destroyed by a move).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "hash_uniform",
    "ZipfPopularity",
    "ChurnModel",
    "MarkovMobility",
]

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)

# Stream tags (distinct from repro_torch.workloads.arrivals tags).
TAG_SERVICE = 0x0B1
TAG_ALPHA = 0x0B2
TAG_DELTA = 0x0B3
TAG_PHASE = 0x0B4
TAG_HOME = 0x0B5
TAG_MOVE = 0x0B6
TAG_DEST = 0x0B7


def _mix(z: np.ndarray) -> np.ndarray:
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def hash_u64(seed: int, *components) -> np.ndarray:
    """splitmix64-style counter hash; components broadcast like arrays."""
    z = np.asarray(np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF))
    with np.errstate(over="ignore"):  # uint64 wraparound is the algorithm
        for c in components:
            c = np.asarray(c, dtype=np.uint64)
            z = _mix((z + _GAMMA) ^ (c * _MIX1 + _GAMMA))
    return z


def hash_uniform(seed: int, *components) -> np.ndarray:
    """Deterministic U(0,1) draws indexed by integer components."""
    return (hash_u64(seed, *components) >> np.uint64(11)).astype(
        np.float64) * (2.0 ** -53)


@dataclasses.dataclass(frozen=True)
class ZipfPopularity:
    """Zipf(``exponent``) service popularity with rotating hot spot.

    The popularity of service ``s`` at tick ``t`` is the Zipf weight of its
    *rotated rank* ``(s - hot(t)) mod S`` where ``hot(t) = (t //
    drift_period) · drift_step mod S`` — the head of the distribution
    drifts across the catalog, which is what makes per-tick re-placement
    churn (and hysteresis matter). ``drift_period = 0`` disables drift.
    """

    n_services: int
    exponent: float = 1.1
    drift_period: int = 0
    drift_step: int = 1

    def weights_at(self, tick: int) -> np.ndarray:
        ranks = np.arange(self.n_services, dtype=np.float64)
        if self.drift_period > 0:
            hot = (int(tick) // self.drift_period) * self.drift_step
            ranks = (ranks - hot) % self.n_services
        w = 1.0 / np.power(ranks + 1.0, self.exponent)
        return w / w.sum()

    def sample(self, uniforms: np.ndarray, tick: int) -> np.ndarray:
        """Inverse-CDF map of U(0,1) draws onto service ids at ``tick``."""
        cdf = np.cumsum(self.weights_at(tick))
        cdf[-1] = 1.0  # guard the top bin against cumsum round-off
        return np.searchsorted(cdf, uniforms, side="right").astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ChurnModel:
    """Generation-indexed churn over a fixed pool of user slots.

    Slot ``u``'s generation at tick ``t`` is ``(t + phase_u) // lifetime``
    with ``phase_u = hash(seed, u) mod lifetime``; attributes (requested
    service, α, δ) are drawn from the generation index, so they persist for
    ``lifetime`` ticks and then re-roll — a fraction ``≈ 1/lifetime`` of
    the population churns every tick, de-phased across slots.

    α/δ follow the paper's §VI-B threshold distributions
    (``α = 1 − clip(Exp(alpha_scale))``, ``δ = clip(Exp(delta_scale), 0,
    δ_max)``) via inverse-CDF of the hash uniforms.
    """

    lifetime: int = 16
    alpha_scale: float = 0.125
    delta_scale: float = 1.5
    delta_max: float = 10.0

    def generation_at(self, seed: int, tick: int, n_slots: int) -> np.ndarray:
        slots = np.arange(n_slots)
        phase = hash_u64(seed, TAG_PHASE, slots) % np.uint64(self.lifetime)
        return (int(tick) + phase.astype(np.int64)) // self.lifetime

    def attributes_at(self, seed: int, tick: int, n_slots: int,
                      popularity: ZipfPopularity):
        """Returns ``(u_service, u_alpha, u_delta)`` for every slot."""
        slots = np.arange(n_slots)
        gen = self.generation_at(seed, tick, n_slots)
        u_svc = hash_uniform(seed, TAG_SERVICE, slots, gen)
        u_a = hash_uniform(seed, TAG_ALPHA, slots, gen)
        u_d = hash_uniform(seed, TAG_DELTA, slots, gen)
        service = popularity.sample(u_svc, tick)
        # inverse-CDF exponentials; 1-u ∈ (0, 1] so log is finite
        alpha = 1.0 - np.clip(-self.alpha_scale * np.log1p(-u_a), 0.0, 1.0)
        delta = np.clip(-self.delta_scale * np.log1p(-u_d), 0.0,
                        self.delta_max)
        return service, alpha, delta


@dataclasses.dataclass(frozen=True)
class MarkovMobility:
    """Ring random walk across edge clouds.

    Each tick, user ``u`` moves to an adjacent edge (``±1`` on the ring —
    neighboring coverage areas) with probability ``p_move``. Home edges at
    tick 0 are hash-uniform. ``p_move = 0`` degenerates to static coverage.
    """

    n_edges: int
    p_move: float = 0.0

    def home_edges(self, seed: int, n_slots: int) -> np.ndarray:
        slots = np.arange(n_slots)
        u = hash_uniform(seed, TAG_HOME, slots)
        return np.minimum((u * self.n_edges).astype(np.int64),
                          self.n_edges - 1)

    def edges_at(self, seed: int, tick: int, n_slots: int) -> np.ndarray:
        """User → edge assignment at ``tick`` (replays the walk)."""
        return self.trajectory(seed, tick + 1, n_slots)[-1]

    def trajectory(self, seed: int, n_ticks: int, n_slots: int) -> np.ndarray:
        """[n_ticks, n_slots] edge assignment; row 0 is the home state."""
        slots = np.arange(n_slots)
        out = np.empty((n_ticks, n_slots), dtype=np.int64)
        e = self.home_edges(seed, n_slots)
        out[0] = e
        for k in range(1, n_ticks):
            move = hash_uniform(seed, TAG_MOVE, k, slots) < self.p_move
            step = np.where(hash_uniform(seed, TAG_DEST, k, slots) < 0.5,
                            -1, 1)
            e = np.where(move, (e + step) % self.n_edges, e)
            out[k] = e
        return out
