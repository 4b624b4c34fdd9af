"""PIES problem instances (§III of the paper) and their torch mirror.

An instance bundles the three entity families of the system model:

* edge clouds  ``e ∈ E`` with capacities ``K_e`` (communication), ``W_e``
  (computation), ``R_e`` (storage);
* service models ``(s, m) ∈ SM`` — flattened to ``P`` rows — with accuracy
  ``A_sm`` and costs ``k_sm`` (communication), ``w_sm`` (computation),
  ``r_sm`` (storage);
* user requests ``u ∈ U`` with covering edge ``e_u``, requested service
  ``s_u``, accuracy threshold ``α_u`` and delay threshold ``δ_u``.

:class:`PIESInstance` and the generators are host NumPy code, kept
draw-for-draw identical to :mod:`repro.core.instance` so one seed gives
byte-identical arrays in both packages. :class:`TorchInstance` is the
device mirror the torch path and the CUDA kernels run on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "PIESInstance",
    "TorchInstance",
    "synthetic_instance",
    "realworld_instance",
    "REALWORLD_CATALOG",
    "tiny_instance",
    "draw_edge_capacities",
    "draw_service_catalog",
]


@dataclasses.dataclass
class PIESInstance:
    """A complete PIES problem instance (all arrays are host numpy)."""

    # --- edge clouds -----------------------------------------------------
    K: np.ndarray  # [E] communication capacity
    W: np.ndarray  # [E] computation capacity
    R: np.ndarray  # [E] storage capacity

    # --- service models (flattened (s, m) pairs) -------------------------
    sm_service: np.ndarray  # [P] int — service id of each model
    sm_acc: np.ndarray      # [P] A_sm ∈ [0, 1]
    sm_k: np.ndarray        # [P] communication cost
    sm_w: np.ndarray        # [P] computation cost
    sm_r: np.ndarray        # [P] storage cost

    # --- user requests ----------------------------------------------------
    u_edge: np.ndarray     # [U] int — covering edge cloud e_u
    u_service: np.ndarray  # [U] int — requested service s_u
    u_alpha: np.ndarray    # [U] accuracy threshold α_u ∈ [0, 1]
    u_delta: np.ndarray    # [U] delay threshold δ_u ∈ [0, δ_max]

    delta_max: float = 10.0

    # optional human-readable names (real-world catalog)
    model_names: Optional[Sequence[str]] = None

    # ---------------------------------------------------------------------
    @property
    def E(self) -> int:
        return int(self.K.shape[0])

    @property
    def P(self) -> int:
        return int(self.sm_service.shape[0])

    @property
    def U(self) -> int:
        return int(self.u_edge.shape[0])

    @property
    def S(self) -> int:
        return int(self.sm_service.max()) + 1 if self.P else 0

    def covered_counts(self) -> np.ndarray:
        """``|U_e|`` for every edge cloud ``e`` (Eq. 5/6 sharing factor)."""
        return np.bincount(self.u_edge, minlength=self.E).astype(np.float64)

    def users_of_edge(self, e: int) -> np.ndarray:
        return np.nonzero(self.u_edge == e)[0]

    def models_of_service(self, s: int) -> np.ndarray:
        return np.nonzero(self.sm_service == s)[0]

    def validate(self) -> None:
        assert self.u_edge.min(initial=0) >= 0 and (
            self.U == 0 or self.u_edge.max() < self.E
        )
        assert np.all(self.sm_acc >= 0.0) and np.all(self.sm_acc <= 1.0)
        assert np.all(self.u_alpha >= 0.0) and np.all(self.u_alpha <= 1.0)
        assert np.all(self.u_delta >= 0.0) and np.all(
            self.u_delta <= self.delta_max + 1e-9
        )
        assert np.all(self.sm_r > 0), "storage costs must be positive"
        # every service has ≥ 1 implementation (paper assumption m_s ≥ 1)
        if self.U:
            req = np.unique(self.u_service)
            have = np.unique(self.sm_service)
            assert np.all(np.isin(req, have)), "user requests unknown service"


@dataclasses.dataclass
class TorchInstance:
    """Device mirror of :class:`PIESInstance` with the per-user sharing
    factors ``|U_e|/K_e`` and ``|U_e|/W_e`` pre-gathered (Eq. 5/6).

    Float fields are float32 and ids int32, as in the JAX reference's
    ``JaxInstance``; ``delta_max`` stays a Python float.
    """

    u_alpha: torch.Tensor    # [U] f32
    u_delta: torch.Tensor    # [U] f32
    u_service: torch.Tensor  # [U] i32
    u_edge: torch.Tensor     # [U] i32
    u_share_k: torch.Tensor  # [U] f32 = |U_{e_u}| / K_{e_u}
    u_share_w: torch.Tensor  # [U] f32 = |U_{e_u}| / W_{e_u}
    sm_service: torch.Tensor  # [P] i32
    sm_acc: torch.Tensor     # [P] f32
    sm_k: torch.Tensor       # [P] f32
    sm_w: torch.Tensor       # [P] f32
    sm_r: torch.Tensor       # [P] f32
    R: torch.Tensor          # [E] f32
    delta_max: float

    @classmethod
    def from_pies(cls, inst: PIESInstance,
                  device: Union[str, torch.device]) -> "TorchInstance":
        """Mirror ``inst`` onto ``device``. The share factors are computed
        in float64 NumPy and cast once to float32, exactly as the
        reference's ``PIESInstance.as_jax`` does; a float64 array is never
        handed to torch as it is (that would keep it float64 and drift
        from the float32 reference)."""
        counts = inst.covered_counts()
        f32 = np.float32
        host = dict(
            u_alpha=inst.u_alpha.astype(f32),
            u_delta=inst.u_delta.astype(f32),
            u_service=inst.u_service.astype(np.int32),
            u_edge=inst.u_edge.astype(np.int32),
            u_share_k=(counts[inst.u_edge] / inst.K[inst.u_edge]).astype(f32),
            u_share_w=(counts[inst.u_edge] / inst.W[inst.u_edge]).astype(f32),
            sm_service=inst.sm_service.astype(np.int32),
            sm_acc=inst.sm_acc.astype(f32),
            sm_k=inst.sm_k.astype(f32),
            sm_w=inst.sm_w.astype(f32),
            sm_r=inst.sm_r.astype(f32),
            R=inst.R.astype(f32),
        )
        return cls(**{k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for k, a in host.items()},
                   delta_max=float(inst.delta_max))

    @property
    def device(self) -> torch.device:
        return self.u_alpha.device


# ===========================================================================
# Instance generators
# ===========================================================================

def draw_edge_capacities(rng: np.random.Generator, n_edges: int):
    """§VI-B edge-cloud draws (the single source of the paper's ranges):
    ``K_e, W_e ~ U{300..600}``, ``R_e ~ U{100..200}``. Returns (K, W, R)."""
    K = rng.integers(300, 601, size=n_edges).astype(np.float64)
    W = rng.integers(300, 601, size=n_edges).astype(np.float64)
    R = rng.integers(100, 201, size=n_edges).astype(np.float64)
    return K, W, R


def draw_service_catalog(rng: np.random.Generator, n_services: int,
                         max_impls: int):
    """§VI-B service-model draws: ``U{1..max_impls}`` implementations per
    service, ``k, w ~ U{15..30}``, ``r ~ U{10..20}``,
    ``A ~ clip(N(0.65, 0.1), 0, 1)``.

    Returns ``(sm_service, sm_acc, sm_k, sm_w, sm_r)``.
    """
    impls = rng.integers(1, max_impls + 1, size=n_services)
    sm_service = np.repeat(np.arange(n_services), impls)
    P = sm_service.shape[0]
    sm_k = rng.integers(15, 31, size=P).astype(np.float64)
    sm_w = rng.integers(15, 31, size=P).astype(np.float64)
    sm_r = rng.integers(10, 21, size=P).astype(np.float64)
    sm_acc = np.clip(rng.normal(0.65, 0.1, size=P), 0.0, 1.0)
    return sm_service, sm_acc, sm_k, sm_w, sm_r


def synthetic_instance(
    n_users: int,
    n_edges: int = 10,
    n_services: int = 100,
    max_impls: int = 10,
    delta_max: float = 10.0,
    seed: int = 0,
    alpha_scale: float = 0.125,
    delta_scale: float = 1.5,
) -> PIESInstance:
    """Numerical-simulation setup of §VI-B, parameter-for-parameter.

    ``K_e, W_e ~ U{300..600}``, ``R_e ~ U{100..200}``; per service model
    ``k, w ~ U{15..30}``, ``r ~ U{10..20}``, ``A ~ clip(N(0.65, 0.1), 0, 1)``;
    each service has ``U{1..max_impls}`` implementations; user services are
    uniform; ``α_u = 1 − ε`` with ``ε ~ clip(Exp(scale=0.125), 0, 1)``;
    ``δ_u ~ clip(Exp(scale=1.5), 0, δ_max)`` with ``δ_max = 10``.

    The paper writes the exponential parameters as rates ``λ``; we follow
    the conventional NumPy ``scale`` reading (``scale = 0.125`` ⇒ strict
    accuracy thresholds near 1), which reproduces the paper's reported
    approximation-ratio regime (see EXPERIMENTS.md §Paper-validation).
    """
    rng = np.random.default_rng(seed)
    K, W, R = draw_edge_capacities(rng, n_edges)
    sm_service, sm_acc, sm_k, sm_w, sm_r = draw_service_catalog(
        rng, n_services, max_impls)

    u_edge = rng.integers(0, n_edges, size=n_users)
    u_service = rng.integers(0, n_services, size=n_users)
    u_alpha = 1.0 - np.clip(rng.exponential(alpha_scale, size=n_users), 0.0, 1.0)
    u_delta = np.clip(rng.exponential(delta_scale, size=n_users), 0.0, delta_max)

    inst = PIESInstance(
        K=K, W=W, R=R,
        sm_service=sm_service, sm_acc=sm_acc, sm_k=sm_k, sm_w=sm_w, sm_r=sm_r,
        u_edge=u_edge, u_service=u_service, u_alpha=u_alpha, u_delta=u_delta,
        delta_max=delta_max,
    )
    inst.validate()
    return inst


#: Table I of the paper: (name, accuracy A_sm, avg. computation delay sec).
REALWORLD_CATALOG = [
    ("AlexNet", 0.5652, 0.04),
    ("DenseNet", 0.7714, 0.47),
    ("GoogLeNet", 0.6978, 0.13),
    ("MobileNet", 0.7188, 0.06),
    ("ResNet", 0.6976, 0.08),
    ("SqueezeNet", 0.5809, 0.07),
]


def realworld_instance(
    n_users: int = 300,
    seed: int = 0,
    tran_delay: float = 0.05,
    comp_contention: float = 2.0,
    delta_max: float = 1.0,
) -> PIESInstance:
    """Real-world setup of §VI-C: one edge cloud (the iMac), one image-
    classification service with the six Table-I implementations, 300
    requests (3 IoT devices × 100 images).

    ``R_e = 1`` and ``r_sm = 1`` (single placement slot), ``k_sm = 1``.
    ``α_u = 1 − ε``, ``ε ~ clip(Exp(scale=0.0625), 0, 1)``;
    ``δ_u ~ clip(N(0.5, 0.125), 0, 1)``, ``δ_max = 1`` second.

    ``K_e``/``W_e`` are "robustly tuned to match the real-world computation
    and communication delay" (paper §VI-C): we pick ``W_e = |U_e| /
    comp_contention`` so a model's effective computation delay is its
    measured Table-I delay times the contention factor, and ``K_e = |U_e| ·
    k_sm / tran_delay`` so transmission costs ``tran_delay`` seconds.
    """
    rng = np.random.default_rng(seed)
    names = [n for n, _, _ in REALWORLD_CATALOG]
    acc = np.array([a for _, a, _ in REALWORLD_CATALOG])
    comp = np.array([c for _, _, c in REALWORLD_CATALOG])

    P = len(names)
    K = np.array([n_users * 1.0 / tran_delay])
    W = np.array([n_users / comp_contention])
    R = np.array([1.0])

    inst = PIESInstance(
        K=K, W=W, R=R,
        sm_service=np.zeros(P, dtype=np.int64),
        sm_acc=acc,
        sm_k=np.ones(P),
        sm_w=comp,  # D_comp = w · |U_e| / W_e = comp · contention
        sm_r=np.ones(P),
        u_edge=np.zeros(n_users, dtype=np.int64),
        u_service=np.zeros(n_users, dtype=np.int64),
        u_alpha=1.0 - np.clip(rng.exponential(0.0625, size=n_users), 0.0, 1.0),
        u_delta=np.clip(rng.normal(0.5, 0.125, size=n_users), 0.0, delta_max),
        delta_max=delta_max,
        model_names=names,
    )
    inst.validate()
    return inst


def tiny_instance(seed: int = 0, n_users: int = 12, n_edges: int = 2,
                  n_services: int = 4, max_impls: int = 3) -> PIESInstance:
    """A brute-forceable instance for exactness tests."""
    return synthetic_instance(
        n_users=n_users, n_edges=n_edges, n_services=n_services,
        max_impls=max_impls, seed=seed,
    )
