"""QoS-aware request router — OMS (Alg. 1) as the serving control plane.

The router owns the current placement ``x`` and, per control tick,
(1) computes the QoS matrix of the live request batch on the device (the
``qos_matrix`` CUDA kernel on a card), (2) schedules each request onto the
best placed implementation of its service with ``oms_torch``, and (3)
reports per-request expected QoS and drops. Placement (EGP) stays the host
oracle ``egp_np`` over that matrix, as in the reference router.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.instance import PIESInstance, TorchInstance
from repro_torch.core.placement import egp_np
from repro_torch.core.qos import eligibility_torch
from repro_torch.core.scheduling import oms_torch
from repro_torch.device import resolve_device

__all__ = ["Router", "RoutingDecision"]


@dataclasses.dataclass
class RoutingDecision:
    assignment: np.ndarray    # [U] model index (−1 ⇒ drop to central cloud)
    expected_qos: np.ndarray  # [U]
    value: float              # Eq. (7) objective
    placement: np.ndarray     # [E, P] current placement


class Router:
    """Stateful control plane: placement (slow path) + scheduling (fast).

    ``device=None`` means CUDA (raises without it); ``use_kernel`` is
    passed to the QoS dispatcher (``None``: the kernel exactly on CUDA).
    Placement is EGP (the reference's ``agp``/``opt`` are not ported yet).
    """

    def __init__(self, use_kernel: Optional[bool] = None,
                 device: Union[str, torch.device, None] = None):
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self._x: Optional[np.ndarray] = None

    # --- slow path -------------------------------------------------------
    def place(self, inst: PIESInstance) -> np.ndarray:
        _, Q = self._qos(inst)
        self._x = egp_np(inst, Q.cpu().numpy().astype(np.float64))
        return self._x

    # --- fast path ---------------------------------------------------------
    def route(self, inst: PIESInstance,
              placement: Optional[Union[np.ndarray, torch.Tensor]] = None
              ) -> RoutingDecision:
        x = placement if placement is not None else self._x
        if x is None:
            raise RuntimeError("call place() first")
        ti, Q = self._qos(inst)
        xt = torch.as_tensor(x, device=self.device).to(torch.bool)
        y, qos = oms_torch(Q, eligibility_torch(ti), ti.u_edge, xt)
        value = float(qos.sum(dtype=torch.float64))
        return RoutingDecision(
            assignment=y.cpu().numpy(),
            expected_qos=qos.cpu().numpy().astype(np.float64),
            value=value,
            placement=xt.cpu().numpy())

    def _qos(self, inst: PIESInstance) -> Tuple[TorchInstance, torch.Tensor]:
        from repro_torch.kernels.qos_matrix.ops import qos_matrix_from_instance

        ti = TorchInstance.from_pies(inst, self.device)
        return ti, qos_matrix_from_instance(ti, use_kernel=self.use_kernel)

    def handle_edge_failure(self, inst: PIESInstance,
                            failed_edges) -> Tuple[PIESInstance, np.ndarray]:
        """Elastic re-placement: users covered by failed edge clouds are
        re-homed to surviving edges (round-robin by load) and placement is
        recomputed on the survivors."""
        failed = set(int(e) for e in np.atleast_1d(failed_edges))
        survivors = [e for e in range(inst.E) if e not in failed]
        assert survivors, "no surviving edge clouds"
        counts = {e: int((inst.u_edge == e).sum()) for e in survivors}
        u_edge = inst.u_edge.copy()
        for u in np.nonzero(np.isin(inst.u_edge, list(failed)))[0]:
            tgt = min(counts, key=counts.get)
            u_edge[u] = tgt
            counts[tgt] += 1
        R = inst.R.copy()
        R[list(failed)] = 0.0  # nothing can be placed on a dead edge
        new = dataclasses.replace(inst, u_edge=u_edge, R=R)
        new.validate()
        x = self.place(new)
        assert not x[list(failed)].any()
        return new, x
