"""Instance evaluation: the sparse device path and the host oracle.

* :func:`evaluate_sparse` — the scale path: per-user top-k candidate pairs
  (segmented QoS kernel) feed the lock-step sparse EGP loop (greedy
  argmax kernel) and σ over the pairs; no ``[U, P]`` matrix is built.
  Exact vs :func:`evaluate_host` when ``k`` keeps every eligible
  implementation (the default).
* :func:`evaluate_host` — NumPy reference: ``egp_np`` + ``sigma_np``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.candidates import impl_table_np
from repro_torch.core.instance import PIESInstance, TorchInstance
from repro_torch.core.placement import (egp_np, egp_place_sparse_torch,
                                        sigma_sparse_torch)
from repro_torch.core.qos import qos_matrix_np
from repro_torch.core.scheduling import sigma_np
from repro_torch.device import resolve_device

__all__ = ["evaluate_sparse", "evaluate_host"]


def evaluate_sparse(instances: Sequence[PIESInstance],
                    k: Optional[int] = None, max_iters: Optional[int] = None,
                    use_kernel: Optional[bool] = None,
                    device: Union[str, torch.device, None] = None
                    ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """Top-k sparse EGP placement per instance: ``(values [B] float64,
    x list)``.

    ``k`` defaults to every eligible implementation (exact); a smaller
    ``k`` is the documented approximation. ``max_iters=None`` uses
    ``P + 1`` (an edge never picks more than P models). ``device=None``
    means CUDA and raises without it; ``use_kernel`` is passed to the
    kernel dispatchers (``None``: kernels exactly when on CUDA). Each
    ``x`` is an ``[E, P]`` bool tensor on ``device``.
    """
    from repro_torch.kernels.qos_matrix.ops import qos_candidates_from_instance

    dev = resolve_device(device)
    values, xs = [], []
    for inst in instances:
        ti = TorchInstance.from_pies(inst, dev)
        table = impl_table_np(inst.sm_service, inst.S)
        cand_idx, cand_q = qos_candidates_from_instance(
            ti, table, k, use_kernel=use_kernel)
        mi = int(max_iters) if max_iters is not None else inst.P + 1
        x, _ = egp_place_sparse_torch(cand_idx, cand_q, ti.u_edge,
                                      ti.sm_service, ti.sm_r, ti.R,
                                      max_iters=mi, use_kernel=use_kernel)
        values.append(float(sigma_sparse_torch(cand_idx, cand_q,
                                               ti.u_edge, x)))
        xs.append(x)
    return np.asarray(values, np.float64), xs


def evaluate_host(instances: Sequence[PIESInstance]) -> np.ndarray:
    """NumPy reference: per-instance EGP placement + σ, no batching."""
    out = []
    for inst in instances:
        Q = qos_matrix_np(inst)
        out.append(sigma_np(inst, egp_np(inst, Q), Q))
    return np.asarray(out)
