"""Dispatchers over the QoS kernels: the CUDA kernel for CUDA tensors, the
plain PyTorch version (:mod:`.ref`) for tensors on the CPU.

``use_kernel=None`` (the default) follows the tensors' device;
``use_kernel=False`` runs the plain version wherever the tensors are;
``use_kernel=True`` insists on the kernel and raises for CPU tensors. A
kernel wrapper (``*_cuda``) checks device, dtype, shape and contiguity,
allocates its outputs with ``torch.empty``, launches on the current stream,
raises if the launch reports an error, and adds one to its entry of
:data:`LAUNCHES` (and, while obs tracing is on, to the obs counter
``kernel.<name>.launches``, which carries a worker process's launches into
its artifact). It never falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import check_cuda_tensor as _check
from repro_torch.kernels._build import launch as _launch
from repro_torch.obs import count as obs_count
from repro_torch.obs import kernel_span
from repro_torch.obs.torchprof import named_scope

from .ref import (greedy_argmax_ref, qos_candidates_ref, qos_matrix_ref,
                  topk_candidates_ref)

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "check_service_ids",
    "TOPK_MAX_IMPLS",
    "qos_matrix", "qos_candidates", "topk_candidates", "greedy_argmax",
    "qos_matrix_cuda", "qos_candidates_cuda", "topk_candidates_cuda",
    "greedy_argmax_cuda",
    "qos_matrix_from_instance", "qos_candidates_from_instance",
]

#: Kernel launches since the last :func:`reset_launch_counts`. Both B2
#: kernels, the pre-gathered one and the fused candidate build, count under
#: ``qos_candidates``.
LAUNCHES = {"qos_matrix": 0, "qos_candidates": 0, "greedy_argmax": 0}

#: The widest impl table (M, implementations a service) the fused
#: candidate build's register selection holds (``kTopkMax`` in
#: ``csrc/qos_kernels.cu``).
TOPK_MAX_IMPLS = 16

_I32 = np.iinfo(np.int32)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launched(name: str) -> None:
    LAUNCHES[name] += 1
    obs_count(f"kernel.{name}.launches")


def check_service_ids(*arrays) -> None:
    """Guard the kernels' int32 id downcast.

    The kernels compare service ids in int32; integer ids outside that
    range would wrap on the cast and corrupt the eligibility mask, so they
    raise :class:`OverflowError`. Takes NumPy arrays or tensors; int32
    tensors cannot overflow and are not read (no device sync).
    """
    for x in arrays:
        if isinstance(x, torch.Tensor):
            if x.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8,
                           torch.bool) or x.is_floating_point() \
                    or x.numel() == 0:
                continue
            lo, hi = int(x.min()), int(x.max())
        else:
            arr = np.asarray(x)
            if not np.issubdtype(arr.dtype, np.integer) or arr.size == 0:
                continue
            lo, hi = int(arr.min()), int(arr.max())
        if hi > _I32.max or lo < _I32.min:
            raise OverflowError(
                f"service ids [{lo}, {hi}] overflow int32; the QoS kernels "
                "compare ids in int32 — re-index the service catalog below "
                "2**31 entries")


def _use_kernel(use_kernel: Optional[bool], t: torch.Tensor) -> bool:
    return t.is_cuda if use_kernel is None else bool(use_kernel)


# ===========================================================================
# kernel wrappers
# ===========================================================================

def qos_matrix_cuda(u_alpha, u_delta, u_share_k, u_share_w, u_service,
                    sm_acc, sm_k, sm_w, sm_service, *,
                    delta_max: float) -> torch.Tensor:
    """B1 kernel: dense Q [U, P] float32. Per-user inputs are [U] (f32,
    service i32), per-model inputs [P] (f32, service i32), all contiguous
    on one CUDA device."""
    dev = u_alpha.device
    U, P = u_alpha.shape[0], sm_acc.shape[0]
    f32, i32 = torch.float32, torch.int32
    ptrs = [_check(n, t, dt, (U,), dev) for n, t, dt in (
        ("u_alpha", u_alpha, f32), ("u_delta", u_delta, f32),
        ("u_share_k", u_share_k, f32), ("u_share_w", u_share_w, f32),
        ("u_service", u_service, i32))]
    ptrs += [_check(n, t, dt, (P,), dev) for n, t, dt in (
        ("sm_acc", sm_acc, f32), ("sm_k", sm_k, f32), ("sm_w", sm_w, f32),
        ("sm_service", sm_service, i32))]
    out = torch.empty((U, P), dtype=f32, device=dev)
    if out.numel():
        _launch("qos_matrix_launch", *ptrs, out.data_ptr(), U, P,
                float(delta_max), device=dev)
        _launched("qos_matrix")
    return out


def qos_candidates_cuda(u_alpha, u_delta, u_share_k, u_share_w,
                        cand_acc, cand_k, cand_w, cand_valid, *,
                        delta_max: float) -> torch.Tensor:
    """B2 kernel: segmented QoS [U, K] float32 over pre-gathered candidate
    attributes (all f32, contiguous, one CUDA device)."""
    dev = u_alpha.device
    U, K = cand_acc.shape
    f32 = torch.float32
    ptrs = [_check(n, t, f32, (U,), dev) for n, t in (
        ("u_alpha", u_alpha), ("u_delta", u_delta),
        ("u_share_k", u_share_k), ("u_share_w", u_share_w))]
    ptrs += [_check(n, t, f32, (U, K), dev) for n, t in (
        ("cand_acc", cand_acc), ("cand_k", cand_k), ("cand_w", cand_w),
        ("cand_valid", cand_valid))]
    out = torch.empty((U, K), dtype=f32, device=dev)
    if out.numel():
        _launch("qos_candidates_launch", *ptrs, out.data_ptr(), U, K,
                float(delta_max), device=dev)
        _launched("qos_candidates")
    return out


def topk_candidates_cuda(u_service, u_alpha, u_delta, u_share_k, u_share_w,
                         table, sm_acc, sm_k, sm_w, k: Optional[int] = None,
                         *, delta_max: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 on the main path: the whole top-k candidate build in one launch,
    ``(cand_idx [U, k] int32, cand_q [U, k] float32)``. ``u_service`` [U]
    and ``table`` [S, M] int32, the user attributes [U] and the model
    attributes [P] float32, all contiguous on one CUDA device. An impl
    table wider than :data:`TOPK_MAX_IMPLS` raises."""
    S, M = table.shape
    if M > TOPK_MAX_IMPLS:
        raise ValueError(
            f"impl table has M = {M} implementations a service; the fused "
            f"candidate kernel holds at most {TOPK_MAX_IMPLS}")
    k_eff = M if k is None else min(int(k), M)
    dev = u_alpha.device
    U, P = u_service.shape[0], sm_acc.shape[0]
    f32, i32 = torch.float32, torch.int32
    ptrs = [_check("u_service", u_service, i32, (U,), dev)]
    ptrs += [_check(n, t, f32, (U,), dev) for n, t in (
        ("u_alpha", u_alpha), ("u_delta", u_delta),
        ("u_share_k", u_share_k), ("u_share_w", u_share_w))]
    ptrs.append(_check("table", table, i32, (S, M), dev))
    ptrs += [_check(n, t, f32, (P,), dev) for n, t in (
        ("sm_acc", sm_acc), ("sm_k", sm_k), ("sm_w", sm_w))]
    cand_idx = torch.empty((U, k_eff), dtype=i32, device=dev)
    cand_q = torch.empty((U, k_eff), dtype=f32, device=dev)
    if cand_idx.numel():
        _launch("topk_candidates_launch", *ptrs, cand_idx.data_ptr(),
                cand_q.data_ptr(), U, S, M, P, k_eff, float(delta_max),
                device=dev)
        _launched("qos_candidates")
    return cand_idx, cand_q


def greedy_argmax_cuda(v: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3 kernel: masked row argmax of ``v [E, P]`` f32 under a bool
    ``mask [E, P]`` → ``(best [E] f32, idx [E] i32)``."""
    dev = v.device
    E, P = v.shape
    ptrs = [_check("v", v, torch.float32, (E, P), dev),
            _check("mask", mask, torch.bool, (E, P), dev)]
    best = torch.empty(E, dtype=torch.float32, device=dev)
    idx = torch.empty(E, dtype=torch.int32, device=dev)
    if E:
        _launch("greedy_argmax_launch", *ptrs, best.data_ptr(),
                idx.data_ptr(), E, P, device=dev)
        _launched("greedy_argmax")
    return best, idx


# ===========================================================================
# dispatchers
# ===========================================================================

def qos_matrix(u_alpha, u_delta, u_share_k, u_share_w, u_service,
               sm_acc, sm_k, sm_w, sm_service, *, delta_max: float,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Dense QoS matrix Q [U, P] float32 (Eq. 1)."""
    check_service_ids(u_service, sm_service)
    if not _use_kernel(use_kernel, u_alpha):
        with named_scope("qos_matrix_ref"):
            return qos_matrix_ref(u_alpha, u_delta, u_share_k, u_share_w,
                                  u_service, sm_acc, sm_k, sm_w, sm_service,
                                  delta_max=delta_max)
    f = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    i = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    with named_scope("qos_matrix_cuda"):
        return qos_matrix_cuda(f(u_alpha), f(u_delta), f(u_share_k),
                               f(u_share_w), i(u_service), f(sm_acc),
                               f(sm_k), f(sm_w), i(sm_service),
                               delta_max=delta_max)


def qos_candidates(u_alpha, u_delta, u_share_k, u_share_w,
                   cand_acc, cand_k, cand_w, cand_valid, *,
                   delta_max: float,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Segmented QoS over pre-gathered ``(user, candidate)`` pairs [U, K]."""
    if not _use_kernel(use_kernel, u_alpha):
        with named_scope("qos_candidates_ref"):
            return qos_candidates_ref(u_alpha, u_delta, u_share_k,
                                      u_share_w, cand_acc, cand_k, cand_w,
                                      cand_valid, delta_max=delta_max)
    f = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    with named_scope("qos_candidates_cuda"):
        return qos_candidates_cuda(f(u_alpha), f(u_delta), f(u_share_k),
                                   f(u_share_w), f(cand_acc), f(cand_k),
                                   f(cand_w), f(cand_valid),
                                   delta_max=delta_max)


def topk_candidates(u_service, u_alpha, u_delta, u_share_k, u_share_w,
                    table, sm_acc, sm_k, sm_w, k: Optional[int] = None, *,
                    delta_max: float, use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidate build ``(cand_idx [U, k] int32, cand_q [U, k]
    float32)`` from the users, the impl table [S, M] and the models."""
    check_service_ids(u_service)
    # B2's scope carries the reference's qos_candidates dispatcher's name
    if not _use_kernel(use_kernel, u_alpha):
        with named_scope("qos_candidates_ref"):
            return topk_candidates_ref(u_service, u_alpha, u_delta,
                                       u_share_k, u_share_w, table, sm_acc,
                                       sm_k, sm_w, k, delta_max=delta_max)
    f = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    i = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    with named_scope("qos_candidates_cuda"):
        return topk_candidates_cuda(i(u_service), f(u_alpha), f(u_delta),
                                    f(u_share_k), f(u_share_w), i(table),
                                    f(sm_acc), f(sm_k), f(sm_w), k,
                                    delta_max=delta_max)


def greedy_argmax(v, mask, *, use_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-edge argmax over the benefit map (Alg. 3 line 11)."""
    if not _use_kernel(use_kernel, v):
        with named_scope("greedy_argmax_ref"):
            return greedy_argmax_ref(v, mask)
    # a bool mask (the greedy loop's) goes through as it is: no elementwise
    # launch per call
    m = mask if mask.dtype == torch.bool else mask > 0
    with named_scope("greedy_argmax_cuda"):
        return greedy_argmax_cuda(v.to(torch.float32).contiguous(),
                                  m.contiguous())


def qos_matrix_from_instance(ti, use_kernel: Optional[bool] = None
                             ) -> torch.Tensor:
    """Dense Q [U, P] over a :class:`~repro_torch.core.TorchInstance`,
    inside a ``kernel.qos_matrix`` obs span with the reference's args
    (``use_kernel`` as the dispatcher resolves it)."""
    use_kernel = _use_kernel(use_kernel, ti.u_alpha)
    with kernel_span("qos_matrix", U=int(ti.u_alpha.shape[0]),
                     P=int(ti.sm_acc.shape[0]), use_kernel=use_kernel):
        return qos_matrix(ti.u_alpha, ti.u_delta, ti.u_share_k,
                          ti.u_share_w, ti.u_service, ti.sm_acc, ti.sm_k,
                          ti.sm_w, ti.sm_service, delta_max=ti.delta_max,
                          use_kernel=use_kernel)


def qos_candidates_from_instance(ti, table, k: Optional[int] = None, *,
                                 use_kernel: Optional[bool] = None):
    """Top-k candidate build (:func:`topk_candidates`, one kernel launch on
    a card) from a TorchInstance and an impl table, host-built or already
    on the instance's device; ``(cand_idx, cand_q)``. Inside a
    ``kernel.qos_candidates`` obs span with the reference's args."""
    from repro_torch.core.candidates import topk_candidates_torch

    use_kernel = _use_kernel(use_kernel, ti.u_alpha)
    with kernel_span("qos_candidates", U=int(ti.u_alpha.shape[0]),
                     k=-1 if k is None else int(k), use_kernel=use_kernel):
        return topk_candidates_torch(ti, table, k, use_kernel=use_kernel)
