"""Plain PyTorch versions of the three QoS kernels.

They run wherever the tensors are (the CPU tests use them; on the card
they are what each CUDA kernel is held against) and repeat the kernels'
float32 arithmetic operation for operation, so the two agree bit for bit:

* the delay ``k·share_k + w·share_w`` is two rounded products and a
  rounded sum (the kernels use ``__fmul_rn``/``__fadd_rn``, never a fused
  multiply-add);
* ``over / delta_max`` divides by a float32 tensor on the same device.
  Dividing a CUDA tensor by a Python float makes PyTorch multiply by the
  reciprocal instead, which can differ in the last bit.
"""
from __future__ import annotations

import torch

__all__ = ["qos_matrix_ref", "qos_candidates_ref", "greedy_argmax_ref",
           "NEG"]

#: Mask sentinel of the greedy argmax: benefits can be negative, so a
#: masked slot is −1e30, not 0.
NEG = -1e30


def _qos(alpha, delta, share_k, share_w, acc, kcost, wcost,
         delta_max: float):
    """0.5·(â + d̂) of Eqs. (2)–(6), broadcast over the operands, float32."""
    adiff = alpha - acc                                   # Eq. (2)
    a_hat = torch.where(adiff <= 0.0, 1.0, torch.clamp_min(1.0 - adiff, 0.0))
    d = kcost * share_k + wcost * share_w                 # Eqs. (4)–(6)
    over = d - delta
    dmax = torch.tensor(delta_max, dtype=torch.float32, device=over.device)
    d_hat = torch.where(over <= 0.0, 1.0,                 # Eq. (3)
                        torch.clamp_min(1.0 - over / dmax, 0.0))
    return 0.5 * (a_hat + d_hat)


def qos_matrix_ref(u_alpha, u_delta, u_share_k, u_share_w, u_service,
                   sm_acc, sm_k, sm_w, sm_service, *, delta_max: float):
    """Dense Q [U, P] float32 (Eq. 1): per-user columns against per-model
    rows, times ``[service ids equal]``."""
    f32 = torch.float32
    col = lambda t: t.to(f32)[:, None]  # noqa: E731
    row = lambda t: t.to(f32)[None, :]  # noqa: E731
    q = _qos(col(u_alpha), col(u_delta), col(u_share_k), col(u_share_w),
             row(sm_acc), row(sm_k), row(sm_w), delta_max)
    elig = (u_service[:, None] == sm_service[None, :]).to(f32)
    return q * elig


def qos_candidates_ref(u_alpha, u_delta, u_share_k, u_share_w,
                       cand_acc, cand_k, cand_w, cand_valid, *,
                       delta_max: float):
    """Segmented QoS over pre-gathered ``(user, candidate)`` pairs [U, K],
    times the float ``valid`` mask (no id compare)."""
    f32 = torch.float32
    col = lambda t: t.to(f32)[:, None]  # noqa: E731
    q = _qos(col(u_alpha), col(u_delta), col(u_share_k), col(u_share_w),
             cand_acc.to(f32), cand_k.to(f32), cand_w.to(f32), delta_max)
    return q * cand_valid.to(f32)


def greedy_argmax_ref(v, mask):
    """Masked row argmax: ``(best [E] f32, idx [E] i32)``. Masked slots
    count as −1e30, the first maximum wins, and a row whose mask is empty
    gives ``(−1e30, −1)``."""
    m = mask > 0
    masked = torch.where(m, v.to(torch.float32), NEG)
    idx = torch.argmax(masked, dim=1)              # first maximum
    best = torch.gather(masked, 1, idx[:, None])[:, 0]
    has = m.any(dim=1)
    return (torch.where(has, best, NEG),
            torch.where(has, idx.to(torch.int32), -1))
