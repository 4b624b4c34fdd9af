"""Plain PyTorch versions of the flash-attention forward (B4) and backward
(B5 dQ, B6 dK/dV).

Full softmax in float32 over ``[Sq, Skv]`` scores: GQA by ``h // G``,
causal and sliding-window masks from positions (both contiguous from 0),
tanh softcap. It follows the kernel's conventions: masked scores are
``NEG`` and the row maximum is floored at ``SAFE``, so a row with no
visible key gives a zero output and ``lse = SAFE + log(1e-30)`` instead of
NaN; every other row is the ordinary softmax. The backward recomputes
the probabilities from that lse (after the softcap, as the forward
applies it) and masks them from positions, so such a row contributes
nothing to any gradient.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG", "SAFE", "attention_ref", "flash_attention_bwd_ref"]

NEG = -1e30
SAFE = -1e20


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  return_lse: bool = False):
    """q: ``[B, Sq, Hq, hd]``; k, v: ``[B, Skv, Hkv, hd]`` with
    ``Hq % Hkv == 0``. Returns ``[B, Sq, Hq, hd]`` in q's dtype and, with
    ``return_lse``, the float32 logsumexp ``[B, Hq, Sq]``."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = _visible(Sq, Skv, causal, window, q.device)
    s = torch.where(ok, s, torch.full((), NEG, device=q.device))
    m = s.amax(-1, keepdim=True).clamp_min(SAFE)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskh->bkgqh", p / l, v.float())
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(l))[..., 0].reshape(B, Hq, Sq)
    return o, lse


def _visible(Sq: int, Skv: int, causal: bool, window: int, device
             ) -> torch.Tensor:
    """``[Sq, Skv]`` bool: which keys each query sees (positions from 0)."""
    iq = torch.arange(Sq, device=device)[:, None]
    ik = torch.arange(Skv, device=device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok &= ik <= iq
    if window:
        ok &= ik > iq - window
    return ok


def _softcap(s: torch.Tensor, softcap: float):
    """The capped scores ``c·t``, ``t = tanh(s / c)``, and the factor
    ``1 − t²`` that the cap's derivative puts on dS."""
    t = torch.tanh(s / softcap)
    return softcap * t, 1 - t * t


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """The reference's backward formulas (``backward.py``) in float32 over
    ``[Sq, Skv]`` scores: ``P = exp(scale·q kᵀ − lse)`` where the mask lets
    a key be seen (0 elsewhere), ``D = rowsum(dO∘O)``, ``dV = Pᵀ dO``,
    ``dS = P∘(dO vᵀ − D)``, ``dQ = scale·dS k``, ``dK = scale·dSᵀ q``, the
    G query heads of a group summed into their KV head.

    With a ``softcap`` c the scores are ``c·t``, ``t = tanh(scale·q kᵀ /
    c)``: ``P = exp(c·t − lse)``, and the cap's derivative multiplies dS by
    ``1 − t²`` before dQ and dK (the derivative of ``attention_ref``'s
    capped forward, which the reference's ``flash_attention_jnp`` shares).

    q, o, do: ``[B, Sq, Hq, hd]``; k, v: ``[B, Skv, Hkv, hd]``; lse
    ``[B, Hq, Sq]`` float32 (the forward's). Returns ``(dq, dk, dv)`` in
    q's and k's dtypes."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    def heads(t):   # [B, S, Hkv·G, hd] -> [B, Hkv, G, S, hd] float32
        return t.reshape(B, t.shape[1], Hkv, G, hd).permute(0, 2, 3, 1, 4) \
            .float()

    qf, of, dof = heads(q), heads(o), heads(do)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # [B,Hkv,S,hd]
    lse = lse.reshape(B, Hkv, G, Sq, 1)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, kf) * scale
    if softcap:
        s, dcap = _softcap(s, softcap)
    ok = _visible(Sq, Skv, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse), torch.zeros((), device=q.device))
    dsum = (of * dof).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dof)
    ds = p * (torch.einsum("bkgqh,bksh->bkgqs", dof, vf) - dsum)
    if softcap:
        ds = ds * dcap
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qf) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)
    return (dq, dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
