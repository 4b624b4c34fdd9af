"""Plain PyTorch version of the flash-attention forward (B4).

Full softmax in float32 over ``[Sq, Skv]`` scores: GQA by ``h // G``,
causal and sliding-window masks from positions (both contiguous from 0),
tanh softcap. It follows the kernel's conventions: masked scores are
``NEG`` and the row maximum is floored at ``SAFE``, so a row with no
visible key gives a zero output and ``lse = SAFE + log(1e-30)`` instead of
NaN; every other row is the ordinary softmax.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG", "SAFE", "attention_ref"]

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
    iq = torch.arange(Sq, device=q.device)[:, None]
    ik = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ik <= iq
    if window:
        ok &= ik > iq - window
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
