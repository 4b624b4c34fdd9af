"""Plain PyTorch version of GQA decode attention (B7).

One query token per row against a ``[B, Sc, Hkv, hd]`` cache, full softmax
in float32. The validity mask is the model layer's: slot ``idx`` is valid
when ``idx < Sc`` and ``idx < kv_len`` (ring mode: or once ``kv_len > Sc``,
every slot), and, outside ring mode, ``idx > kv_len - 1 - window`` for a
sliding window. A row with no valid slot gives zeros.

The cache may be one block of a longer one (a rank's block of slots when
the cache's sequence is split over a mesh): ``slot0`` is the block's first
slot and ``sc_total`` the whole cache's length, over which the mask is
computed. With ``return_lse`` the float32 logsumexp of the valid scores
comes back too (``NEG`` where the block has no valid slot), and
:func:`combine_blocks` merges the blocks' outputs into the whole cache's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["combine_blocks", "decode_valid_mask", "gqa_decode_ref"]

NEG = -1e30
SAFE = -1e20


def decode_valid_mask(kv_len: torch.Tensor, Sc: int, *, window: int = 0,
                      ring: bool = False) -> torch.Tensor:
    """``[B, Sc]`` bool: which cache slots row b attends."""
    idx = torch.arange(Sc, device=kv_len.device)[None, :]
    n = kv_len.to(torch.int64)[:, None]
    if ring:
        return (idx < n) | (n > Sc)
    ok = idx < n
    if window:
        ok &= idx > n - 1 - window
    return ok


def gqa_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                   window: int = 0, ring: bool = False,
                   softcap: float = 0.0, slot0: int = 0,
                   sc_total: Optional[int] = None,
                   return_lse: bool = False):
    """q: ``[B, Hq, hd]``; k/v_cache: ``[B, Sc, Hkv, hd]``, slots ``slot0
    .. slot0 + Sc - 1`` of a ``sc_total``-slot cache (default: the whole
    cache); kv_len: ``[B]`` integer. Returns ``[B, Hq, hd]`` in q's dtype,
    and with ``return_lse`` also the float32 ``[B, Hq]`` logsumexp."""
    B, Hq, hd = q.shape
    Sc, Hkv = k_cache.shape[1], k_cache.shape[2]
    total = Sc if sc_total is None else int(sc_total)
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = decode_valid_mask(kv_len, total, window=window,
                           ring=ring)[:, slot0:slot0 + Sc]
    s = torch.where(ok[:, None, None, :], s,
                    torch.full((), NEG, device=q.device))
    m = s.amax(-1, keepdim=True).clamp_min(SAFE)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", p / l.clamp_min(1e-30),
                     v_cache.float())
    o = o.reshape(B, Hq, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0, m + torch.log(l), torch.full((), NEG,
                                                         device=q.device))
    return o, lse.reshape(B, Hq)


def combine_blocks(outs: torch.Tensor, lses: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole cache's output from its blocks' ``outs [n, B, Hq, hd]`` and
    ``lses [n, B, Hq]`` (block order): in float32, in block order, ``LSE =
    log Σ exp(lse_r)`` and ``o = Σ exp(lse_r − LSE) · o_r``, rounded once to
    ``dtype`` (default ``outs``'s). A block with no valid slot (lse
    ``NEG``) weighs nothing; where no block has one the output is 0."""
    lses = lses.float()
    top = lses.amax(0).clamp_min(SAFE)
    total = torch.zeros_like(top)
    for r in range(lses.shape[0]):
        total = total + torch.exp(lses[r] - top)
    big = top + torch.log(total.clamp_min(1e-30))
    o = torch.zeros(outs.shape[1:], dtype=torch.float32, device=outs.device)
    for r in range(lses.shape[0]):
        w = torch.where(lses[r] > 0.5 * NEG, torch.exp(lses[r] - big), 0.0)
        o = o + w[..., None] * outs[r].float()
    return o.to(outs.dtype if dtype is None else dtype)
