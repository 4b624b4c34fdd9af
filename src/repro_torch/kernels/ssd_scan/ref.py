"""Plain PyTorch versions of the Mamba2 SSD scan (B8).

* :func:`ssd_scan_ref` — the sequential recurrence ``h ← h·exp(ΔA) + B ⊗
  x; y = C·h``, one step per position: the oracle;
* :func:`ssd_chunked` — the chunked matrix form of the model layer
  (arXiv:2405.21060): intra-chunk ``(C Bᵀ ∘ L) X``, chunk-final states, a
  short recurrence over chunks and the inter-chunk output. The dispatcher
  runs it on the CPU and when asked for the plain version;
* :func:`ssd_chunked_bwd` — its gradient, written out as chunked tensor
  algebra (a reverse recurrence over chunks, then per chunk the products
  of the forward transposed): what the backward kernel
  (``csrc/ssd_scan_bwd.cu``) computes, and the CPU path's backward.

Both take ``x [B, L, H, P]`` (already scaled by Δ), ``dtA [B, L, H]`` (Δ·A,
negative) and ``b, c [B, L, N]`` (one group, shared by every head), and an
optional float32 ``initial_state [B, H, P, N]``; both return ``(y [B, L,
H, P], final_state [B, H, P, N])``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ssd_chunked", "ssd_chunked_bwd", "ssd_chunked_steps",
           "ssd_scan_ref"]


def ssd_scan_ref(x: torch.Tensor, dtA: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor,
                 initial_state: Optional[torch.Tensor] = None):
    """Sequential reference in float32; ``initial_state`` defaults to
    zeros."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    x, dtA, b, c = (t.float() for t in (x, dtA, b, c))
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device) if initial_state is None
             else initial_state.float())
    ys = []
    for t in range(L):
        state = state * torch.exp(dtA[:, t])[..., None, None] \
            + torch.einsum("bn,bhp->bhpn", b[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], state))
    return torch.stack(ys, dim=1), state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``x [..., T]`` → lower-triangular pairwise cumulative sums ``[..., T,
    T]`` (−inf above the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(X: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan; ``L`` must be a multiple of ``chunk``. Computes in
    ``X``'s dtype, as the reference's ``ssd_chunked`` does."""
    steps = ssd_chunked_steps(X, dtA, B, C, chunk, initial_state)
    return steps["y"], steps["final_state"]


def ssd_chunked_steps(X: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, chunk: int,
                      initial_state: Optional[torch.Tensor] = None) -> dict:
    """:func:`ssd_chunked` with its intermediates, which the CUDA kernel's
    launches write to their scratch: ``cb`` (C·Bᵀ per row and chunk, ``[B,
    nc, Q, Q]``), ``chunk_states`` (each chunk's own final state, ``[B, nc,
    H, P, N]``), ``entering_states`` (the state entering each chunk, the
    same shape), ``y`` and ``final_state``."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    nc = l // chunk
    Xc = X.reshape(b, nc, chunk, h, p)
    Ac = dtA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)     # [b,h,c,q]
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    A_cum = torch.cumsum(Ac, dim=-1)                          # [b,h,c,q]

    # 1. intra-chunk (diagonal blocks): (C Bᵀ ∘ L) X
    Lm = torch.exp(_segsum(Ac))                               # [b,h,c,q,s]
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    scores = cb[:, None] * Lm
    Y_diag = torch.einsum("bhcqs,bcshp->bcqhp", scores, Xc)

    # 2. chunk-final states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)         # [b,h,c,q]
    Xw = Xc * decay_states.permute(0, 2, 3, 1)[..., None]     # [b,c,s,h,p]
    states = torch.einsum("bcsn,bcshp->bchpn", Bc, Xw)

    # 3. inter-chunk recurrence over the chunks
    chunk_decay = torch.exp(A_cum[..., -1])                   # [b,h,c]
    s = (torch.zeros((b, h, p, n), dtype=X.dtype, device=X.device)
         if initial_state is None else initial_state.to(X.dtype))
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # [b,c,h,p,n]

    # 4. inter-chunk output
    state_decay = torch.exp(A_cum).permute(0, 2, 3, 1)        # [b,c,q,h]
    Y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) \
        * state_decay[..., None]
    return dict(cb=cb, chunk_states=states, entering_states=prev_states,
                chunk_decay=chunk_decay.permute(0, 2, 1),
                y=(Y_diag + Y_off).reshape(b, l, h, p), final_state=s)


def ssd_chunked_bwd(X: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, dY: torch.Tensor,
                    dfinal: Optional[torch.Tensor] = None,
                    initial_state: Optional[torch.Tensor] = None, *,
                    chunk: int,
                    entering_states: Optional[torch.Tensor] = None,
                    chunk_decay: Optional[torch.Tensor] = None):
    """The gradient of :func:`ssd_chunked` for the upstream gradients
    ``dY [B, L, H, P]`` and ``dfinal [B, H, P, N]`` (``None``: zeros).
    Returns ``(dX, ddtA, dB, dC, dinit)``, ``dinit [B, H, P, N]`` the
    gradient of the initial state (of a zero one where none is given).
    ``entering_states`` and ``chunk_decay`` (as :func:`ssd_chunked_steps`
    names them) are the forward's, recomputed where not given.

    With ``a`` the cumulative sum of dtA within a chunk, ``L[q, s] =
    exp(a_q - a_s)`` (s <= q), ``w[s] = exp(a_last - a_s)`` and ``S_c`` the
    state entering chunk c:

    1. a reverse recurrence over chunks, ``dS_nc = dfinal`` and ``dS_c =
       Σ_q exp(a_q) dY[q]ᵀ C[q] + decay_c dS_{c+1}``; the gradient of chunk
       c's own state is ``dS_{c+1}``, of the initial state ``dS_0``;
    2. per chunk, the products of the forward transposed: ``dX[s] =
       Σ_{q>=s} (C_q·B_s) L_qs dY[q] + w[s] dS_{c+1} B[s]``; ``dCB = L ∘
       (dY Xᵀ)`` summed over heads gives ``dC += dCB B`` and ``dB += dCBᵀ
       C``, and the state terms ``dC[q] += exp(a_q) dY[q] S_c`` and
       ``dB[s] += w[s] X[s]ᵀ dS_{c+1}``, summed over heads;
    3. ``da``, the gradient of ``a``: the row sums less the column sums of
       ``(C Bᵀ) ∘ dCB_h``, the inter-chunk output's ``Σ_p dY Y_off``, less
       ``w dw`` at each position, and at the chunk's last position ``Σ_s w
       dw`` and ``decay_c Σ S_c ∘ dS_{c+1}``; ``ddtA`` is its reverse
       cumulative sum within the chunk."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    nc = l // chunk
    Xc = X.reshape(b, nc, chunk, h, p)
    dYc = dY.reshape(b, nc, chunk, h, p)
    Ac = dtA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)     # [b,h,c,q]
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    A_cum = torch.cumsum(Ac, dim=-1)
    Lm = torch.exp(_segsum(Ac))                               # [b,h,c,q,s]
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    w = torch.exp(A_cum[..., -1:] - A_cum)                    # [b,h,c,s]
    eq = torch.exp(A_cum)                                     # [b,h,c,q]
    if entering_states is None or chunk_decay is None:
        steps = ssd_chunked_steps(X, dtA, B, C, chunk, initial_state)
        entering_states, chunk_decay = (steps["entering_states"],
                                        steps["chunk_decay"])
    decay = chunk_decay.to(X.dtype)                           # [b,c,h]

    # 1. the reverse recurrence over chunks
    G = torch.einsum("bhcq,bcqhp,bcqn->bchpn", eq, dYc, Cc)
    ds = (torch.zeros((b, h, p, n), dtype=X.dtype, device=X.device)
          if dfinal is None else dfinal.to(X.dtype))
    d_states = [None] * nc
    for ci in reversed(range(nc)):
        d_states[ci] = ds
        ds = G[:, ci] + decay[:, ci, :, None, None] * ds
    dSt = torch.stack(d_states, dim=1)                        # [b,c,h,p,n]
    ddecay = torch.einsum("bchpn,bchpn->bch", entering_states.to(X.dtype),
                          dSt)

    # 2. per chunk: the intra-chunk products, then the state terms
    dcb_h = Lm * torch.einsum("bcqhp,bcshp->bhcqs", dYc, Xc)
    dcb = dcb_h.sum(dim=1)                                    # [b,c,q,s]
    dX = torch.einsum("bhcqs,bcqhp->bcshp", cb[:, None] * Lm, dYc) \
        + torch.einsum("bhcs,bchpn,bcsn->bcshp", w, dSt, Bc)
    raw = torch.einsum("bcshp,bchpn->bhcsn", Xc, dSt)         # Σ_p X dS
    dB = torch.einsum("bcqs,bcqn->bcsn", dcb, Cc) \
        + torch.einsum("bhcs,bhcsn->bcsn", w, raw)
    dC_state = torch.einsum("bcqhp,bchpn->bhcqn", dYc,
                            entering_states.to(X.dtype)) * eq[..., None]
    dC = torch.einsum("bcqs,bcsn->bcqn", dcb, Bc) + dC_state.sum(dim=1)

    # 3. the gradient of a, then of dtA
    T = cb[:, None] * dcb_h
    wdw = w * torch.einsum("bhcsn,bcsn->bhcs", raw, Bc)
    da = T.sum(dim=-1) - T.sum(dim=-2) \
        + torch.einsum("bhcqn,bcqn->bhcq", dC_state, Cc) - wdw
    last = wdw.sum(dim=-1) + ddecay.permute(0, 2, 1) * decay.permute(0, 2, 1)
    da = torch.cat([da[..., :-1], da[..., -1:] + last[..., None]], dim=-1)
    ddtA = torch.flip(torch.cumsum(torch.flip(da, (-1,)), dim=-1), (-1,))
    return (dX.reshape(b, l, h, p), ddtA.permute(0, 2, 3, 1).reshape(b, l, h),
            dB.reshape(b, l, n), dC.reshape(b, l, n), ds)
