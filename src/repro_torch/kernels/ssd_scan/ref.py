"""Plain PyTorch versions of the Mamba2 SSD scan (B8).

* :func:`ssd_scan_ref` — the sequential recurrence ``h ← h·exp(ΔA) + B ⊗
  x; y = C·h``, one step per position: the oracle;
* :func:`ssd_chunked` — the chunked matrix form of the model layer
  (arXiv:2405.21060): intra-chunk ``(C Bᵀ ∘ L) X``, chunk-final states, a
  short recurrence over chunks and the inter-chunk output. The dispatcher
  runs it on the CPU and when asked for the plain version.

Both take ``x [B, L, H, P]`` (already scaled by Δ), ``dtA [B, L, H]`` (Δ·A,
negative) and ``b, c [B, L, N]`` (one group, shared by every head), and an
optional float32 ``initial_state [B, H, P, N]``; both return ``(y [B, L,
H, P], final_state [B, H, P, N])``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ssd_chunked", "ssd_chunked_steps", "ssd_scan_ref"]


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
                y=(Y_diag + Y_off).reshape(b, l, h, p), final_state=s)
