"""Dispatcher over the Mamba2 SSD chunked scan (B8): the CUDA kernel
(``csrc/ssd_scan.cu``) for CUDA tensors, the plain chunked version
(:func:`.ref.ssd_chunked`) for tensors on the CPU.

``use_kernel=None`` follows the tensors' device, ``False`` runs the plain
version wherever the tensors are, ``True`` insists on the kernel and raises
for CPU tensors. :func:`ssd_scan_cuda` checks device, dtype, shape,
alignment and contiguity, allocates its outputs and the kernels' scratch
with ``torch.empty``, launches on the current stream (four kernels: C·Bᵀ,
chunk states, the recurrence over chunks, the output), raises on a CUDA
error and adds one to ``LAUNCHES["ssd_scan"]``, which so counts scans, not
kernels. It never falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import check_cuda_tensor, launch

from .ref import ssd_chunked

__all__ = ["LAUNCHES", "MAX_CHUNK", "SHAPES", "reset_launch_counts", "ssd",
           "ssd_scan_cuda", "ssd_scan_cuda_steps"]

#: Scans run on the card since the last :func:`reset_launch_counts` (one
#: per :func:`ssd_scan_cuda` call, which launches four kernels).
LAUNCHES = {"ssd_scan": 0}
#: ``(head dim P, state width N)`` pairs the kernel is compiled for: the
#: serving shapes on the tensor cores, and the smoke configs' (16, 16) as
#: plain float32 loops.
SHAPES = ((16, 16), (64, 64), (64, 128))
#: Largest chunk the kernel takes.
MAX_CHUNK = 1024


def reset_launch_counts() -> None:
    LAUNCHES["ssd_scan"] = 0


def ssd_scan_cuda(x: torch.Tensor, dtA: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, *, chunk: int,
                  initial_state: Optional[torch.Tensor] = None):
    """B8 kernel. x ``[B, L, H, P]``, dtA ``[B, L, H]``, b/c ``[B, L, N]``,
    initial_state ``[B, H, P, N]`` or ``None`` (zeros); all float32,
    contiguous, on one CUDA device; ``(P, N)`` in :data:`SHAPES`, ``L`` a
    multiple of ``chunk``, ``chunk <= MAX_CHUNK``. Returns ``(y [B, L, H,
    P], final_state [B, H, P, N])``, float32."""
    steps = ssd_scan_cuda_steps(x, dtA, b, c, chunk=chunk,
                                initial_state=initial_state)
    return steps["y"], steps["final_state"]


def ssd_scan_cuda_steps(x: torch.Tensor, dtA: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, *, chunk: int,
                        initial_state: Optional[torch.Tensor] = None
                        ) -> dict:
    """:func:`ssd_scan_cuda` with the kernels' scratch, named as
    :func:`.ref.ssd_chunked_steps` names its intermediates: ``cb`` ``[B,
    nc, Qp, Qp]`` (C·Bᵀ of each chunk; ``Qp`` is the chunk rounded up to
    64, and only ``s <= q < chunk`` is meant), ``chunk_states`` and
    ``entering_states`` ``[B, nc, H, P, N]``, ``chunk_decay`` ``[B, nc,
    H]`` (exp of each chunk's summed dtA), ``y`` and ``final_state``."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    dev, f32 = x.device, torch.float32
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd_scan: (P, N) = {(P, N)} is not one of "
                         f"{SHAPES}")
    if not 0 < chunk <= MAX_CHUNK or L % chunk:
        raise ValueError(f"ssd_scan: L = {L} is not a multiple of a chunk "
                         f"of 1..{MAX_CHUNK} ({chunk}); pad it (ssd pads)")
    ptrs = [check_cuda_tensor("x", x, f32, (Bsz, L, H, P), dev, 16),
            check_cuda_tensor("dtA", dtA, f32, (Bsz, L, H), dev),
            check_cuda_tensor("b", b, f32, (Bsz, L, N), dev, 16),
            check_cuda_tensor("c", c, f32, (Bsz, L, N), dev, 16),
            None if initial_state is None else check_cuda_tensor(
                "initial_state", initial_state, f32, (Bsz, H, P, N), dev)]
    nc, qp = L // chunk, -(-chunk // 64) * 64
    out = dict(
        cb=torch.empty((Bsz, nc, qp, qp), dtype=f32, device=dev),
        chunk_states=torch.empty((Bsz, nc, H, P, N), dtype=f32, device=dev),
        entering_states=torch.empty((Bsz, nc, H, P, N), dtype=f32,
                                    device=dev),
        chunk_decay=torch.empty((Bsz, nc, H), dtype=f32, device=dev),
        y=torch.empty_like(x),
        final_state=torch.empty((Bsz, H, P, N), dtype=f32, device=dev))
    if x.numel():
        launch("ssd_scan_launch", *ptrs, out["y"].data_ptr(),
               out["final_state"].data_ptr(), out["cb"].data_ptr(),
               out["chunk_states"].data_ptr(),
               out["entering_states"].data_ptr(),
               out["chunk_decay"].data_ptr(), Bsz, L, H, P, N, chunk,
               device=dev)
        LAUNCHES["ssd_scan"] += 1
    return out


def ssd(x: torch.Tensor, dtA: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int,
        initial_state: Optional[torch.Tensor] = None,
        use_kernel: Optional[bool] = None):
    """SSD scan of a sequence of any length: pads ``L`` with zeros to a
    multiple of ``chunk`` (a padded position has dtA = 0 and x = b = c = 0,
    so it leaves the state unchanged), scans, and cuts ``y`` back to
    ``L``. Returns ``(y [B, L, H, P], final_state [B, H, P, N])``. The
    kernel's output has no autograd history, so where it would run under
    grad this raises :class:`RuntimeError`."""
    L = x.shape[1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if x.is_cuda if use_kernel is None else use_kernel:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dtA, b, c, initial_state)):
            raise RuntimeError(
                "ssd: the SSD scan kernel has no backward (the reference has "
                "none in Pallas either; ROADMAP A12); differentiate the "
                "plain ssd_chunked with use_kernel=False")
        y, state = ssd_scan_cuda(
            x.contiguous(), dtA.contiguous(), b.contiguous(), c.contiguous(),
            chunk=chunk, initial_state=None if initial_state is None
            else initial_state.contiguous())
    else:
        y, state = ssd_chunked(x, dtA, b, c, chunk, initial_state)
    return y[:, :L], state
