"""Dispatcher over the Mamba2 SSD chunked scan (B8) and its backward: the
CUDA kernels (``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``) for CUDA
tensors, the plain chunked versions (:func:`.ref.ssd_chunked_steps`,
:func:`.ref.ssd_chunked_bwd`) for tensors on the CPU.

``use_kernel=None`` follows the tensors' device, ``False`` runs the plain
version wherever the tensors are, ``True`` insists on the kernel and raises
for CPU tensors. :func:`ssd_scan_cuda` checks device, dtype, shape,
alignment and contiguity, allocates its outputs and the kernels' scratch
with ``torch.empty``, launches on the current stream (four kernels: C·Bᵀ,
chunk states, the recurrence over chunks, the output), raises on a CUDA
error and adds one to ``LAUNCHES["ssd_scan"]``, which so counts scans, not
kernels. It never falls back to the plain version.

:func:`ssd` runs the scan as :class:`SSDScan`, an autograd Function: its
forward is that kernel (or the plain version), and under grad it saves the
inputs with the forward's entering states and chunk decay; its backward is
:func:`ssd_scan_bwd`, the backward kernel (six launches on the tensor
cores, the sums over heads taken on chip; one count in
``LAUNCHES["ssd_scan_bwd"]``, the same checks and no fallback) or the
plain version.

On fake tensors (the dry run's) both wrappers allocate their outputs
and scratch and record the work (:func:`ssd_scan_cost`,
:func:`ssd_scan_bwd_cost`) instead of launching; they count no launch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (KernelCost, check_cuda_tensor,
                                        is_fake, launch, on_card,
                                        record)

from .ref import ssd_chunked_bwd, ssd_chunked_steps

__all__ = ["LAUNCHES", "MAX_CHUNK", "SHAPES", "SSDScan",
           "reset_launch_counts", "ssd", "ssd_scan_bwd", "ssd_scan_bwd_cost",
           "ssd_scan_bwd_cuda", "ssd_scan_cost", "ssd_scan_cuda",
           "ssd_scan_cuda_steps", "ssd_scan_work"]

#: Scans and backward scans run on the card since the last
#: :func:`reset_launch_counts` (one per :func:`ssd_scan_cuda` call, which
#: launches four kernels, and one per :func:`ssd_scan_bwd_cuda` call, which
#: launches six).
LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}
#: ``(head dim P, state width N)`` pairs the kernels are compiled for: the
#: serving and training shapes (the forward on the tensor cores), and the
#: smoke configs' (16, 16) as plain float32 loops.
SHAPES = ((16, 16), (64, 64), (64, 128))
#: Largest chunk the kernel takes.
MAX_CHUNK = 1024


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ssd_scan_work(B: int, L: int, H: int, P: int, N: int, chunk: int,
                  with_init: bool) -> Tuple[float, Dict[str, float]]:
    """``(bytes, {algorithm: operations})`` of one scan: x, dtA, b, c (and
    the initial state) read once, y and the final state written once,
    float32; and the operations (2 per multiply-add) of two algorithms:
    ``chunked``, with the C·Bᵀ scores over the visible (s <= q) pairs once
    per (row, chunk) (b and c are one group for every head) and per (row,
    head) scores·X, C·stateᵀ and the state update; ``sequential``, per
    (row, head, step) state·decay + x bᵀ and state·c, 5 P N."""
    pairs = sum(q * (q + 1) // 2 for q in
                (min(chunk, L - c0) for c0 in range(0, L, chunk)))
    n_bytes = 4 * (2 * B * L * H * P + B * L * H + 2 * B * L * N
                   + (2 if with_init else 1) * B * H * P * N)
    return n_bytes, {
        "chunked": 2 * B * (pairs * N + H * (pairs * P + 2 * L * P * N)),
        "sequential": 5 * B * H * L * P * N}


def ssd_scan_cost(B: int, L: int, H: int, P: int, N: int, chunk: int,
                  with_init: bool) -> KernelCost:
    """B8's work: :func:`ssd_scan_work`'s bytes and the chunked
    algorithm's operations, which B8 runs."""
    n_bytes, ops = ssd_scan_work(B, L, H, P, N, chunk, with_init)
    return KernelCost(ops["chunked"], n_bytes)


def ssd_scan_bwd_cost(B: int, L: int, H: int, P: int, N: int, chunk: int,
                      with_dfinal: bool) -> KernelCost:
    """The backward's work: x, dtA, b, c, dy, the forward's entering
    states and chunk decay (and dfinal) read once, dx, ddtA, db, dc and
    dinit written once, float32; and 2 operations per multiply-add of the
    chunked backward over the visible (s <= q) pairs: C·Bᵀ once per row
    and chunk, dCB's two products with B and C once per row and chunk, and
    per (row, head) dy·xᵀ and the scores' product with dy over the pairs,
    and four products of L P N (the entering gradient, the state terms of
    dx, db and dc)."""
    Lp = -(-L // chunk) * chunk
    nc = Lp // chunk
    pairs = nc * chunk * (chunk + 1) // 2
    n_bytes = 4 * (3 * B * L * H * P + 2 * B * L * H + 4 * B * L * N
                   + B * nc * H * (P * N + 1)
                   + (2 if with_dfinal else 1) * B * H * P * N)
    macs = B * (3 * pairs * N + H * (2 * pairs * P + 4 * Lp * P * N))
    return KernelCost(2 * macs, n_bytes)


def _check_shape(P: int, N: int, L: int, chunk: int, what: str) -> None:
    if (P, N) not in SHAPES:
        raise ValueError(f"{what}: (P, N) = {(P, N)} is not one of "
                         f"{SHAPES}")
    if not 0 < chunk <= MAX_CHUNK or L % chunk:
        raise ValueError(f"{what}: L = {L} is not a multiple of a chunk "
                         f"of 1..{MAX_CHUNK} ({chunk}); pad it (ssd pads)")


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
    _check_shape(P, N, L, chunk, "ssd_scan")
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
    if x.numel() and is_fake(x):
        record("ssd_scan", ssd_scan_cost(Bsz, L, H, P, N, chunk,
                                         initial_state is not None))
    elif x.numel():
        launch("ssd_scan_launch", *ptrs, out["y"].data_ptr(),
               out["final_state"].data_ptr(), out["cb"].data_ptr(),
               out["chunk_states"].data_ptr(),
               out["entering_states"].data_ptr(),
               out["chunk_decay"].data_ptr(), Bsz, L, H, P, N, chunk,
               device=dev)
        LAUNCHES["ssd_scan"] += 1
    return out


def ssd_scan_bwd_cuda(x: torch.Tensor, dtA: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, dy: torch.Tensor, *, chunk: int,
                      entering_states: torch.Tensor,
                      chunk_decay: torch.Tensor,
                      dfinal: Optional[torch.Tensor] = None):
    """The backward kernel. x, dtA, b, c and ``chunk`` as for
    :func:`ssd_scan_cuda`; ``dy [B, L, H, P]`` and ``dfinal [B, H, P, N]``
    (``None``: zeros) the upstream gradients; ``entering_states [B, nc, H,
    P, N]`` and ``chunk_decay [B, nc, H]`` the forward's (from
    :func:`ssd_scan_cuda_steps`, the initial state in ``entering_states[:,
    0]``). All float32, contiguous, on one CUDA device. Returns ``(dx,
    ddtA, db, dc, dinit)``, float32, ``dinit`` the gradient of the initial
    state (of a zero one where there was none)."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    dev, f32 = x.device, torch.float32
    _check_shape(P, N, L, chunk, "ssd_scan_bwd")
    nc = L // chunk
    ptrs = [check_cuda_tensor("x", x, f32, (Bsz, L, H, P), dev, 16),
            check_cuda_tensor("dtA", dtA, f32, (Bsz, L, H), dev),
            check_cuda_tensor("b", b, f32, (Bsz, L, N), dev, 16),
            check_cuda_tensor("c", c, f32, (Bsz, L, N), dev, 16),
            check_cuda_tensor("dy", dy, f32, (Bsz, L, H, P), dev, 16),
            None if dfinal is None else check_cuda_tensor(
                "dfinal", dfinal, f32, (Bsz, H, P, N), dev, 16),
            check_cuda_tensor("entering_states", entering_states, f32,
                              (Bsz, nc, H, P, N), dev, 16),
            check_cuda_tensor("chunk_decay", chunk_decay, f32,
                              (Bsz, nc, H), dev)]
    out = (torch.empty_like(x), torch.empty_like(dtA), torch.empty_like(b),
           torch.empty_like(c),
           torch.empty((Bsz, H, P, N), dtype=f32, device=dev))
    if x.numel() and is_fake(x):
        _bwd_scratch(Bsz, L, H, P, N, chunk, dev)   # allocated, as a launch
        record("ssd_scan_bwd", ssd_scan_bwd_cost(Bsz, L, H, P, N, chunk,
                                                 dfinal is not None))
    elif x.numel():
        launch("ssd_scan_bwd_launch", *ptrs,
               *(t.data_ptr() for t in out),
               *(t.data_ptr() for t in _bwd_scratch(Bsz, L, H, P, N, chunk,
                                                    dev)),
               Bsz, L, H, P, N, chunk, device=dev)
        LAUNCHES["ssd_scan_bwd"] += 1
    return out


def _bwd_scratch(Bsz: int, L: int, H: int, P: int, N: int, chunk: int,
                 dev) -> tuple:
    """The backward kernel's scratch as views of one float32 allocation:
    ``cb`` and ``dcb`` ``[B, nc, Qp, Qp]`` (C·Bᵀ and dCB summed over heads;
    ``Qp`` the chunk rounded up to 64), ``dchunk`` ``[B, nc, H, P, N]``
    (the state gradients), ``acum`` ``[B, L, H]`` (dtA's cumulative sums
    within each chunk) and ``da_off`` ``[N // 64, B, L, H]`` (da's term of
    the entering state, per 64 columns of N; none at P = N = 16), in that
    order, the first three 16-byte aligned."""
    nc, qp = L // chunk, -(-chunk // 64) * 64
    sizes = ((Bsz * nc * qp * qp,) * 2
             + (Bsz * nc * H * P * N, Bsz * L * H,
                N // 64 * Bsz * L * H))
    return torch.empty(sum(sizes), dtype=torch.float32, device=dev) \
        .split(sizes)


def ssd_scan_bwd(x: torch.Tensor, dtA: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, dy: torch.Tensor, *, chunk: int,
                 entering_states: torch.Tensor, chunk_decay: torch.Tensor,
                 dfinal: Optional[torch.Tensor] = None,
                 use_kernel: Optional[bool] = None):
    """The backward's dispatcher (``L`` a multiple of ``chunk``; arguments
    as for :func:`ssd_scan_bwd_cuda`): the kernel for CUDA tensors,
    :func:`.ref.ssd_chunked_bwd` for CPU tensors (``use_kernel`` as for
    :func:`ssd`). Returns ``(dx, ddtA, db, dc, dinit)``."""
    if not (on_card(x) if use_kernel is None else use_kernel):
        return ssd_chunked_bwd(x, dtA, b, c, dy, dfinal, chunk=chunk,
                               entering_states=entering_states,
                               chunk_decay=chunk_decay)
    return ssd_scan_bwd_cuda(
        x.contiguous(), dtA.contiguous(), b.contiguous(), c.contiguous(),
        dy.contiguous(), chunk=chunk,
        entering_states=entering_states.contiguous(),
        chunk_decay=chunk_decay.contiguous(),
        dfinal=None if dfinal is None else dfinal.contiguous())


class SSDScan(torch.autograd.Function):
    """The differentiable SSD scan (``L`` a multiple of ``chunk``): the
    forward is B8 (:func:`ssd_scan_cuda_steps`, or
    :func:`.ref.ssd_chunked_steps` with ``use_kernel=False`` or on the
    CPU) and saves the inputs with the forward's entering states and chunk
    decay; the backward is :func:`ssd_scan_bwd` with the same
    ``use_kernel``. A gradient that does not reach ``y`` or the final state
    comes as ``None`` and is taken as zeros."""

    @staticmethod
    def forward(ctx, x, dtA, b, c, initial_state, chunk: int,
                use_kernel: Optional[bool]):
        ctx.set_materialize_grads(False)
        if on_card(x) if use_kernel is None else use_kernel:
            steps = ssd_scan_cuda_steps(
                x.contiguous(), dtA.contiguous(), b.contiguous(),
                c.contiguous(), chunk=chunk,
                initial_state=None if initial_state is None
                else initial_state.contiguous())
        else:
            steps = ssd_chunked_steps(x, dtA, b, c, chunk, initial_state)
        ctx.save_for_backward(x, dtA, b, c, steps["entering_states"],
                              steps["chunk_decay"])
        ctx.args = (chunk, use_kernel, initial_state is not None)
        return steps["y"], steps["final_state"]

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dtA, b, c, entering, decay = ctx.saved_tensors
        chunk, use_kernel, has_init = ctx.args
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddtA, db, dc, dinit = ssd_scan_bwd(
            x, dtA, b, c, dy, chunk=chunk, entering_states=entering,
            chunk_decay=decay, dfinal=dfinal, use_kernel=use_kernel)
        return dx, ddtA, db, dc, dinit if has_init else None, None, None


def ssd(x: torch.Tensor, dtA: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int,
        initial_state: Optional[torch.Tensor] = None,
        use_kernel: Optional[bool] = None):
    """SSD scan of a sequence of any length: pads ``L`` with zeros to a
    multiple of ``chunk`` (a padded position has dtA = 0 and x = b = c = 0,
    so it leaves the state unchanged), scans through :class:`SSDScan`, and
    cuts ``y`` back to ``L``. Returns ``(y [B, L, H, P], final_state [B, H,
    P, N])``. Under grad the backward is the backward kernel on CUDA
    tensors; the padding stays outside the Function, and the slice back to
    ``L`` cuts the pad positions' gradients off."""
    L = x.shape[1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    y, state = SSDScan.apply(x, dtA, b, c, initial_state, chunk, use_kernel)
    return y[:, :L], state
