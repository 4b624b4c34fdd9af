"""Collectives over the named dimensions of a device mesh, with autograd.

The counterparts of ``jax.lax.all_gather``, ``psum_scatter``, ``psum`` and
``axis_index`` inside the reference's ``shard_map`` bodies. ``axis`` names
one dimension of a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``"model"``) or a tuple of them (``("data",)``, ``("data", "model")``,
row-major in the mesh's order). Each function is a
:class:`torch.autograd.Function` whose backward is JAX's transpose:

* :func:`all_gather` (tiled along ``dim``) ← a reduce-scatter;
* :func:`psum_scatter` (summed, then this rank's block of ``dim``) ← an
  all-gather;
* :func:`psum` ← :func:`psum`.

So a rank's backward gives the gradient of the sum of every rank's loss
term with respect to that rank's own copy of each input, and a replicated
parameter's gradient is the sum of its ranks' gradients (the trainer sums
them). Every reduction adds the ranks' terms in rank order, ``((r0 + r1) +
r2) + …``, on the rank that owns the block (a bf16 or fp16 input in
float32, rounded once at the end, as XLA sums it), and an all-gather hands
the sums out: two runs, and every rank, see the same bits. They go through
``torch.distributed`` on the mesh's groups (NCCL or gloo) even where an
axis has one rank, so a one-card mesh exercises the same calls.

Each exchange adds to :data:`COUNTS` (``calls`` and the ``bytes`` it
sends; a psum is two exchanges, a reduce-scatter and an all-gather)
and, while obs tracing is on, to the obs counters
``mesh.collective.<op>.calls`` / ``.bytes``. :data:`WIRE` counts the same
exchanges by the ``torch.distributed`` call that carries them, with the
operand and result bytes of each (the dry run's wire table): the port's
psum is an ``all_to_all_single`` and an ``all_gather_into_tensor``, not
an all-reduce, and the port makes no all-reduce call.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.obs import count as obs_count

__all__ = ["COUNTS", "WIRE", "all_gather", "axis_index", "axis_size",
           "current_mesh", "psum", "psum_scatter", "reset_counts",
           "reset_groups", "use_mesh"]

Axis = Union[str, Sequence[str]]

#: Calls and bytes sent since the last :func:`reset_counts`, by operation
#: (the backward's collectives count under their own operation).
COUNTS: Dict[str, Dict[str, int]] = {
    op: {"calls": 0, "bytes": 0}
    for op in ("all_gather", "psum_scatter", "psum")}

#: The same exchanges by the ``torch.distributed`` call made (the names
#: of XLA's collectives): ``all-gather`` (``all_gather_into_tensor``),
#: ``all-to-all`` (``all_to_all_single``) and ``all-reduce`` (none is
#: made), each with its calls and the bytes of its operand (what this rank
#: sends) and of its result (what it receives).
WIRE: Dict[str, Dict[str, int]] = {
    op: {"calls": 0, "operand_bytes": 0, "result_bytes": 0}
    for op in ("all-gather", "all-to-all", "all-reduce")}

_ACTIVE: List = []
_GROUPS: Dict = {}


def reset_counts() -> None:
    for c in COUNTS.values():
        c["calls"] = c["bytes"] = 0
    for c in WIRE.values():
        c["calls"] = c["operand_bytes"] = c["result_bytes"] = 0


def reset_groups() -> None:
    """Forget the process groups made for the meshes' axes (call it after
    destroying the process group they belong to)."""
    _GROUPS.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _counted(op: str, t: torch.Tensor) -> None:
    n = _nbytes(t)
    COUNTS[op]["calls"] += 1
    COUNTS[op]["bytes"] += n
    obs_count(f"mesh.collective.{op}.calls")
    obs_count(f"mesh.collective.{op}.bytes", n)


def _wire(op: str, operand: torch.Tensor, result: torch.Tensor) -> None:
    w = WIRE[op]
    w["calls"] += 1
    w["operand_bytes"] += _nbytes(operand)
    w["result_bytes"] += _nbytes(result)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` the one that calls without ``mesh=`` use."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    if not _ACTIVE:
        raise RuntimeError("no mesh: pass mesh= or call inside "
                           "repro_torch.distributed.collectives.use_mesh")
    return _ACTIVE[-1]


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _dims(mesh, names: Tuple[str, ...]) -> List[int]:
    dims = [mesh.mesh_dim_names.index(n) for n in names]
    if dims != sorted(dims):
        raise ValueError(f"axes {names} must follow the mesh's order "
                         f"{mesh.mesh_dim_names}")
    return dims


def axis_size(axis: Axis, *, mesh=None) -> int:
    """Ranks along ``axis`` (the product over a tuple)."""
    mesh = mesh if mesh is not None else current_mesh()
    shape = tuple(mesh.shape)
    return int(np.prod([shape[d] for d in _dims(mesh, _names(axis))]))


def axis_index(axis: Axis, *, mesh=None) -> int:
    """This rank's row-major index along ``axis``."""
    mesh = mesh if mesh is not None else current_mesh()
    shape, idx = tuple(mesh.shape), 0
    for d in _dims(mesh, _names(axis)):
        idx = idx * shape[d] + mesh.get_local_rank(d)
    return idx


def _group(mesh, axis: Axis):
    """The process group of this rank's line (or plane) along ``axis``;
    its ranks, ascending, are the line's row-major order."""
    names = _names(axis)
    key = (mesh, names)
    if key not in _GROUPS:
        dims = _dims(mesh, names)
        # the mesh's ranks as a host array, read outside any fake tensor
        # mode (the dry run builds its groups inside one)
        with unset_fake_temporarily():
            ranks = mesh.mesh.numpy().copy()
        if len(dims) == 1:
            group = mesh.get_group(dims[0])
        elif len(dims) == ranks.ndim and ranks.size == \
                dist.get_world_size() and ranks.flatten().tolist() == \
                list(range(ranks.size)):
            group = dist.group.WORLD
        else:
            rest = [d for d in range(ranks.ndim) if d not in dims]
            lines = ranks.transpose(rest + dims).reshape(
                -1, axis_size(names, mesh=mesh)).tolist()
            group, _ = dist.new_subgroups_by_enumeration(lines)
        _GROUPS[key] = group
    return _GROUPS[key]


# ---------------------------------------------------------------------------
# the exchanges (no autograd)
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, group, n: int, dim: int,
            op: str = "all_gather") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _counted(op, x)
    _wire("all-gather", x, out)
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.view((n,) + tuple(x.shape))
    return out.movedim(0, dim).flatten(dim, dim + 1)


def _scatter_sum(x: torch.Tensor, group, n: int, dim: int,
                 op: str = "psum_scatter") -> torch.Tensor:
    """Σ over ranks of ``x`` (in rank order), this rank's block of
    ``dim`` (``x.shape[dim]`` divisible by ``n``)."""
    N = x.shape[dim]
    if N % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = x.movedim(dim, 0).reshape((n, N // n) + tuple(
        x.movedim(dim, 0).shape[1:])).contiguous()
    recv = torch.empty_like(send)
    _counted(op, send)
    _wire("all-to-all", send, recv)
    dist.all_to_all_single(recv, send, group=group)
    # a float narrower than float32 is summed in float32 and rounded once,
    # as XLA's psum of a bf16 array is (a running bf16 sum rounds at every
    # addition); the exchange stays in the input dtype
    wide = recv.is_floating_point() and torch.finfo(recv.dtype).bits < 32
    terms = recv.unbind(0)
    acc = terms[0].float() if wide else terms[0]
    for term in terms[1:]:
        acc = acc + term
    return (acc.to(recv.dtype) if wide else acc).movedim(0, dim)


def _sum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Σ over ranks of ``x`` on every rank: each rank sums one block of
    the flattened tensor in rank order, then the blocks are gathered."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    part = _scatter_sum(flat, group, n, 0, op="psum")
    return _gather(part, group, n, 0, op="psum")[:x.numel()].view(x.shape)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter_sum(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _sum(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, ctx.n), None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int, tiled: bool = True,
               *, mesh=None) -> torch.Tensor:
    """The ranks' ``x`` along ``axis``, concatenated along ``dim`` in rank
    order (``tiled``) or stacked on a new leading dimension ``dim``."""
    mesh = mesh if mesh is not None else current_mesh()
    n = axis_size(axis, mesh=mesh)
    group = _group(mesh, axis)
    dim = dim % (x.ndim if tiled else x.ndim + 1)
    if not tiled:
        return _AllGather.apply(x.unsqueeze(dim), group, n, dim)
    return _AllGather.apply(x, group, n, dim)


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int, *, mesh=None
                 ) -> torch.Tensor:
    """Σ of the ranks' ``x`` along ``axis``, this rank's block of ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``)."""
    mesh = mesh if mesh is not None else current_mesh()
    return _PsumScatter.apply(x, _group(mesh, axis),
                              axis_size(axis, mesh=mesh), dim % x.ndim)


def psum(x: torch.Tensor, axis: Axis, *, mesh=None) -> torch.Tensor:
    """Σ of the ranks' ``x`` along ``axis``, on every rank."""
    mesh = mesh if mesh is not None else current_mesh()
    return _Psum.apply(x, _group(mesh, axis), axis_size(axis, mesh=mesh))
