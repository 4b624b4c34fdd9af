"""Model layers in PyTorch: the port of the JAX package's
``models/layers.py`` (attention, MLP, the capacity-based MoE and the
Mamba2 block, on one device or on a device mesh).

Parameters live in small :class:`torch.nn.Module` holders
(:class:`Attention`, :class:`MLP`, :class:`MoE`, :class:`Mamba`); the math is plain
tensor functions with the reference's names and layouts (``[B, S, H, hd]``
activations, ``[D, H, hd]`` projections), so the two packages compare like
with like. Prefill attention goes through
:func:`~repro_torch.kernels.flash_attention.attention` (B4), decode
attention through :func:`~repro_torch.kernels.gqa_decode.decode_attention`
(B7) and a Mamba prefill's SSD scan through
:func:`~repro_torch.kernels.ssd_scan.ssd` (B8); their ``use_kernel`` flag is
passed through. The chunked scan :func:`ssd_chunked` (B8's plain version)
lives beside its kernel and is re-exported here. The MoE's expert
products are plain batched products (the reference leaves them to XLA
too).

On a mesh (a :class:`MeshContext`) every rank holds the **local** block of
each activation that the reference's sharding constraints name (PyTorch
has no SPMD partitioner, so :func:`cst` moves blocks with the collectives
of :mod:`repro_torch.distributed.collectives`): the residual stream is
``[B/data, S/model, D]``. Attention and the MLP gather the sequence and
compute on this rank's heads or ``d_ff`` slice, then sum the
out-projection over the model axis — a ``psum`` and a slice back to the
local sequence (the baseline), or a ``psum_scatter`` (Megatron-SP,
``sp_matmuls``: :func:`sp_qkv`, :func:`sp_out_proj`, :func:`sp_mlp`,
which also all-gather the FSDP weight shard). Where the heads or ``d_ff``
do not divide the model axis the baseline runs the whole block on every
model rank. The MoE shards its experts (ep) or its ``d_ff`` (tp) over the
model axis, with the capacity of this rank's tokens. The Mamba2 block
splits its SSM heads over the model axis (:func:`mamba_block`): each model
rank computes its heads' columns of ``z``, ``x`` and ``dt`` and its
``N/model`` columns of ``B`` and of ``C``, all-gathers ``B``/``C`` before
the scan, scans its heads through B8, takes the gated norm's sum of
squares as a psum over the model axis and sums its rows of ``out_proj``
back into the stream as the MLP does; where the heads do not divide the
axis the block runs whole on every model rank.

Parameters are stored in one of two layouts. **Replicated** (the layout
``init_params`` gives): every rank holds every parameter whole, slices it
at use, and its backward gives its share of each gradient, which the
trainer sums over the mesh. **Blocks** (``shard_train_state``): every
rank holds only its block of each parameter as ``train_state_pspecs``
lays it out (a ``"data"`` dimension split over the FSDP axes, a
``"model"`` dimension over the model axis, a size that does not divide
its axis whole); each block parameter carries its spec and whole shape
(``pspec``, ``whole_shape``). A layer then materializes its parameters
on entry (:func:`local_params`): each is all-gathered from the blocks
over the FSDP axes, unless the layer gathers the FSDP block itself in
the compute dtype (:func:`_fsdp`: the SP projections, the MoE's experts,
the vocab-parallel lookup of an untied table), and over the model axis,
unless the rank computes with the very block it stores (attention's
heads, the MLP's and the MoE's ``d_ff`` or experts, the Mamba block's
``out_proj`` rows and norm scale, the table's vocabulary rows). The
gathers' backward sums the ranks' gradients of the block in rank order,
the reduction the replicated layout's trainer makes over the whole mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.kernels._build import is_fake
from repro_torch.kernels.flash_attention import attention
from repro_torch.kernels.gqa_decode import combine_blocks, decode_attention
from repro_torch.kernels.ssd_scan import ssd, ssd_chunked

from .config import ModelConfig

__all__ = ["Attention", "MLP", "Mamba", "MeshContext", "MoE", "MoERouting",
           "apply_rope", "attention_block", "cst", "dense",
           "init_attention", "init_mamba", "init_mlp", "init_moe",
           "mamba_block", "mamba_channels", "mlp_block", "moe_block",
           "moe_capacity", "moe_local", "moe_route", "rms_norm", "sp_mlp",
           "sp_out_proj", "sp_qkv", "ssd_chunked", "ssd_decode_step",
           "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, …)."""
    return _DTYPES[name]


def _normal(shape, generator: torch.Generator, dtype, std: float = 0.02,
            device=None):
    """Normal(0, std) draws from ``generator`` on ``device`` (default the
    generator's own)."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device if device is None
                       else device) * std


def _param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter (serving runs under ``torch.inference_mode``,
    so it records no graph)."""
    return nn.Parameter(t)


# ===========================================================================
# Mesh context & layouts
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Carries the mesh and logical-axis mapping through the model."""
    mesh: Any                       # torch.distributed DeviceMesh
    batch_axes: Tuple[str, ...]     # e.g. ("data",) or ("pod", "data")
    model_axis: str = "model"
    shard_seq: bool = True          # sequence-parallel residual stream
    #: Megatron-SP projections: the sequence all-gather and the
    #: out-projection's psum_scatter inside the differentiated region
    #: (:func:`sp_qkv`, :func:`sp_out_proj`, :func:`sp_mlp`); the baseline
    #: sums the out-projection with a full psum and slices.
    sp_matmuls: bool = False
    #: the global ``(batch, sequence)`` of the activations in flight, which
    #: the layout rules read; :func:`~repro_torch.models.transformer
    #: .forward` sets it (:meth:`at`)
    shape: Optional[Tuple[int, int]] = None
    #: the whole KV cache's slot count where its sequence is laid out over
    #: the batch axes (a decode step at batch 1, ``shard_seq``); None where
    #: each rank holds every slot of its rows
    kv_slots: Optional[int] = None

    @property
    def model_size(self) -> int:
        return C.axis_size(self.model_axis, mesh=self.mesh)

    @property
    def fsdp_axes(self):
        """Axes the FSDP (ZeRO-3) domain spans — the full DP domain."""
        return self.batch_axes

    @property
    def data_size(self) -> int:
        return C.axis_size(self.batch_axes, mesh=self.mesh)

    @property
    def model_index(self) -> int:
        return C.axis_index(self.model_axis, mesh=self.mesh)

    @property
    def data_index(self) -> int:
        return C.axis_index(self.batch_axes, mesh=self.mesh)

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        """Every axis of the mesh, in its order."""
        return tuple(self.mesh.mesh_dim_names)

    def at(self, batch: int, seq: int) -> "MeshContext":
        """This context for activations of global shape ``[batch, seq,
        ...]``."""
        if self.shape == (batch, seq):
            return self
        return dataclasses.replace(self, shape=(int(batch), int(seq)))

    def stream(self) -> Tuple[Optional[str], ...]:
        """The residual stream's layout: ``("batch", "model", None)``, or
        the sequence whole without ``shard_seq``."""
        return ("batch", "model" if self.shard_seq else None, None)

    def block(self, dim: int, name: Optional[str],
              size: Optional[int] = None):
        """``(ranks, index, axis)`` of dimension ``dim`` (0: batch, 1:
        sequence) laid out over ``name`` ("batch" or "model"; a sequence
        over "batch" is the KV cache's slots at batch 1), of global size
        ``size`` (default the bound shape's): one rank and the whole
        dimension where ``name`` is None or the size does not divide over
        the axis — then the dimension is replicated. The layout rules of
        the port live here."""
        if name is None:
            return 1, 0, None
        if size is None:
            if self.shape is None:
                raise ValueError("MeshContext.at(batch, seq) must bind the "
                                 "global shape before a layout is read")
            size = self.shape[dim]
        if name == "batch" and dim in (0, 1):
            n, axis = self.data_size, self.batch_axes
        elif (dim, name) == (1, "model"):
            n, axis = self.model_size, self.model_axis
        else:
            raise ValueError(f"no layout rule for {name!r} on dimension "
                             f"{dim}")
        if size % n:
            return 1, 0, None
        return n, C.axis_index(axis, mesh=self.mesh), axis

    def unique(self, layout) -> bool:
        """Whether this rank's block of ``layout`` is held by no rank
        before it: the first rank of every axis that replicates it (the
        loss counts each token once)."""
        rows, _, _ = self.block(0, layout[0])
        seq, _, _ = self.block(1, layout[1])
        return (rows > 1 or self.data_index == 0) and \
            (seq > 1 or self.model_index == 0)


def cst(ctx: Optional[MeshContext], x: torch.Tensor, *axes,
        frm=None) -> torch.Tensor:
    """Move ``x`` from this rank's block of layout ``frm`` (default: every
    dimension whole) to its block of layout ``axes``; a no-op without a
    mesh. Entries: ``"batch"`` (dimension 0 over the batch axes),
    ``"model"`` (dimension 1, the sequence, over the model axis) or None
    (whole). A dimension that leaves an axis is all-gathered, one that
    enters it is sliced (:meth:`MeshContext.block`: a global size that
    does not divide stays whole)."""
    if ctx is None:
        return x
    frm = tuple(frm) if frm is not None else (None,) * len(axes)
    for dim, (a, b) in enumerate(zip(frm, axes)):
        if a == b:
            continue
        if a is not None and b is not None:
            raise ValueError(f"cannot move dimension {dim} from {a!r} to "
                             f"{b!r}")
        n, i, axis = ctx.block(dim, a or b)
        if n == 1:
            continue
        if b is None:
            x = C.all_gather(x, axis, dim, mesh=ctx.mesh)
        else:
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
    return x


def _model_slice(ctx: MeshContext, n: int) -> Optional[slice]:
    """This model rank's block of ``n`` (heads, ``d_ff``, experts,
    vocabulary rows), or None where ``n`` does not divide the axis."""
    m = ctx.model_size
    if n % m:
        return None
    i = ctx.model_index
    return slice(i * (n // m), (i + 1) * (n // m))


def _fsdp(ctx: MeshContext, w: torch.Tensor, dim: int, whole: int
          ) -> torch.Tensor:
    """The reference's FSDP all-gather of a weight inside a shard_map body:
    this data rank's block of ``dim`` (whole size ``whole``), all-gathered
    over the FSDP axes (the replicated weight's values; its backward
    reduce-scatters the gradient over the data ranks). A replicated weight
    is narrowed to the block first; a weight stored as blocks reaches here
    as its stored block (:func:`local_params` keeps the FSDP dimension of
    the weights these sites gather) and is gathered as it is."""
    n = C.axis_size(ctx.fsdp_axes, mesh=ctx.mesh)
    if whole % n:
        raise ValueError(f"dimension {dim} of a {tuple(w.shape)} weight "
                         f"does not split over the {n} FSDP ranks")
    size = whole // n
    if w.shape[dim] == whole:
        i = C.axis_index(ctx.fsdp_axes, mesh=ctx.mesh)
        w = w.narrow(dim, i * size, size)
    elif w.shape[dim] != size:
        raise ValueError(f"dimension {dim} of a {tuple(w.shape)} weight is "
                         f"neither whole ({whole}) nor an FSDP block")
    return C.all_gather(w, ctx.fsdp_axes, dim, mesh=ctx.mesh)


def _sp_sharded(ctx: Optional[MeshContext]) -> bool:
    """The SP path applies when tokens shard over (batch × seq): global
    batch divisible by the data axes, sequence (above 1) by the model
    axis."""
    if ctx is None or not ctx.sp_matmuls:
        return False
    B, S = ctx.shape
    return S > 1 and B % ctx.data_size == 0 and S % ctx.model_size == 0


def _divides(ctx: MeshContext, what: str, *sizes: int) -> None:
    """The reference's shard_map raises where a sharded size does not
    divide its axis."""
    m = ctx.model_size
    if any(n % m for n in sizes):
        raise ValueError(f"{what} {sizes} do not split over the {m}-rank "
                         "model axis (the reference's shard_map raises)")


def _part(w: torch.Tensor, dim: int, n: int, sl: Optional[slice]
          ) -> torch.Tensor:
    """This model rank's slice ``sl`` of dimension ``dim`` (whole size
    ``n``) of ``w``: a whole (replicated) weight is narrowed, a stored
    block (:func:`local_params` keeps the block the rank computes with) is
    that slice already; ``sl`` None is the whole dimension."""
    if w.shape[dim] == n:
        return w if sl is None else w.narrow(dim, sl.start,
                                              sl.stop - sl.start)
    if sl is None or w.shape[dim] != sl.stop - sl.start:
        raise ValueError(f"dimension {dim} of a {tuple(w.shape)} weight is "
                         f"neither whole ({n}) nor this rank's block {sl}")
    return w


# ===========================================================================
# Parameters stored as each rank's block (the sharded training state)
# ===========================================================================

Spec = Tuple[Optional[str], ...]


def leaf_split(ctx: MeshContext, spec: Spec, shape
               ) -> Tuple[Optional[Tuple[str, ...]], ...]:
    """For each dimension of a leaf of whole ``shape`` laid out as
    ``spec``: the mesh axes it is split over — the FSDP axes for
    ``"data"``, the model axis for ``"model"``, the axes a tuple names (a
    cache's batch axes) — or None where it stays whole (no name, an axis
    of one rank, or a size that does not divide the axis: GSPMD pads such
    a dimension, the port keeps it whole)."""
    out = []
    for name, size in zip(spec, shape):
        axes = tuple(name) if isinstance(name, (tuple, list)) else {
            "data": tuple(ctx.fsdp_axes),
            "model": (ctx.model_axis,)}.get(name)
        n = C.axis_size(axes, mesh=ctx.mesh) if axes else 1
        out.append(axes if n > 1 and size % n == 0 else None)
    return tuple(out)


def block_of(t: torch.Tensor, spec: Spec, ctx: MeshContext
             ) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a view)."""
    for dim, axes in enumerate(leaf_split(ctx, spec, t.shape)):
        if axes is not None:
            n = C.axis_size(axes, mesh=ctx.mesh)
            b = t.shape[dim] // n
            t = t.narrow(dim, C.axis_index(axes, mesh=ctx.mesh) * b, b)
    return t


class _LeafPlan:
    """How one block parameter is materialized for a layer and how its
    gradient goes back: the dimensions all-gathered (every split one but
    those of ``keep``, which the layer uses as stored: the model block it
    computes with, or the FSDP block that :func:`_fsdp` gathers in the
    compute dtype itself), and the ranks whose gradients of this rank's
    block are summed — the FSDP axes unless their block is kept (then
    :func:`_fsdp`'s backward sums them) and the model axis unless its
    block is kept (a rank outside that set adds exact zeros to the block
    in the replicated layout's sum over the mesh)."""

    def __init__(self, ctx: MeshContext, spec: Spec, shape,
                 keep: Tuple[int, ...] = ()):
        self.ctx = ctx
        split = leaf_split(ctx, spec, shape)
        fsdp, model = tuple(ctx.fsdp_axes), (ctx.model_axis,)
        kept = {split[d] for d in keep if split[d] is not None}
        # (axes, dim) of each gathered dimension, the FSDP one first (the
        # mesh's order)
        self.gather = sorted(((axes, d) for d, axes in enumerate(split)
                              if axes is not None and axes not in kept),
                             key=lambda ad: ad[0] != fsdp)
        self.sizes = [(C.axis_size(a, mesh=ctx.mesh), d)
                      for a, d in self.gather]
        self.reduce = tuple(a for axes in (fsdp, model) if axes not in kept
                            and C.axis_size(axes, mesh=ctx.mesh) > 1
                            for a in axes)

    @property
    def trivial(self) -> bool:
        return not self.gather and not self.reduce

    def materialize(self, block: torch.Tensor) -> torch.Tensor:
        """The all-gathered weight (no autograd)."""
        if not self.gather:
            return block
        axes = tuple(a for g, _ in self.gather for a in g)
        mesh = self.ctx.mesh
        n = C.axis_size(axes, mesh=mesh)
        stacked = C._gather(block.unsqueeze(0), C._group(mesh, axes), n, 0)
        # [k1, k2, *block] in rank order (row-major over the gathered
        # axes); each rank index moved in front of the dimension it splits
        # and merged with it: the blocks concatenated in rank order
        t = stacked.unflatten(0, tuple(k for k, _ in self.sizes))
        nk = len(self.sizes)
        at = {dim: (i, k) for i, (k, dim) in enumerate(self.sizes)}
        perm = [p for d in range(block.ndim)
                for p in ((at[d][0], nk + d) if d in at else (nk + d,))]
        return t.permute(perm).reshape(
            [s * at[d][1] if d in at else s for d, s in enumerate(
                block.shape)])

    def reduce_grad(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sum over :attr:`reduce`'s ranks (in
        rank order) of their gradients of the materialized weight."""
        if not self.reduce:
            return g
        mesh = self.ctx.mesh
        n = C.axis_size(self.reduce, mesh=mesh)
        group = C._group(mesh, self.reduce)
        if not self.gather:
            return C._sum(g, group, n)
        m = C.axis_size(self.ctx.model_axis, mesh=mesh) \
            if self.ctx.model_axis in self.reduce else 1
        fsdp = tuple(self.ctx.fsdp_axes)
        # the reduce group's rank k owns g's block (k // m) of a dimension
        # split over the FSDP axes and block (k % m) of one split over the
        # model axis: each split dimension unflattened into (blocks, b),
        # its block index moved to the front as [FSDP, model], an axis the
        # leaf is not split over broadcast, then [n, *block] in rank order
        split = {dim: size for (_, dim), (size, _) in zip(self.gather,
                                                          self.sizes)}
        t = g
        for dim in sorted(split, reverse=True):
            t = t.unflatten(dim, (split[dim], -1))
        # where each split dimension's block index now lies, by its axes
        pos = {"fsdp" if axes == fsdp else "model":
               dim + sum(d < dim for d in split) for axes, dim in self.gather}
        front = [pos[k] for k in ("fsdp", "model") if k in pos]
        t = t.movedim(front, list(range(len(front))))
        if "fsdp" not in pos:
            t = t.unsqueeze(0).expand(n // m, *t.shape)
        if "model" not in pos:
            t = t.unsqueeze(1).expand(t.shape[0], m, *t.shape[1:])
        regions = t.reshape((n,) + tuple(t.shape[2:]))
        return C._scatter_sum(regions, group, n, 0)[0]


class _Materialize(torch.autograd.Function):
    @staticmethod
    def forward(fctx, block, plan: _LeafPlan):
        fctx.plan = plan
        out = plan.materialize(block)
        return out.view_as(out) if out is block else out

    @staticmethod
    def backward(fctx, g):
        return fctx.plan.reduce_grad(g.contiguous()), None


def _kept_dims(cfg: ModelConfig, ctx: MeshContext) -> dict:
    """``{"<module>.<leaf>": dimensions}``: the dimensions of a layer's
    weight that the layer uses as this rank stores them, read from the
    rules the layers split by (:func:`_head_slices`, :func:`_model_slice`,
    :func:`_moe_ep`, :func:`_sp_sharded`): the model block it computes
    with, and the FSDP block of a weight it gathers through
    :func:`_fsdp` (the SP projections, the MoE's experts). The rest are
    materialized whole; :func:`_part` and :func:`_fsdp` raise where a
    weight is neither whole nor the block they expect."""
    sp = _sp_sharded(ctx)
    out = {}

    def keep(module, dims, model_on, fsdp_dims=None):
        for leaf, m in dims.items():
            d = ((m,) if model_on else ()) + (
                (fsdp_dims[leaf],) if fsdp_dims else ())
            out[f"{module}.{leaf}"] = d

    if cfg.n_heads:
        keep("attn", {"wq": 1, "wk": 1, "wv": 1, "wo": 0},
             _head_slices(cfg, ctx) is not None,
             sp and {"wq": 0, "wk": 0, "wv": 0, "wo": 2})
    if cfg.d_ff:
        keep("mlp", {"w_gate": 1, "w_up": 1, "w_down": 0},
             _model_slice(ctx, cfg.d_ff_pad) is not None,
             sp and {"w_gate": 0, "w_up": 0, "w_down": 1})
    if cfg.n_experts:
        ep = _moe_ep(cfg, ctx)
        keep("moe", {"w_gate": 0 if ep else 2, "w_up": 0 if ep else 2,
                     "w_down": 0 if ep else 1}, True,
             {"w_gate": 1, "w_up": 1, "w_down": 2})
    if cfg.ssm_heads:
        keep("block", {"out_proj": 0, "norm_scale": 0},
             _model_slice(ctx, cfg.ssm_heads) is not None)
    return out


class _Local:
    """A module read through this rank's materialized parameters: an
    attribute that names a parameter gives its tensor, a sub-module a view
    of it, anything else (a ``ModuleList``, None, a flag) the module's
    own."""

    def __init__(self, module: nn.Module, tensors: dict, prefix: str = ""):
        self.__dict__.update(_module=module, _tensors=tensors,
                             _prefix=prefix)

    def __getattr__(self, name: str):
        key = self._prefix + name
        if key in self._tensors:
            return self._tensors[key]
        v = getattr(self._module, name)
        if isinstance(v, nn.Module) and not isinstance(v, nn.ModuleList):
            return _Local(v, self._tensors, key + ".")
        return v


def is_blocks(module) -> bool:
    """Whether ``module``'s parameters are stored as blocks
    (:func:`shard_module`)."""
    if isinstance(module, _Local):
        return False
    p = next(module.parameters(), None)
    return p is not None and hasattr(p, "pspec")


def local_params(module, cfg: ModelConfig, ctx: Optional[MeshContext],
                 recurse: bool = True, kept: Optional[dict] = None):
    """``module`` read through this rank's working copies of its
    parameters: itself where they are replicated (or without a mesh),
    else a view whose tensors are materialized from the stored blocks
    (:class:`_LeafPlan`), keeping as stored the dimensions ``kept`` names
    (default :func:`_kept_dims`; ``recurse=False`` takes the module's own
    parameters only, as the model takes its embedding, head and final
    norm). A layer calls it on entry, so under remat the gathers run
    again in the recompute and a layer's whole weights live only while
    it runs."""
    if ctx is None or not is_blocks(module):
        return module
    if kept is None:
        kept = _kept_dims(cfg, ctx)
    tensors = {}
    for name, p in module.named_parameters(recurse=recurse):
        plan = _plan(p, ctx, kept.get(".".join(name.split(".")[-2:]), ()))
        tensors[name] = p if plan.trivial else _Materialize.apply(p, plan)
    return _Local(module, tensors)


def _plan(p: nn.Parameter, ctx: MeshContext, keep: Tuple[int, ...]
          ) -> _LeafPlan:
    """The block parameter ``p``'s plan on ``ctx``'s mesh, made once and
    kept on the parameter (a layer asks for it twice a step under
    remat)."""
    key = (id(ctx.mesh), tuple(ctx.fsdp_axes), ctx.model_axis, keep)
    plans = p.__dict__.setdefault("mesh_plans", {})
    if key not in plans:
        plans[key] = _LeafPlan(ctx, p.pspec, p.whole_shape, keep)
    return plans[key]


def shard_module(module: nn.Module, specs: dict, ctx: MeshContext
                 ) -> nn.Module:
    """A copy of ``module`` whose parameters are this rank's blocks of its
    parameters (``specs``: their specs by name), each a new parameter
    carrying ``pspec`` (its spec) and ``whole_shape``."""
    import copy

    memo = {}
    for name, p in module.named_parameters():
        blk = nn.Parameter(block_of(p.detach(), specs[name], ctx).clone(),
                           requires_grad=p.requires_grad)
        blk.pspec, blk.whole_shape = tuple(specs[name]), tuple(p.shape)
        memo[id(p)] = blk
    return copy.deepcopy(module, memo)


@torch.no_grad()
def whole_of(t: torch.Tensor, spec: Spec, shape, ctx: MeshContext
             ) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` (a collective: every
    rank calls it)."""
    return _LeafPlan(ctx, spec, shape).materialize(t.detach())


# ===========================================================================
# Primitives
# ===========================================================================

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with a ``(1 + scale)`` gain, computed in float32."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """``x [..., d] @ w [d, f]`` with ``w`` cast to the compute dtype."""
    return x @ w.to(dtype)


def _rope_table(head_dim: int, theta: float, device) -> torch.Tensor:
    """The reference's float64 frequencies, as float32, on ``device``."""
    f = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.as_tensor(f, dtype=torch.float32).to(device)


# made once a device: a host-to-device copy per call would stall the stream
_rope_freqs = functools.lru_cache(maxsize=None)(_rope_table)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotary embedding, split-halves convention. x: ``[..., S, H, hd]``;
    positions: ``[..., S]`` integer. A fake tensor's table is made anew
    (a cached one would outlive its fake mode)."""
    freqs = (_rope_table if is_fake(x) else _rope_freqs)(
        x.shape[-1], float(theta), x.device)
    ang = positions.float()[..., :, None, None] * freqs   # [..., S, 1, hd/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str):
    """``silu``, or ``gelu`` in its tanh approximation."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise KeyError(f"unknown activation {name!r}")


# ===========================================================================
# Attention
# ===========================================================================

class Attention(nn.Module):
    """Projections of one attention block over the padded head layout of
    ``cfg.gqa``: ``wq [D, Hq_pad, hd]``, ``wk``/``wv [D, Hkv_pad, hd]``,
    ``wo [Hq_pad, hd, D]``."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   dtype: torch.dtype, device=None) -> Attention:
    """Normal(0, 0.02) projections on ``device`` (default the generator's);
    the slots of padded (dummy) heads are zero, as in the reference."""
    pad = cfg.gqa
    D, hd = cfg.d_model, cfg.head_dim
    dev = generator.device if device is None else device

    def slot_mask(slot_to_orig):
        return torch.tensor([1.0 if o >= 0 else 0.0 for o in slot_to_orig],
                            dtype=dtype, device=dev)

    wq = _normal((D, pad.n_q_pad, hd), generator, dtype, device=dev) \
        * slot_mask(pad.q_slot_to_q)[None, :, None]
    wk = _normal((D, pad.n_kv_pad, hd), generator, dtype, device=dev) \
        * slot_mask(pad.kv_slot_to_kv)[None, :, None]
    wv = _normal((D, pad.n_kv_pad, hd), generator, dtype, device=dev) \
        * slot_mask(pad.kv_slot_to_kv)[None, :, None]
    wo = _normal((pad.n_q_pad, hd, D), generator, dtype, device=dev) \
        * slot_mask(pad.q_slot_to_q)[:, None, None]
    return Attention(wq, wk, wv, wo)


def _project_heads(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
                   ) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd).to(dtype)).unflatten(-1, (H, hd))


def attention_block(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    start: int, *, window: int,
                    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    = None, kv_len: Optional[torch.Tensor] = None,
                    ring: bool = False, use_kernel: Optional[bool] = None,
                    stash=None, ctx: Optional[MeshContext] = None):
    """qkv projection → rope → attention → output projection.

    x: ``[B, S, D]`` at positions ``start .. start + S - 1`` in every row
    (static batching keeps positions uniform across the batch, so they are
    a host int and addressing the cache needs no device sync). Without a
    cache this is a full-sequence forward. With ``kv_cache = (ck, cv)`` of
    ``[B, Sc, Hkv, hd]``:

    * ``S == 1`` is a decode step: the new k/v are written into slot
      ``start`` (``start % Sc`` in ring mode) **in place**, then the
      token attends the cache through ``decode_attention`` with ``kv_len``;
    * ``S > 1`` is a prefill: k/v fill the first S slots (in ring mode with
      ``S > Sc``, the last Sc positions, rolled so slot ``j`` holds position
      ``j mod Sc``), and the prompt attends itself.

    A write past the end of a non-ring cache raises :class:`ValueError`
    (the reference clamps it onto the last slot). A full-sequence forward
    under grad records its attention output, the reference's ``attn_out``
    (before the output projection), into ``stash`` (an
    :class:`~repro_torch.kernels.flash_attention.AttentionStash`) or, when
    that holds one already, takes it from there. Returns
    ``(out [B, S, D], (ck, cv))``; the cache tensors are the ones passed
    in, updated.

    With ``ctx`` (a bound :class:`MeshContext`) ``x`` is this rank's block
    of the residual stream and so is ``out``; without a cache ``(k, v)``
    are this rank's heads of the gathered sequence, with one the cache is
    this rank's block (``init_cache(ctx=...)``): its rows' slots of its KV
    heads, or, where ``ctx.kv_slots`` is set (decode at batch 1), its
    block of the slots, over which B7 runs and whose outputs are combined
    over the batch axes (:func:`_decode_step`).
    """
    if ctx is not None:
        return _attention_mesh(p, cfg, x, ctx, window, use_kernel, stash,
                               start, kv_cache, kv_len, ring)
    dt = torch_dtype(cfg.dtype)
    B, S = x.shape[:2]
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    q = apply_rope(_project_heads(x, p.wq, dt), positions, cfg.rope_theta)
    k = apply_rope(_project_heads(x, p.wk, dt), positions, cfg.rope_theta)
    v = _project_heads(x, p.wv, dt)

    if kv_cache is None:
        o = attention(q, k, v, causal=cfg.causal, window=window,
                      softcap=cfg.attn_softcap, use_kernel=use_kernel,
                      stash=stash)
        new_kv = (k, v)
    else:
        if S == 1:
            o = _decode_step(cfg, None, q, k, v, kv_cache, kv_len, start,
                             window, ring, use_kernel)
        else:
            _write_prompt(*kv_cache, k, v, start, ring)
            o = attention(q, k, v, causal=cfg.causal, window=window,
                          softcap=cfg.attn_softcap, use_kernel=use_kernel)
        new_kv = kv_cache

    H, hd, D = p.wo.shape
    out = o.flatten(-2) @ p.wo.reshape(H * hd, D).to(dt)
    return out, new_kv


def _holds(ck: torch.Tensor, k: torch.Tensor) -> None:
    """Raise where the cache (block) ``ck`` does not hold the rows and
    heads of ``k``."""
    if ck.shape[2] != k.shape[2] or ck.shape[0] != k.shape[0]:
        raise ValueError(f"a {tuple(ck.shape)} KV cache block does not hold "
                         f"{k.shape[0]} rows of {k.shape[2]} heads: it is "
                         "laid out for another mesh")


def _write_slot(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, start: int, ring: bool, slot0: int = 0,
                total: Optional[int] = None) -> None:
    """A decode step's k/v ``[B, 1, H, hd]`` into slot ``start``
    (``start % total`` in ring mode) of a ``total``-slot cache, in place,
    where that slot lies in the block ``ck``/``cv`` holds (slots ``slot0
    ..``; by default the whole cache)."""
    _holds(ck, k)
    Sc = ck.shape[1]
    total = Sc if total is None else total
    if not ring and start >= total:
        raise ValueError(
            f"decode at position {start} overruns the {total}-slot KV "
            "cache; allocate a longer cache (bucket_seq)")
    slot = (start % total if ring else start) - slot0
    if 0 <= slot < Sc:
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]


def _write_prompt(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, start: int, ring: bool) -> None:
    """A prefill's k/v ``[B, S, H, hd]`` into the cache from slot 0, in
    place: in ring mode with ``S > Sc`` the last Sc positions, rolled so
    slot ``j`` holds position ``j mod Sc``."""
    _holds(ck, k)
    Sc, S = ck.shape[1], k.shape[1]
    if ring and S > Sc:
        shift = (start + S - Sc) % Sc
        ck.copy_(torch.roll(k[:, -Sc:], shift, dims=1))
        cv.copy_(torch.roll(v[:, -Sc:], shift, dims=1))
    elif S > Sc:
        raise ValueError(f"a {S}-token prompt does not fit the "
                         f"{Sc}-slot KV cache")
    else:
        ck[:, :S] = k
        cv[:, :S] = v


def _head_slices(cfg: ModelConfig, ctx: MeshContext):
    """This model rank's query and KV head slots, or None where either
    count does not divide the model axis (then every model rank runs the
    whole block)."""
    q = _model_slice(ctx, cfg.gqa.n_q_pad)
    kv = _model_slice(ctx, cfg.gqa.n_kv_pad)
    return None if q is None or kv is None else (q, kv)


def _attention_mesh(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    ctx: MeshContext, window: int,
                    use_kernel: Optional[bool], stash, start: int = 0,
                    kv_cache=None, kv_len: Optional[torch.Tensor] = None,
                    ring: bool = False):
    """:func:`attention_block` on a mesh: the reference's mesh branches
    (``layers.py`` ``attention_block``), each rank's attention on its
    heads of its rows' gathered sequence; a prefill writes those heads'
    k/v (the SP projections' under ``sp_matmuls``) into the rank's cache
    block, a decode step writes its slot and attends the block."""
    dt = torch_dtype(cfg.dtype)
    heads = _head_slices(cfg, ctx)
    stream = ctx.stream()
    sp = _sp_sharded(ctx)
    if sp:
        _divides(ctx, "attention heads (q, kv)", cfg.gqa.n_q_pad,
                 cfg.gqa.n_kv_pad)
        x = cst(ctx, x, "batch", "model", None, frm=stream)
        q, k, v = sp_qkv(ctx, cfg, x, p.wq, p.wk, p.wv)
    else:
        x = cst(ctx, x, "batch", None, None, frm=stream)
        qs, kvs = heads if heads is not None else (None, None)
        nq, nkv = cfg.gqa.n_q_pad, cfg.gqa.n_kv_pad
        q = _project_heads(x, _part(p.wq, 1, nq, qs), dt)
        k = _project_heads(x, _part(p.wk, 1, nkv, kvs), dt)
        v = _project_heads(x, _part(p.wv, 1, nkv, kvs), dt)
    B, S = x.shape[0], q.shape[1]
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None and S == 1:
        o = _decode_step(cfg, ctx, q, k, v, kv_cache, kv_len, start, window,
                         ring, use_kernel)
    else:
        if kv_cache is not None:
            _write_prompt(*kv_cache, k, v, start, ring)
        o = attention(q, k, v, causal=cfg.causal, window=window,
                      softcap=cfg.attn_softcap, use_kernel=use_kernel,
                      stash=stash)
    if kv_cache is not None:
        k, v = kv_cache
    if sp:
        out = sp_out_proj(ctx, cfg, o, p.wo)
        return cst(ctx, out, *stream, frm=("batch", "model", None)), (k, v)
    wo = _part(p.wo, 0, cfg.gqa.n_q_pad, heads and heads[0])
    H, hd, D = wo.shape
    out = o.flatten(-2) @ wo.reshape(H * hd, D).to(dt)
    if heads is not None:
        out = C.psum(out, ctx.model_axis, mesh=ctx.mesh)
    return cst(ctx, out, *stream, frm=("batch", None, None)), (k, v)


def _decode_step(cfg: ModelConfig, ctx: Optional[MeshContext], q, k, v,
                 kv_cache, kv_len, start: int, window: int, ring: bool,
                 use_kernel: Optional[bool]) -> torch.Tensor:
    """A decode step's attention: ``q``/``k``/``v`` ``[B_rows, 1, H, hd]``
    (on a mesh this rank's heads) against the cache (this rank's block):
    the step's slot written, then B7. Where ``ctx.kv_slots`` lays the
    cache's slots over the batch axes, the rank
    holds slots ``[i·Sc, (i+1)·Sc)`` of the whole cache: it writes the
    step's slot if it is one of them, runs B7 on its block with the whole
    cache's valid range (``slot0``, ``sc_total``) and its logsumexp, and
    the ranks' outputs are all-gathered over the batch axes and combined
    in float32 in rank order (:func:`~repro_torch.kernels.gqa_decode
    .combine_blocks`). Returns ``[B_rows, 1, H, hd]``."""
    ck, cv = kv_cache
    kw = dict(window=window, ring=ring, softcap=cfg.attn_softcap,
              use_kernel=use_kernel)
    total = None if ctx is None else ctx.kv_slots
    n, i, axis = (1, 0, None) if total is None else \
        ctx.block(1, "batch", size=total)
    if n == 1:
        _write_slot(ck, cv, k, v, start, ring)
        return decode_attention(q[:, 0], ck, cv, kv_len, **kw)[:, None]
    Sc = ck.shape[1]
    if Sc * n != total:
        raise ValueError(f"a {Sc}-slot cache block is not one of {n} blocks "
                         f"of {total} slots")
    _write_slot(ck, cv, k, v, start, ring, i * Sc, total)
    o, lse = decode_attention(q[:, 0], ck, cv, kv_len, slot0=i * Sc,
                              sc_total=total, return_lse=True, **kw)
    outs = C.all_gather(o, axis, 0, tiled=False, mesh=ctx.mesh)
    lses = C.all_gather(lse, axis, 0, tiled=False, mesh=ctx.mesh)
    return combine_blocks(outs, lses)[:, None]


# ===========================================================================
# Dense MLP (SwiGLU / GeLU)
# ===========================================================================

class MLP(nn.Module):
    """``w_gate``/``w_up [D, F_pad]``, ``w_down [F_pad, D]``."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_param,
                                                  (w_gate, w_up, w_down))


def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype, device=None) -> MLP:
    D, F_ = cfg.d_model, cfg.d_ff_pad
    return MLP(_normal((D, F_), generator, dtype, device=device),
               _normal((D, F_), generator, dtype, device=device),
               _normal((F_, D), generator, dtype, device=device))


def mlp_block(p: MLP, cfg: ModelConfig, x: torch.Tensor,
              ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """SwiGLU/GeLU MLP. With ``ctx``: this rank's ``d_ff`` slice of its
    rows' gathered sequence, summed over the model axis back into the
    stream (:func:`sp_mlp` under SP); the whole MLP on every model rank
    where ``d_ff`` does not divide the axis."""
    dt = torch_dtype(cfg.dtype)
    if ctx is None:
        h = _act(cfg.act)(dense(x, p.w_gate, dt)) * dense(x, p.w_up, dt)
        return dense(h, p.w_down, dt)
    stream = ctx.stream()
    if _sp_sharded(ctx):
        _divides(ctx, "d_ff", cfg.d_ff_pad)
        x = cst(ctx, x, "batch", "model", None, frm=stream)
        out = sp_mlp(ctx, cfg, x, p.w_gate, p.w_up, p.w_down)
        return cst(ctx, out, *stream, frm=("batch", "model", None))
    x = cst(ctx, x, "batch", None, None, frm=stream)
    F_ = cfg.d_ff_pad
    f = _model_slice(ctx, F_)
    h = _act(cfg.act)(dense(x, _part(p.w_gate, 1, F_, f), dt)) \
        * dense(x, _part(p.w_up, 1, F_, f), dt)
    out = dense(h, _part(p.w_down, 0, F_, f), dt)
    if f is not None:
        out = C.psum(out, ctx.model_axis, mesh=ctx.mesh)
    return cst(ctx, out, *stream, frm=("batch", None, None))


# ===========================================================================
# Sequence-parallel (Megatron-SP) projections
# ===========================================================================

def sp_qkv(ctx: MeshContext, cfg: ModelConfig, x: torch.Tensor, wq, wk,
           wv):
    """x: this rank's ``[B/data, S/model, D]`` block → (q, k, v) of this
    rank's heads over its rows' whole sequence. The sequence all-gather
    is inside the differentiated region, so its backward is a
    reduce-scatter; the weights' FSDP shard is all-gathered too."""
    dt = torch_dtype(cfg.dtype)
    qs, kvs = _head_slices(cfg, ctx)
    nq, nkv, D = cfg.gqa.n_q_pad, cfg.gqa.n_kv_pad, cfg.d_model
    xg = C.all_gather(x, ctx.model_axis, 1, mesh=ctx.mesh)
    return tuple(_project_heads(
        xg, _fsdp(ctx, _part(w, 1, n, s).to(dt), 0, D), dt)
                 for w, n, s in ((wq, nq, qs), (wk, nkv, kvs),
                                 (wv, nkv, kvs)))


def sp_out_proj(ctx: MeshContext, cfg: ModelConfig, o: torch.Tensor, wo
                ) -> torch.Tensor:
    """o: ``[B/data, S, H/model, hd]`` → the residual delta's
    ``[B/data, S/model, D]`` block through an explicit psum_scatter."""
    dt = torch_dtype(cfg.dtype)
    qs, _ = _head_slices(cfg, ctx)
    wo_ = _fsdp(ctx, _part(wo, 0, cfg.gqa.n_q_pad, qs).to(dt), 2,
                cfg.d_model)
    H, hd, D = wo_.shape
    part = o.flatten(-2) @ wo_.reshape(H * hd, D)
    return C.psum_scatter(part, ctx.model_axis, 1, mesh=ctx.mesh)


def sp_mlp(ctx: MeshContext, cfg: ModelConfig, x: torch.Tensor, wg, wu,
           wd) -> torch.Tensor:
    """Fused SP MLP: gather the sequence once, this rank's ``d_ff`` slice,
    psum_scatter out."""
    dt = torch_dtype(cfg.dtype)
    F_ = cfg.d_ff_pad
    f = _model_slice(ctx, F_)
    xg = C.all_gather(x, ctx.model_axis, 1, mesh=ctx.mesh)
    D = cfg.d_model
    h = _act(cfg.act)(xg @ _fsdp(ctx, _part(wg, 1, F_, f).to(dt), 0, D)) \
        * (xg @ _fsdp(ctx, _part(wu, 1, F_, f).to(dt), 0, D))
    part = h @ _fsdp(ctx, _part(wd, 0, F_, f).to(dt), 1, D)
    return C.psum_scatter(part, ctx.model_axis, 1, mesh=ctx.mesh)


# ===========================================================================
# MoE (capacity-based, sort dispatch)
# ===========================================================================

class MoE(nn.Module):
    """The router ``[D, E]`` (float32) and the experts' ``w_gate``/``w_up
    [E, D, F_pad]`` and ``w_down [E, F_pad, D]``."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = map(
            _param, (router, w_gate, w_up, w_down))


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype, device=None) -> MoE:
    D, F_, E = cfg.d_model, cfg.d_ff_pad, cfg.n_experts
    return MoE(_normal((D, E), generator, torch.float32, device=device),
               _normal((E, D, F_), generator, dtype, device=device),
               _normal((E, D, F_), generator, dtype, device=device),
               _normal((E, F_, D), generator, dtype, device=device))


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity: lossless (``T·k``) for decode-sized batches of
    at most 256 assignment slots, else ``T·k·capacity_factor // E`` (at
    least 1), the reference's ``_moe_capacity``."""
    if n_tokens * cfg.top_k <= 256:
        return n_tokens * cfg.top_k
    return max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor
                      // cfg.n_experts))


class MoERouting(NamedTuple):
    """The routing of ``T`` tokens: ``gate``/``idx [T, k]`` (the top-k
    probabilities, normalised, and their experts, lower expert first on a
    tie), ``slot [T, k]`` (each assignment's row of the expert batches,
    ``n_slots = E · capacity`` where it is dropped) and ``kept [T, k]``
    (bool: not dropped for capacity)."""
    gate: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
              capacity: int) -> MoERouting:
    """Route ``x [T, D]``: float32 router logits, softmax, top-k by a
    stable descending sort (``lax.top_k``'s order: on a tie the lower
    expert first; ``torch.topk`` promises no order), gates divided by
    ``max(sum, 1e-9)``; then the assignments in token order, sorted stably
    by expert, take positions ``0, 1, …`` in their expert's batch, and
    those at or past ``capacity`` are dropped (the lower token index is
    kept)."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # a count of fixed size E (bincount's output size depends on the data)
    counts = torch.zeros(E, dtype=se.dtype, device=se.device
                         ).scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[se]
    kept = pos < capacity
    slot = torch.where(kept, se * capacity + pos,
                       torch.full_like(pos, E * capacity))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    return MoERouting(gate, idx, slot[inv].reshape(T, k),
                      kept[inv].reshape(T, k))


def moe_local(x: torch.Tensor, p: MoE, cfg: ModelConfig, capacity: int
              ) -> torch.Tensor:
    """The reference's ``_moe_local`` over every expert (one device):
    gather each expert's tokens into ``[E, capacity, D]`` batches through a
    slot → token map (the dump slot ``n_slots`` is discarded), the expert
    products as batched products in the compute dtype, and the combine
    ``out = out + y[slot_j] · g_j`` for j = 0..k−1 in that dtype, in the
    reference's order. x: ``[T, D]``."""
    return _moe_experts(x, p.router, p.w_gate, p.w_up, p.w_down, cfg,
                        capacity, 0, cfg.n_experts)


def _moe_experts(x: torch.Tensor, router: torch.Tensor, w_gate, w_up,
                 w_down, cfg: ModelConfig, capacity: int, e0: int,
                 n_local: int) -> torch.Tensor:
    """Route ``x [T, D]`` over every expert, then compute experts ``[e0,
    e0 + n_local)`` (``w_gate``/``w_up [n_local, D, F]``, ``w_down
    [n_local, F, D]``, perhaps a ``d_ff`` slice of each): the reference's
    ``_moe_local`` with its ``e0``/``n_local``. An assignment to another
    expert, or dropped for capacity, goes to the dump slot; the output is
    this rank's term of the sum over the model axis."""
    T, D = x.shape
    k = cfg.top_k
    dt = x.dtype
    r = moe_route(x, router, cfg, capacity)
    n_slots = n_local * capacity
    local = r.kept & (r.idx >= e0) & (r.idx < e0 + n_local)
    slot = torch.where(local, r.slot - e0 * capacity,
                       torch.full_like(r.slot, n_slots))
    flat_slot = slot.reshape(-1)
    slot_token = torch.zeros(n_slots + 1, dtype=torch.long, device=x.device)
    slot_token[flat_slot] = torch.arange(T, device=x.device
                                         ).repeat_interleave(k)
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=x.device)
    slot_valid[flat_slot] = local.reshape(-1)
    xb = (x[slot_token[:-1]] * slot_valid[:-1, None].to(dt)
          ).reshape(n_local, capacity, D)
    h = _act(cfg.act)(torch.bmm(xb, w_gate.to(dt))) \
        * torch.bmm(xb, w_up.to(dt))
    yb = torch.bmm(h, w_down.to(dt)).reshape(n_slots, D)
    yb = torch.cat([yb, yb.new_zeros(1, D)])
    weight = r.gate.to(dt) * local.to(dt)
    out = torch.zeros(T, D, dtype=dt, device=x.device)
    for j in range(k):
        out = out + yb[slot[:, j]] * weight[:, j:j + 1]
    return out


def _moe_ep(cfg: ModelConfig, ctx: MeshContext) -> bool:
    """Whether the mesh MoE shards its experts over the model axis (ep),
    else every expert's ``d_ff`` (tp)."""
    return cfg.n_experts % ctx.model_size == 0


def moe_block(p: MoE, cfg: ModelConfig, x: torch.Tensor,
              ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """MoE FFN of ``x [B, S, D]``; without ``ctx`` on one device, capacity
    from the ``B·S`` tokens (the reference's ``moe_block`` with
    ``ctx=None``). With ``ctx`` (``x`` this rank's stream block), the
    reference's ``shard_map`` body in one of two modes:

    * **ep** (``n_experts % model_size == 0``): this model rank computes
      experts ``[i·E/m, (i+1)·E/m)``;
    * **tp** (otherwise): every expert, this rank's ``d_ff`` slice.

    Either way the rank routes its rows' gathered sequence over every
    expert, with the capacity of its ``T_local`` tokens (the whole batch
    when the global batch does not divide the data axes: the routing is
    then replicated over them), casts and all-gathers the FSDP weight
    shard, and sums the outputs over the model axis: a ``psum_scatter``
    into the stream under SP, else a ``psum``."""
    B_, S_, D = x.shape
    if ctx is None:
        out = moe_local(x.reshape(-1, D), p, cfg, moe_capacity(B_ * S_, cfg))
        return out.reshape(B_, S_, D)
    dt = torch_dtype(cfg.dtype)
    B, S = ctx.shape
    m, E = ctx.model_size, cfg.n_experts
    ep_mode = _moe_ep(cfg, ctx)
    n_local = E // m if ep_mode else E
    shardable = B % ctx.data_size == 0
    T_local = (B * S) // ctx.data_size if shardable else B * S
    capacity = moe_capacity(T_local, cfg)
    sp = ctx.sp_matmuls and shardable and S % m == 0
    stream = ctx.stream()
    xl = cst(ctx, x, "batch", None, None, frm=stream)
    if ep_mode:
        e0 = ctx.model_index * n_local
        es = slice(e0, e0 + n_local)
        gw, uw, dw = (_part(w, 0, E, es)
                      for w in (p.w_gate, p.w_up, p.w_down))
    else:
        e0 = 0
        F_ = cfg.d_ff_pad
        _divides(ctx, "MoE d_ff", F_)
        f = _model_slice(ctx, F_)
        gw, uw, dw = (_part(p.w_gate, 2, F_, f), _part(p.w_up, 2, F_, f),
                      _part(p.w_down, 1, F_, f))
    gw, uw = (_fsdp(ctx, w.to(dt), 1, D) for w in (gw, uw))
    dw = _fsdp(ctx, dw.to(dt), 2, D)
    out = _moe_experts(xl.reshape(-1, D), p.router, gw, uw, dw, cfg,
                       capacity, e0, n_local).reshape(xl.shape)
    if sp:
        out = C.psum_scatter(out, ctx.model_axis, 1, mesh=ctx.mesh)
        return cst(ctx, out, *stream, frm=("batch", "model", None))
    out = C.psum(out, ctx.model_axis, mesh=ctx.mesh)
    return cst(ctx, out, *stream, frm=("batch", None, None))


# ===========================================================================
# Mamba2 (SSD — state-space duality, chunked)
# ===========================================================================

class Mamba(nn.Module):
    """One Mamba2 block: ``in_proj [D, 2·din + 2N + H]``, the depthwise
    causal conv ``conv_w [cw, din + 2N]`` and ``conv_b``, float32 ``A_log``,
    ``D_skip`` and ``dt_bias [H]``, the gated norm's ``norm_scale [din]``
    and ``out_proj [din, D]``."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D_skip, dt_bias,
                 norm_scale, out_proj):
        super().__init__()
        (self.in_proj, self.conv_w, self.conv_b, self.A_log, self.D_skip,
         self.dt_bias, self.norm_scale, self.out_proj) = map(
            _param, (in_proj, conv_w, conv_b, A_log, D_skip, dt_bias,
                     norm_scale, out_proj))


def init_mamba(cfg: ModelConfig, generator: torch.Generator,
               dtype: torch.dtype, device=None) -> Mamba:
    """Normal(0, 0.02) projections and conv, zero conv bias and norm scale;
    ``A_log = log(linspace(1, 16, H))`` and ``dt_bias`` the inverse softplus
    of ``linspace(1e-3, 0.1, H)``, as in the reference. On ``device``
    (default the generator's)."""
    D = cfg.d_model
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * N
    dev = generator.device if device is None else device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return Mamba(
        _normal((D, 2 * din + 2 * N + H), generator, dtype, device=dev),
        _normal((cfg.conv_width, conv_ch), generator, dtype, device=dev),
        torch.zeros(conv_ch, dtype=dtype, device=dev),
        f32(np.log(np.linspace(1.0, 16.0, H).astype(np.float32))),
        torch.ones(H, dtype=torch.float32, device=dev),
        f32(np.log(np.expm1(np.linspace(1e-3, 0.1, H)))),
        torch.zeros(din, dtype=dtype, device=dev),
        _normal((din, D), generator, dtype, device=dev))


def ssd_decode_step(x: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, state: torch.Tensor):
    """One-token SSD recurrence. x ``[b, h, p]``, dtA ``[b, h]``, B/C ``[b,
    n]``, state ``[b, h, p, n]``. Returns ``(y [b, h, p], state)``."""
    decay = torch.exp(dtA)[..., None, None]
    state = state * decay + torch.einsum("bn,bhp->bhpn", B, x)
    y = torch.einsum("bn,bhpn->bhp", C, state)
    return y, state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` at every x (torch's
    ``softplus`` turns into the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_block(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                use_kernel: Optional[bool] = None,
                ctx: Optional[MeshContext] = None):
    """Mamba2 block. x: ``[B, S, D]``. ``cache = (conv_state [B, cw-1,
    ch], ssm_state [B, H, P, N] float32)`` continues a sequence; ``None``
    starts one. ``S > 1`` (or no cache) scans the sequence through the SSD
    dispatcher from the cache's state; ``S == 1`` with a cache is a decode
    step. Returns ``(out [B, S, D], (new_conv, new_ssm))``; the cache
    tensors passed in are not modified.

    With ``ctx`` ``x`` and ``out`` are this rank's stream blocks, the
    cache (if any) is this rank's block (``init_cache(ctx=...)``), and the
    block runs on its rows' gathered sequence. Where the SSM heads divide
    the model axis, this model rank computes heads ``[i · H/m, (i+1) ·
    H/m)`` (the reference's constraints on ``z``, ``xBC``, ``dt`` and
    ``xin``, and its ``("data", "model")`` split of ``in_proj``): its
    columns of ``z``, of ``xBC``'s ``x`` part and of ``dt``, its ``N/m``
    columns of ``B`` and of ``C`` (whole where ``N`` does not divide the
    axis), the conv and SiLU of those channels, then ``B``/``C``
    all-gathered over the model axis in rank order (replicated, as the
    reference keeps them for the scan; the gather's backward
    reduce-scatters their gradients), the scan of its heads with
    ``D_skip``, the gated norm with its sum of squares over ``d_inner`` a
    psum over the model axis, and its rows of ``out_proj``, summed over
    the model axis into the stream (a psum and a slice, or a
    psum_scatter under SP). The cache and the new cache are those of its
    channels and heads: the conv state of its ``[x | B | C]`` channels
    (:func:`mamba_channels`), the SSM state of its heads. Elsewhere the
    block runs whole on every model rank, with the whole cache."""
    if ctx is not None:
        return _mamba_mesh(p, cfg, x, ctx, use_kernel, cache)
    return _mamba_heads(p, cfg, x, cache, use_kernel)


def mamba_channels(cfg: ModelConfig, ctx: MeshContext
                   ) -> Optional[Tuple[Tuple[int, bool], ...]]:
    """The conv channels ``[x | B | C]`` of a Mamba block on ``ctx``'s
    mesh as ``((d_inner, True), (N, split), (N, split))``: each group's
    whole size and whether each model rank keeps its ``1/model`` of it
    (``B``/``C`` where ``N`` divides the axis); a rank's channels are its
    part of each group in this order. None where the SSM heads do not
    divide the axis: every rank keeps every channel."""
    if _model_slice(ctx, cfg.ssm_heads) is None:
        return None
    split = _model_slice(ctx, cfg.ssm_state) is not None
    return ((cfg.d_inner, True), (cfg.ssm_state, split),
            (cfg.ssm_state, split))


def _gather_bc(ctx: MeshContext, Bl: torch.Tensor, Cl: torch.Tensor):
    """The whole ``B``/``C`` ``[b, S, N]`` from every model rank's ``N/m``
    columns, in rank order: one all-gather of both (its backward sums the
    ranks' gradients of each block in rank order)."""
    nb = Bl.shape[-1]
    g = C.all_gather(torch.cat([Bl, Cl], -1), ctx.model_axis, -2,
                     tiled=False, mesh=ctx.mesh)        # [b, S, m, 2nb]
    return g[..., :nb].flatten(-2), g[..., nb:].flatten(-2)


def _mamba_mesh(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                ctx: MeshContext, use_kernel: Optional[bool], cache=None):
    """:func:`mamba_block` on a mesh."""
    stream = ctx.stream()
    x = cst(ctx, x, "batch", None, None, frm=stream)
    H, hp = cfg.ssm_heads, cfg.ssm_head_dim
    hs = _model_slice(ctx, H)
    groups = mamba_channels(cfg, ctx)
    if cache is not None:
        heads = H if hs is None else hs.stop - hs.start
        chans = sum(n // ctx.model_size if split else n
                    for n, split in groups) if groups else \
            cfg.d_inner + 2 * cfg.ssm_state
        if cache[1].shape[:2] != (x.shape[0], heads) or \
                cache[0].shape[-1] != chans:
            raise ValueError(f"a {tuple(cache[0].shape)} conv and "
                             f"{tuple(cache[1].shape)} SSM cache block do "
                             f"not hold {x.shape[0]} rows of {chans} "
                             f"channels and {heads} heads: they are laid "
                             "out for another mesh")
    if hs is None:
        out, new_cache = _mamba_heads(p, cfg, x, cache, use_kernel)
        return cst(ctx, out, *stream, frm=("batch", None, None)), new_cache
    din, N = cfg.d_inner, cfg.ssm_state
    ch = slice(hs.start * hp, hs.stop * hp)      # this rank's d_inner
    bc = _model_slice(ctx, N) or slice(0, N)     # this rank's B/C columns

    def at(off: int, s: slice) -> slice:
        return slice(off + s.start, off + s.stop)

    # this rank's [z | x | B | C | dt] columns of in_proj, [x | B | C]
    # conv channels
    cols = (ch, at(din, ch), at(2 * din, bc), at(2 * din + N, bc),
            at(2 * din + 2 * N, hs))
    chans = (ch, at(din, bc), at(din + N, bc))
    w = dict(in_proj=torch.cat([p.in_proj[:, c] for c in cols], 1),
             conv_w=torch.cat([p.conv_w[:, c] for c in chans], 1),
             conv_b=torch.cat([p.conv_b[c] for c in chans]),
             A_log=p.A_log[hs], D_skip=p.D_skip[hs], dt_bias=p.dt_bias[hs],
             norm_scale=_part(p.norm_scale, 0, din, ch),
             out_proj=_part(p.out_proj, 0, din, ch))
    out, new_cache = _mamba_heads(
        _Local(p, w), cfg, x, cache, use_kernel,
        sumsq=lambda t: C.psum(t, ctx.model_axis, mesh=ctx.mesh),
        gather_bc=functools.partial(_gather_bc, ctx)
        if groups[1][1] and ctx.model_size > 1 else None)
    if _sp_sharded(ctx):
        out = C.psum_scatter(out, ctx.model_axis, 1, mesh=ctx.mesh)
        return cst(ctx, out, *stream, frm=("batch", "model", None)), \
            new_cache
    out = C.psum(out, ctx.model_axis, mesh=ctx.mesh)
    return cst(ctx, out, *stream, frm=("batch", None, None)), new_cache


def _mamba_heads(p, cfg: ModelConfig, x: torch.Tensor, cache,
                 use_kernel: Optional[bool], sumsq=None, gather_bc=None):
    """The Mamba2 block on the heads ``p``'s weights hold (``A_log``'s
    length; every head on one device) and the ``B``/``C`` columns they
    hold (``conv_w``'s channels past ``d_inner``): ``sumsq`` sums the gated
    norm's sums of squares over the ranks that hold the other heads (None:
    this block holds all of ``d_inner``), ``gather_bc`` makes the whole
    ``B``/``C`` of this block's columns of them (None: they are whole)."""
    dt_ = torch_dtype(cfg.dtype)
    Bsz, S, _ = x.shape
    hp = cfg.ssm_head_dim
    H = p.A_log.shape[0]
    din = H * hp
    conv_ch = p.conv_w.shape[1]
    nb = (conv_ch - din) // 2

    zxbcdt = dense(x, p.in_proj, dt_)
    z, xBC, dt = torch.split(zxbcdt, [din, conv_ch, H], dim=-1)
    dt = _softplus(dt.float() + p.dt_bias.float())              # [B,S,H]

    cw = cfg.conv_width
    if cache is None:
        xpad = F.pad(xBC, (0, 0, cw - 1, 0))
    else:
        xpad = torch.cat([cache[0].to(dt_), xBC], dim=1)
    new_conv = xpad[:, xpad.shape[1] - (cw - 1):] if cw > 1 else \
        torch.zeros((Bsz, 0, conv_ch), dtype=dt_, device=x.device)
    # the depthwise causal conv as the reference writes it: a sum of
    # shifted slices in order (F.conv1d would run f32 through cuDNN's TF32)
    conv = sum(xpad[:, i:i + S] * p.conv_w[i].to(dt_)[None, None]
               for i in range(cw))
    xBC = F.silu(conv + p.conv_b.to(dt_))

    xin, Bmat, Cmat = torch.split(xBC, [din, nb, nb], dim=-1)
    if gather_bc is not None:
        Bmat, Cmat = gather_bc(Bmat, Cmat)
    xin = xin.reshape(Bsz, S, H, hp)
    A = -torch.exp(p.A_log.float())                             # [H]
    dtA = dt * A                                                # [B,S,H]
    Xd = xin * dt.to(dt_)[..., None]

    if cache is None or S > 1:
        init = cache[1].float() if cache is not None else None
        Y, final_state = ssd(Xd.float(), dtA, Bmat.float(), Cmat.float(),
                             chunk=cfg.ssm_chunk, initial_state=init,
                             use_kernel=use_kernel)
    else:
        y1, final_state = ssd_decode_step(
            Xd[:, 0].float(), dtA[:, 0], Bmat[:, 0].float(),
            Cmat[:, 0].float(), cache[1].float())
        Y = y1[:, None]

    Y = Y.to(dt_) + xin * p.D_skip.to(dt_)[None, None, :, None]
    Y = Y.reshape(Bsz, S, din) * F.silu(z)
    if sumsq is None:
        Y = rms_norm(Y, p.norm_scale, cfg.norm_eps)
    else:
        # the norm over d_inner = every rank's heads: its sum of squares
        # summed over them, each rank scaling its own slice
        yf = Y.float()
        ms = sumsq(yf.pow(2).sum(-1, keepdim=True)) / cfg.d_inner
        Y = (yf * torch.rsqrt(ms + cfg.norm_eps)
             * (1.0 + p.norm_scale.float())).to(Y.dtype)
    out = dense(Y, p.out_proj, dt_)
    return out, (new_conv.to(dt_), final_state.float())
