"""Training step factory: the port of ``repro.training.trainer``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``:
the loss's gradients by autograd (through the flash-attention backward
kernels B5/B6 and the SSD scan's backward kernel on a CUDA device),
microbatch gradient accumulation, an optional gradient transform, then
:func:`adamw_update_`. Its phases are obs spans (``train.step`` around
the step; ``train.forward`` and ``train.backward`` around each
microbatch's loss and its backward; ``train.optimizer`` around the global
norm and AdamW), on the ``torch.profiler`` timeline whenever a profiler
collects. The parameters live in the state's
:class:`~repro_torch.models.LM`, and they and the optimizer moments are
updated in place, leaf by leaf and block by block (the reference returns
new arrays). Each parameter's ``.grad`` holds the step's (averaged)
gradient until the next step clears it.

With a :class:`~repro_torch.models.layers.MeshContext` (bound to the
global batch's ``(B, S)`` by :func:`~repro_torch.models.transformer
.shard_batch`) the step runs in every rank of the mesh on that rank's
blocks of the batch (with ``grad_accum``, its block of each microbatch in
turn: ``shard_batch(..., grad_accum=...)``), and takes the training state
in one of two layouts, giving it back in the same one:

* **replicated** (as :func:`init_train_state` makes it, and as the
  reference's ``run_training`` jits its step without state shardings):
  every rank holds the full parameters and moments; each rank's backward
  gives its share of each gradient (its tokens, its heads, its experts),
  every leaf is summed over the whole mesh in rank order, in buckets of
  :data:`REDUCE_BUCKET` elements, and the ranks' parameters stay
  bit-identical;
* **blocks** (:func:`shard_train_state`, the counterpart of placing the
  state on ``NamedSharding(mesh, train_state_pspecs(cfg))``, as the
  reference's ``specs.py`` jits its step): every rank holds its block of
  each parameter and moment; each layer all-gathers its weights on entry
  and the gathers' backward leaves every rank its block's gradient summed
  over the ranks in rank order (:func:`~repro_torch.models.layers
  .local_params`), so the blocks are the same blocks of the replicated
  step's gradient; AdamW updates the blocks, with the global norm of the
  whole gradients (:func:`sharded_grad_norm`), and the blocks stay the
  same bits as the replicated state's.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshContext

from .optimizer import (AdamWConfig, AdamWState, adamw_init,
                        adamw_state_pspecs, adamw_update_)

__all__ = ["TrainState", "gather_train_state",
           "init_train_state", "make_grad_and_apply", "make_train_step",
           "param_tree", "shard_train_state", "sharded_grad_norm",
           "state_bytes", "train_state_pspecs"]

Batch = Dict[str, torch.Tensor]

#: Elements of one gradient reduction over the mesh: the leaves, in order,
#: go into flat buckets of at most this many elements (a larger leaf
#: alone), one psum a bucket (a psum a leaf made ~600 exchanges a
#: smollm-360m step).
REDUCE_BUCKET = 2 ** 26


class TrainState(NamedTuple):
    params: T.LM
    opt: AdamWState


def param_tree(model: T.LM) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` in the model's fixed order (the optimizer's
    tree, and the checkpoint's leaf order)."""
    return dict(model.named_parameters())


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator, device=None) -> TrainState:
    """Random parameters from ``generator`` on ``device`` (default the
    generator's) and zero AdamW state."""
    model = T.init_params(cfg, generator, device)
    return TrainState(model, adamw_init(param_tree(model), opt_cfg))


def train_state_pspecs(cfg: ModelConfig) -> TrainState:
    """The reference's ``train_state_pspecs``: the parameters' spec tree
    (:func:`~repro_torch.models.transformer.param_pspecs`) and the AdamW
    state's, tuples of axis names."""
    pspecs = T.param_pspecs(cfg)
    return TrainState(params=pspecs, opt=adamw_state_pspecs(pspecs))


def shard_train_state(state: TrainState, cfg: ModelConfig,
                      ctx: MeshContext) -> TrainState:
    """This rank's blocks of a replicated ``state``, laid out as
    :func:`train_state_pspecs` says (:func:`~repro_torch.models.layers
    .leaf_split`: a ``"data"`` dimension split over ``ctx.fsdp_axes``, a
    ``"model"`` one over the model axis, a size that does not divide its
    axis whole): a new model whose parameters are the blocks (each
    carrying ``pspec`` and ``whole_shape``) and the moments' blocks; the
    step is kept. Every rank calls it with the same state."""
    specs = T.leaf_pspecs(state.params, cfg)
    model = L.shard_module(state.params, specs, ctx)

    def blocks(tree):
        return {n: L.block_of(t, specs[n], ctx).clone()
                for n, t in tree.items()}

    return TrainState(model, AdamWState(state.opt.step.clone(),
                                        blocks(state.opt.m),
                                        blocks(state.opt.v)))


def gather_train_state(state: TrainState, ctx: MeshContext) -> TrainState:
    """The replicated state of :func:`shard_train_state`'s blocks: whole
    parameters (a new model) and moments on every rank, leaf by leaf (a
    collective: every rank calls it)."""
    import copy

    params = param_tree(state.params)

    def whole(n, t):
        # a leaf split over no axis comes back as the block itself: copy it
        w = L.whole_of(t, params[n].pspec, params[n].whole_shape, ctx)
        return w.clone() if w.data_ptr() == t.data_ptr() else w

    model = copy.deepcopy(state.params, {
        id(p): torch.nn.Parameter(whole(n, p), requires_grad=p.requires_grad)
        for n, p in params.items()})

    def gathered(tree):
        return {n: whole(n, t) for n, t in tree.items()}

    return TrainState(model, AdamWState(state.opt.step.clone(),
                                        gathered(state.opt.m),
                                        gathered(state.opt.v)))


def state_bytes(state: TrainState) -> int:
    """Bytes of the parameters and moments this rank holds."""
    return sum(t.numel() * t.element_size() for t in (
        *param_tree(state.params).values(), *state.opt.m.values(),
        *state.opt.v.values()))


@torch.no_grad()
def sharded_grad_norm(grads: Dict[str, torch.Tensor], params: Dict,
                      ctx: MeshContext) -> torch.Tensor:
    """The global norm of a sharded state's gradients, as
    :func:`~.optimizer.global_norm` takes it over whole leaves: each
    leaf's blocks gathered whole in turn (one leaf on the device at a
    time), its sum of squares, summed over the leaves in order, so every
    rank holds the replicated step's bits. A sum of the blocks' own sums
    of squares differs from it in the order of the terms by an ulp, and
    AdamW's clip scales every update by it: after three steps blocks of
    gradients near zero read 7e-6 of their leaf's largest value off the
    replicated state (mixtral's smoke config at (4, 1)). Its cost, every
    step: one all-gather a leaf, each rank receiving every float32
    gradient whole (4 bytes a parameter) — as much as the replicated
    step's reduction moves — though only one leaf is whole at a time."""
    total = None
    for n, p in params.items():
        whole = L.whole_of(grads[n], p.pspec, p.whole_shape, ctx)
        sq = torch.sum(torch.square(whole.to(torch.float32)))
        total = sq if total is None else total + sq
        del whole
    return torch.sqrt(total)


def _grads(model: T.LM, cfg: ModelConfig, batch: Batch, grad_accum: int,
           ctx: Optional[MeshContext] = None) -> Tuple[torch.Tensor, Dict]:
    """Mean loss and gradients over ``grad_accum`` equal microbatches (the
    leading axis split in order), accumulated in ``.grad`` and divided
    once, as the reference sums and divides. With ``ctx`` (bound to the
    global ``(B, S)``) ``batch`` is this rank's blocks, its rows its block
    of each microbatch of ``B / grad_accum`` rows in turn
    (``shard_batch(..., grad_accum=...)``), and each gradient is summed
    over the mesh before the division."""
    for p in model.parameters():
        p.grad = None
    n = next(iter(batch.values())).shape[0]
    if n % grad_accum:
        raise ValueError(f"batch of {n} does not split into {grad_accum} "
                         "microbatches")
    per = n // grad_accum
    if ctx is not None:
        B, S = T._bound(ctx).shape
        if B % grad_accum:
            raise ValueError(f"a global batch of {B} rows does not split "
                             f"into {grad_accum} microbatches")
        ctx = ctx.at(B // grad_accum, S)
    loss = None
    for i in range(grad_accum):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        with obs.span("train.forward"):
            l = T.loss_fn(model, cfg, mb, ctx=ctx)
        with obs.span("train.backward"):
            l.backward()
        loss = l.detach() if loss is None else loss + l.detach()
    params = dict(model.named_parameters())
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    if ctx is not None and not L.is_blocks(model):
        _mesh_sum_(grads, ctx)
        for n, p in params.items():
            p.grad = grads[n]
    if grad_accum > 1:
        for g in grads.values():
            g /= grad_accum
    return (loss / grad_accum if grad_accum > 1 else loss), grads


def _mesh_sum_(grads: Dict[str, torch.Tensor], ctx: MeshContext) -> None:
    """Replace each gradient by its sum over every axis of the mesh (in
    rank order, so every rank gets the same bits), bucket by bucket
    (:data:`REDUCE_BUCKET`); the new gradients are views of the summed
    buckets."""
    names = list(grads)
    i = 0
    while i < len(names):
        dt, n, j = grads[names[i]].dtype, 0, i
        while j < len(names) and grads[names[j]].dtype == dt and (
                j == i or n + grads[names[j]].numel() <= REDUCE_BUCKET):
            n += grads[names[j]].numel()
            j += 1
        flat = torch.cat([grads[k].reshape(-1) for k in names[i:j]])
        total = C.psum(flat, ctx.mesh_axes, mesh=ctx.mesh)
        del flat
        off = 0
        for k in names[i:j]:
            size = grads[k].numel()
            grads[k] = total[off:off + size].view(grads[k].shape)
            off += size
        i = j


def _apply(grads: Dict, state: TrainState, opt_cfg: AdamWConfig,
           ctx: Optional[MeshContext] = None):
    with obs.span("train.optimizer"):
        params = param_tree(state.params)
        norm = sharded_grad_norm(grads, params, ctx) \
            if L.is_blocks(state.params) else None
        new_opt, metrics = adamw_update_(grads, state.opt, params, opt_cfg,
                                         grad_norm=norm)
    return TrainState(state.params, new_opt), metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    ctx: Optional[MeshContext] = None,
                    grad_accum: int = 1,
                    grad_transform: Optional[Callable] = None):
    """``step(state, batch) -> (state, metrics)`` with ``metrics`` holding
    ``loss``, ``grad_norm`` and ``lr`` as device scalars. ``grad_accum >
    1`` averages the gradients of that many microbatches;
    ``grad_transform`` maps the gradient dictionary before the optimizer
    (the hook for gradient compression). With ``ctx`` (bound by
    ``shard_batch``) the step is called in every rank with its blocks of
    the batch, on a replicated state or one of :func:`shard_train_state`'s,
    which it gives back in its layout; the loss is the global one.
    ``grad_transform`` maps whole gradients, so a state stored as blocks
    refuses it."""

    def step(state: TrainState, batch: Batch):
        if grad_transform is not None and L.is_blocks(state.params):
            raise ValueError("grad_transform maps whole gradients; a state "
                             "stored as blocks (shard_train_state) holds "
                             "this rank's blocks of them")
        with obs.span("train.step"):
            loss, grads = _grads(state.params, cfg, batch, grad_accum, ctx)
            if grad_transform is not None:
                grads = grad_transform(grads)
            state, metrics = _apply(grads, state, opt_cfg, ctx)
        metrics["loss"] = loss
        return state, metrics

    return step


def make_grad_and_apply(cfg: ModelConfig, opt_cfg: AdamWConfig,
                        ctx: Optional[MeshContext] = None):
    """The step split in two for host-side gradient transforms:
    ``grad_fn(model, batch) -> (loss, grads)`` and ``apply_fn(grads,
    state) -> (state, metrics)``; with ``ctx`` (bound by ``shard_batch``)
    ``grad_fn`` takes this rank's blocks of the batch and the gradients
    are the mesh-summed ones (a sharded state's: this rank's blocks of
    them)."""

    def grad_fn(model: T.LM, batch: Batch):
        return _grads(model, cfg, batch, 1, ctx)

    def apply_fn(grads: Dict, state: TrainState):
        return _apply(grads, state, opt_cfg, ctx)

    return grad_fn, apply_fn
