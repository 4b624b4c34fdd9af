"""Training step factory: the port of ``repro.training.trainer``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``:
the loss's gradients by autograd (through the flash-attention backward
kernels B5/B6 on a CUDA device), microbatch gradient accumulation, an
optional gradient transform, then :func:`adamw_update`. The parameters
live in the state's :class:`~repro_torch.models.LM` and are updated in
place (the reference returns new arrays); the optimizer moments are
replaced. Each parameter's ``.grad`` holds the step's (averaged) gradient
until the next step clears it.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_grad_and_apply",
           "make_train_step", "param_tree"]

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: T.LM
    opt: AdamWState


def param_tree(model: T.LM) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` in the model's fixed order (the optimizer's
    tree, and the checkpoint's leaf order)."""
    return dict(model.named_parameters())


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator) -> TrainState:
    """Random parameters from ``generator`` (on its device) and zero
    AdamW state."""
    model = T.init_params(cfg, generator)
    return TrainState(model, adamw_init(param_tree(model), opt_cfg))


def _grads(model: T.LM, cfg: ModelConfig, batch: Batch, grad_accum: int
           ) -> Tuple[torch.Tensor, Dict]:
    """Mean loss and gradients over ``grad_accum`` equal microbatches (the
    leading axis split in order), accumulated in ``.grad`` and divided
    once, as the reference sums and divides."""
    for p in model.parameters():
        p.grad = None
    n = next(iter(batch.values())).shape[0]
    if n % grad_accum:
        raise ValueError(f"batch of {n} does not split into {grad_accum} "
                         "microbatches")
    per = n // grad_accum
    loss = None
    for i in range(grad_accum):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        l = T.loss_fn(model, cfg, mb)
        l.backward()
        loss = l.detach() if loss is None else loss + l.detach()
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if grad_accum > 1:
            g /= grad_accum
        grads[name] = g
    return (loss / grad_accum if grad_accum > 1 else loss), grads


def _apply(grads: Dict, state: TrainState, opt_cfg: AdamWConfig):
    new_params, new_opt, metrics = adamw_update(
        grads, state.opt, param_tree(state.params), opt_cfg)
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            p.copy_(new_params[name])
    return TrainState(state.params, new_opt), metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_accum: int = 1,
                    grad_transform: Optional[Callable] = None):
    """``step(state, batch) -> (state, metrics)`` with ``metrics`` holding
    ``loss``, ``grad_norm`` and ``lr`` as device scalars. ``grad_accum >
    1`` averages the gradients of that many microbatches;
    ``grad_transform`` maps the gradient dictionary before the optimizer
    (the hook for gradient compression)."""

    def step(state: TrainState, batch: Batch):
        loss, grads = _grads(state.params, cfg, batch, grad_accum)
        if grad_transform is not None:
            grads = grad_transform(grads)
        state, metrics = _apply(grads, state, opt_cfg)
        metrics["loss"] = loss
        return state, metrics

    return step


def make_grad_and_apply(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """The step split in two for host-side gradient transforms:
    ``grad_fn(model, batch) -> (loss, grads)`` and ``apply_fn(grads,
    state) -> (state, metrics)``."""

    def grad_fn(model: T.LM, batch: Batch):
        return _grads(model, cfg, batch, 1)

    def apply_fn(grads: Dict, state: TrainState):
        return _apply(grads, state, opt_cfg)

    return grad_fn, apply_fn
