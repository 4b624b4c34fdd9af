"""AdamW as tensor functions: the port of ``repro.training.optimizer``.

Decoupled weight decay, bias correction, global-norm clipping, a warm-up
and cosine learning-rate schedule in float32, and an optimizer-state dtype
(``float32`` by default; ``bfloat16`` halves the moments' memory). The
state is ``(step, m, v)`` with ``m``/``v`` dictionaries shaped like the
parameters' (``{name: tensor}``), and every operation runs in the
reference's order, so the two agree to float32 rounding. It is not
``torch.optim.AdamW``, whose state layout and arithmetic differ.

:func:`adamw_update_` updates the parameters and moments in place, leaf by
leaf and within a leaf block by block (:data:`UPDATE_BLOCK` elements), so
its float32 working copies are one block's (the trainer's update: a
2.7B-parameter model's new parameters and moments would take another 32
GB at once, and whole-leaf working copies of qwen3-moe-235b's 3.2-GB
expert leaves ran an 80-GB H100 out of memory at one layer); the update
is elementwise, so the blocks give the same bits as the whole leaf.
With ``chunked_update`` a large stacked leaf goes slice by slice along
its leading dimension, the reference's layer-by-layer ``lax.map``.
:func:`adamw_update` is the same update on copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

__all__ = ["AdamWConfig", "AdamWState", "UPDATE_BLOCK", "adamw_init",
           "adamw_state_pspecs", "adamw_update", "adamw_update_",
           "global_norm", "lr_schedule"]

#: Elements of a leaf that one pass of :func:`adamw_update_` takes.
UPDATE_BLOCK = 2 ** 24

Tree = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class AdamWState(NamedTuple):
    step: torch.Tensor   # scalar int32, on the parameters' device
    m: Tree              # like params
    v: Tree              # like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    #: update a stacked leaf (``ndim >= 3``, leading dimension above 1,
    #: more than 2**24 elements) one slice of its leading dimension at a
    #: time, the reference's layer-by-layer ``lax.map``: the float32
    #: working copies are one slice's. The same values either way.
    chunked_update: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"


def adamw_init(params: Tree, cfg: AdamWConfig) -> AdamWState:
    """Step 0 and zero moments in ``cfg.state_dtype``."""
    dt = _DTYPES[cfg.state_dtype]
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros(p.shape, dtype=dt, device=p.device)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=dt, device=p.device)
           for n, p in params.items()})


def adamw_state_pspecs(param_pspecs) -> AdamWState:
    """The state's specs: the step replicated (``()``), the moments laid
    out as the parameters (elementwise state)."""
    return AdamWState(step=(), m=param_pspecs, v=param_pspecs)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``, then a cosine
    decay to ``min_lr_frac · lr`` at ``total_steps``; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, step) * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)`` in float32, leaves in the tree's order."""
    total = None
    for leaf in tree.values():
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _chunked(p: torch.Tensor, cfg: AdamWConfig) -> bool:
    """The reference's condition for a layer-by-layer update."""
    return cfg.chunked_update and p.ndim >= 3 and p.shape[0] > 1 \
        and p.numel() > 2 ** 24


@torch.no_grad()
def adamw_update_(grads: Tree, state: AdamWState, params: Tree,
                  cfg: AdamWConfig, grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step in place: each parameter and its moments (the
    tensors of ``params``, ``state.m`` and ``state.v``) are overwritten,
    leaf by leaf in the tree's order (slice by slice where
    ``cfg.chunked_update`` applies), :data:`UPDATE_BLOCK` elements at a
    time. The leaves may be each rank's blocks of a sharded state, the
    update being elementwise; their global norm is then ``grad_norm``
    (else :func:`global_norm` of ``grads``). Returns ``(new_state,
    metrics)`` with ``metrics = {"grad_norm", "lr"}`` (device scalars);
    ``new_state`` holds the same moment dictionaries and the next step."""
    step = state.step + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm else 1.0
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)
    sdt = _DTYPES[cfg.state_dtype]

    def upd_block(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(torch.float32)
        p.copy_((p32 - lr * (delta + cfg.weight_decay * p32)).to(p.dtype))
        m.copy_(m32.to(sdt))
        v.copy_(v32.to(sdt))

    def upd(p, g, m, v):
        # flat views of the tensors written in place (a non-contiguous one
        # raises rather than update a copy)
        p, m, v, g = p.view(-1), m.view(-1), v.view(-1), g.reshape(-1)
        for i in range(0, p.numel(), UPDATE_BLOCK):
            upd_block(*(t[i:i + UPDATE_BLOCK] for t in (p, g, m, v)))

    for name, p in params.items():
        leaf = (p, grads[name], state.m[name], state.v[name])
        if _chunked(p, cfg):
            for i in range(p.shape[0]):
                upd(*(t[i] for t in leaf))
        else:
            upd(*leaf)
    return AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 cfg: AdamWConfig):
    """One AdamW step. Returns ``(new_params, new_state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (device scalars); new tensors, the
    inputs are not modified (:func:`adamw_update_` on copies)."""
    new_p = {n: p.detach().clone() for n, p in params.items()}
    copy = AdamWState(state.step, {n: t.clone() for n, t in state.m.items()},
                      {n: t.clone() for n, t in state.v.items()})
    new_state, metrics = adamw_update_(grads, copy, new_p, cfg)
    return new_p, new_state, metrics
