"""AdamW as tensor functions: the port of ``repro.training.optimizer``.

Decoupled weight decay, bias correction, global-norm clipping, a warm-up
and cosine learning-rate schedule in float32, and an optimizer-state dtype
(``float32`` by default; ``bfloat16`` halves the moments' memory). The
state is ``(step, m, v)`` with ``m``/``v`` dictionaries shaped like the
parameters' (``{name: tensor}``), and every operation runs in the
reference's order, so the two agree to float32 rounding. It is not
``torch.optim.AdamW``, whose state layout and arithmetic differ.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "lr_schedule"]

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


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 cfg: AdamWConfig):
    """One AdamW step. Returns ``(new_params, new_state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (device scalars); new tensors, the
    inputs are not modified."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm else 1.0
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)
    sdt = _DTYPES[cfg.state_dtype]

    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m32 = state.m[name].to(torch.float32) * b1 + (1 - b1) * g
        v32 = state.v[name].to(torch.float32) * b2 + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.to(torch.float32)
        new_p[name] = (p32 - lr * (delta + cfg.weight_decay * p32)).to(
            p.dtype)
        new_m[name] = m32.to(sdt)
        new_v[name] = v32.to(sdt)
    return (new_p, AdamWState(step, new_m, new_v),
            {"grad_norm": gnorm, "lr": lr})
