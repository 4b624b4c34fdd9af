"""AdamW as the configuration's optimizer block states it: decoupled
weight decay, bias correction, clipping by the global gradient norm, and a
linear warm-up into a cosine decay of the learning rate."""
from __future__ import annotations

import math
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def learning_rate(opt: dict, step: int) -> float:
    """The rate of (1-based) ``step``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_frac"]
                               + (1 - opt["min_lr_frac"]) * cos)


@torch.no_grad()
def step(params: Tree, grads: Tree, m: Tree, v: Tree, n: int, opt: dict
         ) -> Dict[str, float]:
    """AdamW step ``n`` (1-based) in place. Returns per leaf the norm of
    the gradient as the update takes it (after clipping)."""
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0) \
        if opt["clip_norm"] else 1.0
    lr = learning_rate(opt, n)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** n, 1 - b2 ** n
    norms = {}
    for name, p in params.items():
        g = grads[name] * scale
        norms[name] = float(g.norm())
        m[name].mul_(b1).add_(g, alpha=1 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m[name] / bc1) / ((v[name] / bc2).sqrt() + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
    return norms
