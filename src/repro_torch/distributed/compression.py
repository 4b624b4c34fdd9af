"""Gradient compression with error feedback: the port of
:mod:`repro.distributed.compression`.

Two standard compressors, each with an explicit error-feedback carry
(EF-SGD style — the compression residual is added back next step,
preserving convergence):

* **top-k sparsification** — keep the k largest-|g| entries per leaf;
* **int8 quantization** — per-leaf symmetric scale with stochastic
  rounding (unbiased).

A leaf is a leaf of the reference's **stacked** tree
(:func:`repro_torch.convert.reference_leaves`): a per-layer leaf spans
every layer, so top-k keeps ``int(L·n·frac)`` entries over all layers
with one threshold, and int8 takes one scale over all layers.
:class:`ErrorFeedback` stacks the port's per-layer gradients into those
leaves, compresses them, and hands back per-layer tensors.

Use through ``run_training(compression="topk"|"int8")``, which calls
``grad_fn`` → :meth:`ErrorFeedback.transform` → ``apply_fn``, or wrap a
reduction over a mesh axis with :func:`compressed_psum`.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import torch

from . import collectives as C

if TYPE_CHECKING:   # the models import this package's collectives
    from repro_torch.convert import RefLeaf

__all__ = ["topk_compress", "int8_compress", "int8_round", "ErrorFeedback",
           "compressed_psum"]

Grads = Dict[str, torch.Tensor]
#: ``uniform(i, leaf)``: the draws in [0, 1) for the ``i``-th leaf
Uniform = Callable[[int, torch.Tensor], torch.Tensor]


def topk_compress(g: torch.Tensor, frac: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero all but the top ``frac`` fraction of entries by magnitude
    (every entry at or above the k-th largest |g|, ties included).
    Returns (compressed, residual)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat,
                       torch.zeros((), dtype=g.dtype, device=g.device))
    kept = kept.reshape(g.shape)
    return kept, g - kept


def int8_round(g: torch.Tensor, rnd: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``g`` rounded stochastically by the
    uniform draws ``rnd`` (``g``'s shape): up where a draw is below the
    fractional part. Returns (dequantized, residual)."""
    amax = torch.clamp(g.abs().max(), min=1e-12)
    # a tensor divisor: CUDA multiplies by a Python scalar's reciprocal,
    # which can differ from the division by an ulp
    scale = amax / amax.new_tensor(127.0)
    x = g / scale
    lo = torch.floor(x)
    q = torch.clamp(lo + (rnd < x - lo).to(x.dtype), -127, 127).to(
        torch.int8)
    deq = q.to(g.dtype) * scale
    return deq, g - deq


def int8_compress(g: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with stochastic rounding (unbiased),
    its draws from ``generator`` (on ``g``'s device). Returns
    (dequantized, residual)."""
    rnd = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                     device=g.device)
    return int8_round(g, rnd)


@dataclasses.dataclass
class ErrorFeedback:
    """EF compressor: carry = what compression dropped last step.

    ``leaves`` maps the gradient dictionary onto the reference's leaves
    (:func:`~repro_torch.convert.reference_leaves` of the model); without
    it every key is a leaf of its own, in sorted key order, as the
    reference flattens a dict."""

    method: str = "topk"        # topk | int8
    frac: float = 0.01
    seed: int = 0
    leaves: Optional[Sequence[RefLeaf]] = None

    def _leaves(self, grads: Mapping[str, torch.Tensor]) -> List[RefLeaf]:
        from repro_torch.convert import RefLeaf

        if self.leaves is not None:
            return list(self.leaves)
        return [RefLeaf(k, (k,), False) for k in sorted(grads)]

    def draws(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """int8's uniform draws for the ``i``-th leaf, from a generator
        keyed by ``(seed, i)`` on the leaf's device, as the reference folds
        ``i`` into ``PRNGKey(seed)`` (other bits; the same draws at every
        step, as there)."""
        gen = torch.Generator(device=leaf.device).manual_seed(
            (int(self.seed) << 20) + int(i))
        return torch.rand(leaf.shape, generator=gen, dtype=torch.float32,
                          device=leaf.device)

    def init(self, grads: Mapping[str, torch.Tensor]) -> Grads:
        return {n: torch.zeros(g.shape, dtype=torch.float32,
                               device=g.device) for n, g in grads.items()}

    @torch.no_grad()
    def transform(self, grads: Mapping[str, torch.Tensor], carry: Grads, *,
                  uniform: Optional[Uniform] = None) -> Tuple[Grads, Grads]:
        """Returns (compressed_grads, new_carry), keyed as ``grads``.
        ``uniform(i, leaf)`` supplies int8's draws for the ``i``-th leaf
        (default: :meth:`draws`)."""
        outs: Grads = {}
        news: Grads = {}
        for i, leaf in enumerate(self._leaves(grads)):
            parts = [grads[n].float() + carry[n] for n in leaf.names]
            corrected = torch.stack(parts) if leaf.stacked else parts[0]
            del parts
            if self.method == "topk":
                kept, resid = topk_compress(corrected, self.frac)
            elif self.method == "int8":
                kept, resid = int8_round(
                    corrected, (uniform or self.draws)(i, corrected))
            else:
                raise ValueError(self.method)
            for j, n in enumerate(leaf.names):
                k, r = (kept[j], resid[j]) if leaf.stacked else (kept, resid)
                outs[n] = k.to(grads[n].dtype)
                news[n] = r
        return ({n: outs[n] for n in grads}, {n: news[n] for n in grads})


def compressed_psum(x: torch.Tensor, axis, generator: torch.Generator, *,
                    method: str = "int8", mesh=None) -> torch.Tensor:
    """psum over the mesh axis ``axis`` with pre-compression: each rank's
    ``x`` quantized by :func:`int8_compress` with draws from
    ``generator`` (on ``x``'s device), then summed in rank order;
    ``method="none"`` is the plain psum. Unbiased (stochastic rounding),
    so error feedback is optional here. ``mesh`` defaults to the one of
    :func:`~repro_torch.distributed.collectives.use_mesh`."""
    if method == "int8":
        compressed, _ = int8_compress(x, generator)
    elif method == "none":
        compressed = x
    else:
        raise ValueError(method)
    return C.psum(compressed, axis, mesh=mesh)
