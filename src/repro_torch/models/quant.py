"""Weight-only int8 quantization — implementation variants for PIES (the
port of :mod:`repro.models.quant`).

The paper's core premise is that one service has *multiple implementations
with different cost/QoS trade-offs*. Quantization manufactures exactly
that: every architecture yields an int8 variant with ~2× smaller storage
(= the paper's ``r_sm``), faster weight transfer/load, and a small
accuracy delta — a second point on the accuracy/cost frontier from the
same checkpoint.

Per-leading-channel symmetric int8 of each leaf of the reference's
**stacked** tree (:func:`repro_torch.convert.reference_leaves`):

    w_q[o, ...] = round(w[o, ...] / s_o),  s_o = max|w[o, ...]| / 127

A per-layer leaf is ``[L, ...]`` there, so its leading channel is the
layer: one scale per layer over the whole layer's tensor, and the size
threshold counts every layer. The embedding ``[V, d]`` gets one scale per
row, an untied head ``[d, V]`` one per row of d. Storage is int8 + one f32
scale per channel; serving dequantizes at load (bf16 compute).
:func:`logit_agreement` measures top-1 agreement against the unquantized
model on probe prompts, through the port's forward (the attention or SSD
scan kernels on a CUDA device).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.convert import reference_leaves
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = ["quantize_tree", "dequantize_tree", "quantized_bytes",
           "logit_agreement"]

#: leaves smaller than this stay unquantized (norm scales, biases)
_MIN_SIZE = 4096

#: parameters the port holds in float32 (``convert._F32_LEAVES`` and the
#: MoE router)
_F32_NAMES = ("A_log", "D_skip", "dt_bias", "router")

Scales = Dict[str, Optional[torch.Tensor]]


def _with_params(model: T.LM, tensors: Dict[str, torch.Tensor]) -> T.LM:
    """A copy of ``model`` whose parameter ``n`` is ``tensors[n]`` (frozen);
    nothing else is copied."""
    memo = {id(p): nn.Parameter(tensors[n], requires_grad=False)
            for n, p in model.named_parameters()}
    return copy.deepcopy(model, memo)


@torch.no_grad()
def quantize_tree(model: T.LM) -> Tuple[T.LM, Scales]:
    """Returns ``(quantized, scales)``: an :class:`~repro_torch.models.LM`
    whose quantized parameters are int8, and ``{name: float32 scale}``
    (``None`` where a parameter passes through unchanged). A stacked
    leaf's scale for layer ``i`` is that layer's slice, ``[1, ...]``."""
    params = dict(model.named_parameters())
    qs: Dict[str, torch.Tensor] = {}
    scales: Scales = {}
    for leaf in reference_leaves(model):
        w0 = params[leaf.names[0]]
        ndim = w0.ndim + leaf.stacked
        size = w0.numel() * len(leaf.names)
        if ndim < 2 or size < _MIN_SIZE or not w0.is_floating_point():
            for n in leaf.names:
                qs[n], scales[n] = params[n].detach(), None
            continue
        for n in leaf.names:
            wf = params[n].detach().float()
            # per leading channel over all remaining axes: for a stacked
            # leaf the channel is the layer, so every axis here
            axes = tuple(range(0 if leaf.stacked else 1, wf.ndim))
            amax = torch.amax(wf.abs(), dim=axes, keepdim=True)
            # a tensor divisor: CUDA multiplies by a Python scalar's
            # reciprocal, which can differ from the division by an ulp
            s = amax / amax.new_tensor(127.0)
            s = torch.clamp(s, min=1e-12)
            qs[n] = torch.clamp(torch.round(wf / s), -127, 127).to(
                torch.int8)
            scales[n] = s
    return _with_params(model, qs), scales


@torch.no_grad()
def dequantize_tree(quantized: T.LM, scales: Scales,
                    dtype: torch.dtype = torch.bfloat16) -> T.LM:
    """Rebuild compute weights (bf16) from the int8 storage form. As in
    the reference every quantized leaf is cast to ``dtype``; a parameter
    the port holds in float32 whatever the param dtype (the Mamba blocks'
    ``A_log``, ``D_skip`` and ``dt_bias``, the MoE router) keeps the
    ``dtype``-rounded values in float32."""
    out = {}
    for n, q in quantized.named_parameters():
        s = scales[n]
        if s is None:
            out[n] = q
            continue
        w = (q.float() * s).to(dtype)
        out[n] = w.float() if n.rsplit(".", 1)[-1] in _F32_NAMES else w
    return _with_params(quantized, out)


def quantized_bytes(quantized: T.LM, scales: Scales) -> int:
    """Storage footprint of the quantized form (int8 + scales)."""
    total = 0
    for n, q in quantized.named_parameters():
        total += q.numel() * q.element_size()
        if scales[n] is not None:
            total += scales[n].numel() * 4
    return total


@torch.no_grad()
def logit_agreement(cfg: ModelConfig, model_ref: T.LM, model_q: T.LM,
                    n_probes: int = 8, seq: int = 32, seed: int = 0
                    ) -> float:
    """Top-1 next-token agreement between the reference and quantized
    models on random probe prompts (``np.random.default_rng(seed)``, as
    the reference draws them) — the accuracy-delta proxy the serving
    catalog uses for the variant's A_sm. Runs on ``model_ref``'s device."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (n_probes, seq))).to(
            model_ref.tok.device)
    V = cfg.vocab_size
    tops = [T.logits_fn(m, cfg, T.forward(m, cfg, toks))[..., :V].argmax(-1)
            for m in (model_ref, model_q)]
    return float((tops[0] == tops[1]).float().mean())
