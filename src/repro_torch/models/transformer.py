"""The dense model family in PyTorch: parameters, KV cache, forward,
prefill and decode — the single-device counterpart of the JAX package's
``models/transformer.py`` for ``family == "dense"``.

The reference scans stacked ``[L, ...]`` parameters with ``lax.scan``; the
port keeps one :class:`DenseLayer` module per layer in a
:class:`DenseLM` and runs them in a Python loop. The per-layer window
array realises gemma2's alternating local/global attention. The other
families raise :class:`NotImplementedError` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import layers as L
from .config import ATTN_SWA, MAMBA, ModelConfig

__all__ = ["Cache", "DenseLM", "DenseLayer", "cache_spec", "decode_step",
           "embed_tokens", "forward", "init_cache", "init_params",
           "logits_fn", "prefill", "run_attention_stack"]

#: Where each unported family is queued (ROADMAP.md, section A).
_NOT_PORTED = {
    "ssm": "A10 (ssm/hybrid families, with the B8 ssd_scan kernel)",
    "hybrid": "A10 (ssm/hybrid families, with the B8 ssd_scan kernel)",
    "moe": "A10 (MoE family)",
    "audio": "A10 (audio and vision frontends)",
    "vlm": "A10 (audio and vision frontends)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts or cfg.frontend != "none" \
            or cfg.encoder_only:
        where = _NOT_PORTED.get(cfg.family, "A10")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (ROADMAP {where}); only the dense family is")


# ===========================================================================
# Parameters
# ===========================================================================

class DenseLayer(nn.Module):
    """One [attention → MLP] layer: RMSNorm scales ``ln1``/``ln2`` (and
    gemma2's post-norms ``ln_pa``/``ln_pf``), :class:`~.layers.Attention`
    and :class:`~.layers.MLP`."""

    def __init__(self, ln1, attn: L.Attention, ln2, mlp: L.MLP,
                 ln_pa=None, ln_pf=None):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.attn, self.mlp = attn, mlp
        self.ln_pa = None if ln_pa is None else L._param(ln_pa)
        self.ln_pf = None if ln_pf is None else L._param(ln_pf)


class DenseLM(nn.Module):
    """Token embedding ``tok [V_pad, D]``, the layers, the final norm
    scale, and an untied ``head [D, V_pad]`` (``None`` when tied)."""

    def __init__(self, tok, layers, final_norm, head=None):
        super().__init__()
        self.tok = L._param(tok)
        self.layers = nn.ModuleList(layers)
        self.final_norm = L._param(final_norm)
        self.head = None if head is None else L._param(head)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> DenseLM:
    """Random parameters in ``cfg.param_dtype`` on the generator's device:
    Normal(0, 0.02) weights, zero norm scales (a gain of 1), zero padded
    heads. The reference's layout and distribution, not its numbers."""
    _check_family(cfg)
    pdt = L.torch_dtype(cfg.param_dtype)
    D, Vp = cfg.d_model, cfg.vocab_pad
    dev = generator.device

    def zeros():
        return torch.zeros(D, dtype=pdt, device=dev)

    tok = L._normal((Vp, D), generator, pdt)
    layers = []
    for _ in range(cfg.n_layers):
        attn = L.init_attention(cfg, generator, pdt)
        mlp = L.init_mlp(cfg, generator, pdt)
        post = (zeros(), zeros()) if cfg.post_norms else (None, None)
        layers.append(DenseLayer(zeros(), attn, zeros(), mlp, *post))
    head = None if cfg.tie_embeddings else L._normal((D, Vp), generator, pdt)
    return DenseLM(tok, layers, zeros(), head)


# ===========================================================================
# Embedding / head
# ===========================================================================

def embed_tokens(model: DenseLM, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """``[B, S]`` token ids → ``[B, S, D]`` in the compute dtype (times
    ``sqrt(D)``, rounded to that dtype, with ``scale_embed``)."""
    dt = L.torch_dtype(cfg.dtype)
    x = model.tok[tokens].to(dt)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def logits_fn(model: DenseLM, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """Final norm and head (tied: the embedding's transpose), float32
    logits, logit softcap, and −1e30 added on padded vocab slots."""
    dt = L.torch_dtype(cfg.dtype)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    w = model.tok.T if model.head is None else model.head
    logits = (x @ w.to(dt)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.vocab_pad != cfg.vocab_size:
        logits[..., cfg.vocab_size:] += -1e30
    return logits


# ===========================================================================
# Layer stack
# ===========================================================================

def _window_array(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full) for attention layers in order."""
    wins = [cfg.window if k == ATTN_SWA else 0
            for k in cfg.layer_kinds if k != MAMBA]
    return np.asarray(wins, np.int32)


def run_attention_stack(model: DenseLM, cfg: ModelConfig, x: torch.Tensor,
                        start: int, cache: Optional["Cache"] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        ring: bool = False,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The layers in order (the reference's ``lax.scan``). With a cache,
    layer ``i`` reads and writes ``cache.kv_k[i]``/``cache.kv_v[i]`` in
    place. Returns the final hidden state."""
    for i, (lp, window) in enumerate(zip(model.layers, _window_array(cfg))):
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        kv = None if cache is None else (cache.kv_k[i], cache.kv_v[i])
        a, _ = L.attention_block(lp.attn, cfg, h, start, window=int(window),
                                 kv_cache=kv, kv_len=kv_len, ring=ring,
                                 use_kernel=use_kernel)
        if lp.ln_pa is not None:
            a = L.rms_norm(a, lp.ln_pa, cfg.norm_eps)
        x = x + a
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        f = L.mlp_block(lp.mlp, cfg, h)
        if lp.ln_pf is not None:
            f = L.rms_norm(f, lp.ln_pf, cfg.norm_eps)
        x = x + f
    return x


# ===========================================================================
# KV cache and the forward passes
# ===========================================================================

@dataclasses.dataclass
class Cache:
    """Decode-time state of the dense family.

    ``kv_k``/``kv_v``: ``[L, B, Sc, Hkv_pad, hd]`` in the compute dtype,
    updated in place. ``pos``: the next position to write, the same in
    every row (static batching), kept as a host int — the reference keeps
    a ``[B]`` array.
    """
    kv_k: torch.Tensor
    kv_v: torch.Tensor
    pos: int = 0


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int
               ) -> Tuple[Tuple[int, ...], bool]:
    """``(kv shape, ring)``. The cache is a ring of ``window`` slots when
    every attention layer is sliding-window and the window is shorter than
    ``max_seq``; else it holds ``max_seq`` slots."""
    _check_family(cfg)
    kinds = cfg.layer_kinds
    n_attn = sum(1 for k in kinds if k != MAMBA)
    ring = n_attn > 0 and all(k == ATTN_SWA for k in kinds if k != MAMBA) \
        and cfg.window < max_seq
    Sc = cfg.window if ring else max_seq
    return (n_attn, batch, Sc, cfg.gqa.n_kv_pad, cfg.head_dim), ring


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Tuple[Cache, bool]:
    """A zeroed cache on ``device`` and whether it is a ring."""
    shape, ring = cache_spec(cfg, batch, max_seq)
    dt = L.torch_dtype(cfg.dtype)
    return Cache(torch.zeros(shape, dtype=dt, device=device),
                 torch.zeros(shape, dtype=dt, device=device)), ring


def forward(model: DenseLM, cfg: ModelConfig, tokens: torch.Tensor,
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence forward of ``[B, S]`` tokens; the final hidden
    ``[B, S, D]`` (before the final norm)."""
    _check_family(cfg)
    x = embed_tokens(model, cfg, tokens)
    return run_attention_stack(model, cfg, x, 0, use_kernel=use_kernel)


def prefill(model: DenseLM, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, ring: bool, use_kernel: Optional[bool] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the ``[B, S]`` prompt through the model from position 0, filling
    the cache in place. Returns ``(last-position logits [B, V_pad], cache)``
    with ``cache.pos`` advanced to S."""
    _check_family(cfg)
    x = embed_tokens(model, cfg, tokens)
    B, S = tokens.shape
    kv_len = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    x = run_attention_stack(model, cfg, x, 0, cache, kv_len, ring,
                            use_kernel)
    cache.pos = S
    return logits_fn(model, cfg, x[:, -1:])[:, 0], cache


def decode_step(model: DenseLM, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, ring: bool, use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step for ``[B]`` tokens at position ``cache.pos``.
    Returns ``(logits [B, V_pad], cache)`` with ``cache.pos`` advanced by
    one. Raises :class:`ValueError` when a non-ring cache is full."""
    _check_family(cfg)
    Sc = cache.kv_k.shape[2]
    if not ring and cache.pos >= Sc:
        raise ValueError(f"decode at position {cache.pos} overruns the "
                         f"{Sc}-slot KV cache; allocate a longer cache")
    x = embed_tokens(model, cfg, token[:, None])
    kv_len = torch.full((token.shape[0],), cache.pos + 1, dtype=torch.int32,
                        device=token.device)
    x = run_attention_stack(model, cfg, x, cache.pos, cache, kv_len, ring,
                            use_kernel)
    cache.pos += 1
    return logits_fn(model, cfg, x)[:, 0], cache
