"""The model families in PyTorch: parameters, cache, forward, prefill and
decode — the single-device counterpart of the JAX package's
``models/transformer.py`` for the ``dense``, ``ssm`` (Mamba2) and
``hybrid`` (Zamba2) families.

The reference scans stacked ``[L, ...]`` parameters with ``lax.scan``; the
port keeps one module per layer in an :class:`LM` and runs them in Python
loops:

* ``dense`` — [attention → MLP] × L (:class:`DenseLayer`); the per-layer
  window array realises gemma2's alternating local/global attention;
* ``ssm`` — [Mamba2] × L (:class:`MambaLayer`);
* ``hybrid`` — the Mamba2 backbone in segments of ``shared_attn_every``
  layers, each followed by shared attention+MLP block ``segment %
  n_shared_blocks`` (a :class:`DenseLayer` without post-norms).

The MoE family and the audio/vision frontends raise
:class:`NotImplementedError` naming the ROADMAP item that ports them.
Training: :func:`loss_fn` (the chunked cross-entropy
:func:`softmax_xent`), with ``cfg.remat`` rematerialising each dense layer
under grad.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import ATTN_SWA, MAMBA, ModelConfig

__all__ = ["Cache", "DenseLayer", "LM", "MambaLayer", "cache_spec",
           "decode_step", "embed_tokens", "forward", "init_cache",
           "init_params", "logits_fn", "loss_fn", "prefill",
           "run_attention_stack", "run_hybrid_stack", "run_mamba_stack",
           "softmax_xent"]

_PORTED = ("dense", "ssm", "hybrid")
#: Where each unported family is queued (ROADMAP.md, section A).
_NOT_PORTED = {
    "moe": "A10 (MoE family)",
    "audio": "A10 (audio and vision frontends)",
    "vlm": "A10 (audio and vision frontends)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED or cfg.n_experts \
            or cfg.frontend != "none" or cfg.encoder_only:
        where = _NOT_PORTED.get(cfg.family, "A10")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (ROADMAP {where}); only {', '.join(_PORTED)} are")


# ===========================================================================
# Parameters
# ===========================================================================

class DenseLayer(nn.Module):
    """One [attention → MLP] layer (or a hybrid's shared block): RMSNorm
    scales ``ln1``/``ln2`` (and gemma2's post-norms ``ln_pa``/``ln_pf``),
    :class:`~.layers.Attention` and :class:`~.layers.MLP`."""

    def __init__(self, ln1, attn: L.Attention, ln2, mlp: L.MLP,
                 ln_pa=None, ln_pf=None):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.attn, self.mlp = attn, mlp
        self.ln_pa = None if ln_pa is None else L._param(ln_pa)
        self.ln_pf = None if ln_pf is None else L._param(ln_pf)


class MambaLayer(nn.Module):
    """One pre-norm Mamba2 layer: the RMSNorm scale ``ln`` and the
    :class:`~.layers.Mamba` block."""

    def __init__(self, ln, block: L.Mamba):
        super().__init__()
        self.ln = L._param(ln)
        self.block = block


class LM(nn.Module):
    """Token embedding ``tok [V_pad, D]``; the attention layers
    (``layers``, dense), the Mamba2 layers (``mamba``, ssm and hybrid) and
    the shared blocks (``shared``, hybrid); the final norm scale; an untied
    ``head [D, V_pad]`` (``None`` when tied)."""

    def __init__(self, tok, final_norm, head=None, *, layers=(), mamba=(),
                 shared=()):
        super().__init__()
        self.tok = L._param(tok)
        self.layers = nn.ModuleList(layers)
        self.mamba = nn.ModuleList(mamba)
        self.shared = nn.ModuleList(shared)
        self.final_norm = L._param(final_norm)
        self.head = None if head is None else L._param(head)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> LM:
    """Random parameters in ``cfg.param_dtype`` on the generator's device:
    Normal(0, 0.02) weights, zero norm scales (a gain of 1), zero padded
    heads, the Mamba blocks' ``A_log``/``dt_bias`` schedules. The
    reference's layout and distribution, not its numbers."""
    _check_family(cfg)
    pdt = L.torch_dtype(cfg.param_dtype)
    D, Vp = cfg.d_model, cfg.vocab_pad
    dev = generator.device

    def zeros():
        return torch.zeros(D, dtype=pdt, device=dev)

    def dense_layer(post_norms: bool) -> DenseLayer:
        attn = L.init_attention(cfg, generator, pdt)
        mlp = L.init_mlp(cfg, generator, pdt)
        post = (zeros(), zeros()) if post_norms else (None, None)
        return DenseLayer(zeros(), attn, zeros(), mlp, *post)

    tok = L._normal((Vp, D), generator, pdt)
    parts = {}
    if cfg.family == "dense":
        parts["layers"] = [dense_layer(cfg.post_norms)
                           for _ in range(cfg.n_layers)]
    else:
        parts["mamba"] = [MambaLayer(zeros(), L.init_mamba(cfg, generator,
                                                           pdt))
                          for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            parts["shared"] = [dense_layer(False)
                               for _ in range(cfg.n_shared_blocks)]
    head = None if cfg.tie_embeddings else L._normal((D, Vp), generator, pdt)
    return LM(tok, zeros(), head, **parts)


# ===========================================================================
# Embedding / head
# ===========================================================================

def embed_tokens(model: LM, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """``[B, S]`` token ids → ``[B, S, D]`` in the compute dtype (times
    ``sqrt(D)``, rounded to that dtype, with ``scale_embed``)."""
    dt = L.torch_dtype(cfg.dtype)
    x = model.tok[tokens].to(dt)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def logits_fn(model: LM, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """Final norm and head (tied: the embedding's transpose), float32
    logits, logit softcap, and −1e30 added on padded vocab slots."""
    dt = L.torch_dtype(cfg.dtype)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    w = model.tok.T if model.head is None else model.head
    logits = (x @ w.to(dt)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.vocab_pad != cfg.vocab_size:      # out of place: autograd-safe
        V = cfg.vocab_size
        logits = torch.cat([logits[..., :V], logits[..., V:] + -1e30], -1)
    return logits


# ===========================================================================
# Layer stack
# ===========================================================================

def _window_array(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full) for attention layers in order."""
    wins = [cfg.window if k == ATTN_SWA else 0
            for k in cfg.layer_kinds if k != MAMBA]
    return np.asarray(wins, np.int32)


def _dense_layer(lp: DenseLayer, cfg: ModelConfig, x: torch.Tensor,
                 start: int, window: int, kv, kv_len, ring: bool,
                 use_kernel: Optional[bool]) -> torch.Tensor:
    """One [attention → MLP] layer with its residuals."""
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    a, _ = L.attention_block(lp.attn, cfg, h, start, window=window,
                             kv_cache=kv, kv_len=kv_len, ring=ring,
                             use_kernel=use_kernel)
    if lp.ln_pa is not None:
        a = L.rms_norm(a, lp.ln_pa, cfg.norm_eps)
    x = x + a
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    f = L.mlp_block(lp.mlp, cfg, h)
    if lp.ln_pf is not None:
        f = L.rms_norm(f, lp.ln_pf, cfg.norm_eps)
    return x + f


def _remat(cfg: ModelConfig) -> bool:
    """Whether to rematerialise each layer: ``cfg.remat`` under grad, with
    the reference's "nothing" policy (only the residual stream between
    layers is kept; the layer is recomputed in the backward)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return False
    if cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported (ROADMAP A12); "
            "only 'nothing'")
    return True


def run_attention_stack(model: LM, cfg: ModelConfig, x: torch.Tensor,
                        start: int, cache: Optional["Cache"] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        ring: bool = False,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The layers in order (the reference's ``lax.scan``). With a cache,
    layer ``i`` reads and writes ``cache.kv_k[i]``/``cache.kv_v[i]`` in
    place. Without one, under grad and with ``cfg.remat``, each layer runs
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
    with ``nothing_saveable``). Returns the final hidden state."""
    remat = cache is None and _remat(cfg)
    for i, (lp, window) in enumerate(zip(model.layers, _window_array(cfg))):
        kv = None if cache is None else (cache.kv_k[i], cache.kv_v[i])
        args = (lp, cfg, x, start, int(window), kv, kv_len, ring, use_kernel)
        x = checkpoint(_dense_layer, *args, use_reentrant=False) if remat \
            else _dense_layer(*args)
    return x


def run_mamba_stack(model: LM, cfg: ModelConfig, x: torch.Tensor,
                    cache: Optional["Cache"] = None,
                    use_kernel: Optional[bool] = None,
                    layers: Optional[range] = None) -> torch.Tensor:
    """The Mamba2 layers ``layers`` (all by default) in order. With a
    cache, layer ``i`` continues from ``cache.conv[i]``/``cache.ssm[i]``
    and writes its new state there in place. Returns the hidden state."""
    for i in layers if layers is not None else range(len(model.mamba)):
        lp = model.mamba[i]
        h = L.rms_norm(x, lp.ln, cfg.norm_eps)
        st = None if cache is None else (cache.conv[i], cache.ssm[i])
        m, (conv, ssm) = L.mamba_block(lp.block, cfg, h, cache=st,
                                       use_kernel=use_kernel)
        if cache is not None:
            cache.conv[i].copy_(conv)
            cache.ssm[i].copy_(ssm)
        x = x + m
    return x


def run_hybrid_stack(model: LM, cfg: ModelConfig, x: torch.Tensor,
                     start: int, cache: Optional["Cache"] = None,
                     kv_len: Optional[torch.Tensor] = None,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Zamba2: after each segment of ``shared_attn_every`` Mamba layers,
    shared block ``segment % n_shared_blocks`` (full attention, then the
    MLP). With a cache, application ``segment`` of a shared block reads and
    writes KV slot ``segment``. Returns the hidden state."""
    k = cfg.shared_attn_every
    for seg in range(cfg.n_layers // k):
        x = run_mamba_stack(model, cfg, x, cache, use_kernel,
                            range(seg * k, (seg + 1) * k))
        sp = model.shared[seg % cfg.n_shared_blocks]
        h = L.rms_norm(x, sp.ln1, cfg.norm_eps)
        kv = None if cache is None else (cache.kv_k[seg], cache.kv_v[seg])
        a, _ = L.attention_block(sp.attn, cfg, h, start, window=0,
                                 kv_cache=kv, kv_len=kv_len,
                                 use_kernel=use_kernel)
        x = x + a
        h = L.rms_norm(x, sp.ln2, cfg.norm_eps)
        x = x + L.mlp_block(sp.mlp, cfg, h)
    return x


def _run_stack(model: LM, cfg: ModelConfig, x: torch.Tensor, start: int,
               cache: Optional["Cache"], kv_len: Optional[torch.Tensor],
               ring: bool, use_kernel: Optional[bool]) -> torch.Tensor:
    """The family's layer stack."""
    if cfg.family == "ssm":
        return run_mamba_stack(model, cfg, x, cache, use_kernel)
    if cfg.family == "hybrid":
        return run_hybrid_stack(model, cfg, x, start, cache, kv_len,
                                use_kernel)
    return run_attention_stack(model, cfg, x, start, cache, kv_len, ring,
                               use_kernel)


# ===========================================================================
# Cache and the forward passes
# ===========================================================================

@dataclasses.dataclass
class Cache:
    """Decode-time state, updated in place. Fields a family does not use
    hold zero-size tensors, as in the reference.

    ``kv_k``/``kv_v``: ``[L_attn, B, Sc, Hkv_pad, hd]`` in the compute
    dtype. ``conv``: ``[L_mamba, B, cw-1, din + 2N]`` in the compute dtype;
    ``ssm``: ``[L_mamba, B, H, P, N]`` float32. ``pos``: the next position
    to write, the same in every row (static batching), kept as a host int —
    the reference keeps a ``[B]`` array.
    """
    kv_k: torch.Tensor
    kv_v: torch.Tensor
    conv: torch.Tensor
    ssm: torch.Tensor
    pos: int = 0

    @property
    def has_kv(self) -> bool:
        """Whether the family keeps a KV cache (dense, hybrid), which a
        sequence may not overrun outside ring mode."""
        return self.kv_k.shape[0] > 0


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int
               ) -> Tuple[Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                          bool]:
    """``({field: (shape, dtype)}, ring)``. The KV cache is a ring of
    ``window`` slots when every attention layer is sliding-window and the
    window is shorter than ``max_seq`` (never in a hybrid); else it holds
    ``max_seq`` slots. A hybrid keeps one KV slot per shared-block
    application."""
    _check_family(cfg)
    kinds = cfg.layer_kinds
    n_attn = sum(1 for k in kinds if k != MAMBA)
    n_mamba = sum(1 for k in kinds if k == MAMBA)
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.shared_attn_every
        n_mamba = cfg.n_layers
    ring = n_attn > 0 and all(k == ATTN_SWA for k in kinds if k != MAMBA) \
        and cfg.window < max_seq and cfg.family != "hybrid"
    Sc = cfg.window if ring else max_seq
    dt = L.torch_dtype(cfg.dtype)
    kv = (n_attn, batch, Sc, cfg.gqa.n_kv_pad, cfg.head_dim)
    spec = {
        "kv_k": (kv, dt),
        "kv_v": (kv, dt),
        "conv": ((n_mamba, batch, max(cfg.conv_width - 1, 0),
                  cfg.d_inner + 2 * cfg.ssm_state if n_mamba else 0), dt),
        "ssm": ((n_mamba, batch, cfg.ssm_heads if n_mamba else 0,
                 cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
    }
    return spec, ring


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Tuple[Cache, bool]:
    """A zeroed cache on ``device`` and whether its KV part is a ring."""
    spec, ring = cache_spec(cfg, batch, max_seq)
    return Cache(**{k: torch.zeros(s, dtype=d, device=device)
                    for k, (s, d) in spec.items()}), ring


def forward(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence forward of ``[B, S]`` tokens; the final hidden
    ``[B, S, D]`` (before the final norm)."""
    _check_family(cfg)
    x = embed_tokens(model, cfg, tokens)
    return _run_stack(model, cfg, x, 0, None, None, False, use_kernel)


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, ring: bool, use_kernel: Optional[bool] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the ``[B, S]`` prompt through the model from position 0, filling
    the cache in place. Returns ``(last-position logits [B, V_pad], cache)``
    with ``cache.pos`` advanced to S. Inference only: no autograd graph
    (the parameters are trainable)."""
    _check_family(cfg)
    x = embed_tokens(model, cfg, tokens)
    B, S = tokens.shape
    kv_len = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    x = _run_stack(model, cfg, x, 0, cache, kv_len, ring, use_kernel)
    cache.pos = S
    return logits_fn(model, cfg, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, ring: bool, use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step for ``[B]`` tokens at position ``cache.pos``.
    Returns ``(logits [B, V_pad], cache)`` with ``cache.pos`` advanced by
    one. Raises :class:`ValueError` when a non-ring KV cache is full (an
    ssm model has none and decodes on)."""
    _check_family(cfg)
    Sc = cache.kv_k.shape[2]
    if cache.has_kv and not ring and cache.pos >= Sc:
        raise ValueError(f"decode at position {cache.pos} overruns the "
                         f"{Sc}-slot KV cache; allocate a longer cache")
    x = embed_tokens(model, cfg, token[:, None])
    kv_len = torch.full((token.shape[0],), cache.pos + 1, dtype=torch.int32,
                        device=token.device)
    x = _run_stack(model, cfg, x, cache.pos, cache, kv_len, ring,
                   use_kernel)
    cache.pos += 1
    return logits_fn(model, cfg, x)[:, 0], cache


# ===========================================================================
# Training loss
# ===========================================================================

def _xent_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor, reduce: bool = True):
    """Masked next-token cross-entropy: ``logsumexp − logit[target]``.
    ``reduce`` gives the mean over the mask's mass (at least 1); else
    ``(sum, mass)``."""
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (logz - tgt) * mask
    if reduce:
        return nll.sum() / mask.sum().clamp_min(1.0)
    return nll.sum(), mask.sum()


def _chunk_xent(model: LM, cfg: ModelConfig, x: torch.Tensor,
                targets: torch.Tensor, mask: torch.Tensor):
    return _xent_from_logits(logits_fn(model, cfg, x), targets, mask,
                             reduce=False)


def softmax_xent(model: LM, cfg: ModelConfig, x: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over the (padded) vocabulary. Above 16,384 vocabulary
    slots and ``chunk`` positions it runs chunk by chunk over the sequence,
    each chunk's logits recomputed in the backward (checkpointed), so the
    ``[B, S, V]`` float32 logits never exist at once — the reference's
    ``lax.map`` over ``jax.checkpoint``-ed chunks."""
    B, S, _ = x.shape
    if cfg.vocab_pad <= 16384 or S <= chunk:
        return _xent_from_logits(logits_fn(model, cfg, x), targets, mask)
    nch = -(-S // chunk)
    pad = nch * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    grad = torch.is_grad_enabled()
    losses, masses = [], []
    for c in range(nch):
        args = (model, cfg, x[:, c * chunk:(c + 1) * chunk],
                targets[:, c * chunk:(c + 1) * chunk],
                mask[:, c * chunk:(c + 1) * chunk])
        loss, mass = checkpoint(_chunk_xent, *args, use_reentrant=False) \
            if grad else _chunk_xent(*args)
        losses.append(loss)
        masses.append(mass)
    return torch.stack(losses).sum() / torch.stack(masses).sum().clamp_min(1.0)


def loss_fn(model: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``targets``
    ``[B, S]`` and an optional float ``mask``)."""
    x = forward(model, cfg, batch["tokens"], use_kernel)
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    return softmax_xent(model, cfg, x, targets, mask.float())
