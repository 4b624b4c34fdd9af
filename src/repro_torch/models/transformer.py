"""The model families in PyTorch: parameters, cache, forward, prefill and
decode — the counterpart of the JAX package's ``models/transformer.py``
for every family of the zoo (serving on one device; training on one
device or a device mesh).

The reference scans stacked ``[L, ...]`` parameters with ``lax.scan``; the
port keeps one module per layer in an :class:`LM` and runs them in Python
loops:

* ``dense`` / ``audio`` / ``vlm`` — [attention → MLP] × L
  (:class:`DenseLayer`); the per-layer window array realises gemma2's
  alternating local/global attention;
* ``moe`` — [attention → MoE] × L (a :class:`DenseLayer` whose FFN is a
  :class:`~.layers.MoE`);
* ``ssm`` — [Mamba2] × L (:class:`MambaLayer`);
* ``hybrid`` — the Mamba2 backbone in segments of ``shared_attn_every``
  layers, each followed by shared attention+MLP block ``segment %
  n_shared_blocks`` (a :class:`DenseLayer` without post-norms).

The audio frontend projects ``frames [B, S, D]`` through ``frame_in``; the
vision frontend projects ``patches [B, P, D]`` through ``patch_in`` and
puts them before the token embeddings (:func:`embed_input`); an
encoder-only backbone (hubert) attends non-causally and has its own head.
Training: :func:`loss_fn` (the chunked cross-entropy
:func:`softmax_xent`), with ``cfg.remat`` rematerialising each dense
layer, each Mamba2 layer and each shared-block application under grad;
``remat_policy="save_attn"`` keeps each dense layer's attention output
across its recompute (the Mamba layers and shared blocks recompute
everything, as in the reference).

On a device mesh (``ctx``, a :class:`~.layers.MeshContext`) every entry
point takes and gives **each rank's blocks**, laid out as the reference's
``in_shardings``/``out_shardings`` lay its arrays out:
:func:`shard_batch` gives a rank its block of each input (tokens, targets
and mask over ``(batch, model)``, frames and patches over ``(batch,
model, None)``, a decode step's tokens over the batch axes) and binds the
global ``(B, S)`` into ``ctx``, which the entry points read (an unbound
``ctx``, or inputs that are not its blocks, raise). The embedding moves
the blocks into the residual stream (vocab-parallel above 4,096 tokens:
the ids all-gathered over the model axis, a masked gather of the model
rank's table rows, summed over it), the stack runs on this rank's
``[B/data, S/model, D]`` block, and the loss is the global mean — its
masked numerator and token count each summed over the mesh before the
division. :func:`prefill` and :func:`decode_step` give each rank its rows
× ``V_pad/model`` block of the logits (:func:`gather_logits` makes them
whole). :func:`param_pspecs` gives the reference's sharding specs as
tuples of axis names.
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

from repro_torch.distributed import collectives as C
from repro_torch.kernels.flash_attention import AttentionStash

from . import layers as L
from .config import ATTN_SWA, MAMBA, ModelConfig
from .layers import MeshContext, cst

__all__ = ["Cache", "CacheLayout", "DenseLayer", "LM", "MambaLayer",
           "cache_pspecs", "cache_spec", "decode_step", "embed_input",
           "embed_tokens", "forward", "gather_cache", "gather_logits",
           "init_cache", "init_params", "leaf_pspecs", "logits_fn",
           "loss_fn", "param_pspecs", "prefill", "retarget_fsdp",
           "shard_batch", "shard_cache",
           "run_attention_stack", "run_hybrid_stack", "run_mamba_stack",
           "softmax_xent"]

# ===========================================================================
# Parameters
# ===========================================================================

class DenseLayer(nn.Module):
    """One [attention → FFN] layer (or a hybrid's shared block): RMSNorm
    scales ``ln1``/``ln2`` (and gemma2's post-norms ``ln_pa``/``ln_pf``),
    :class:`~.layers.Attention`, and the FFN: an :class:`~.layers.MLP`
    (held as ``mlp``) or, in the MoE family, an :class:`~.layers.MoE`
    (held as ``moe``, the reference's names)."""

    def __init__(self, ln1, attn: L.Attention, ln2, ffn, ln_pa=None,
                 ln_pf=None):
        super().__init__()
        self.ln1, self.ln2 = L._param(ln1), L._param(ln2)
        self.attn = attn
        self.mlp = ffn if isinstance(ffn, L.MLP) else None
        self.moe = ffn if isinstance(ffn, L.MoE) else None
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
    """Token embedding ``tok [V_pad, D]`` and the frontends' ``frame_in``
    (audio) or ``patch_in`` (vision) ``[D, D]`` (``None`` without one);
    the attention layers (``layers``: dense, moe, audio, vlm), the Mamba2
    layers (``mamba``, ssm and hybrid) and the shared blocks (``shared``,
    hybrid); the final norm scale; an untied ``head [D, V_pad]``
    (``None`` when tied)."""

    def __init__(self, tok, final_norm, head=None, *, layers=(), mamba=(),
                 shared=(), frame_in=None, patch_in=None):
        super().__init__()
        self.tok = L._param(tok)
        self.frame_in = None if frame_in is None else L._param(frame_in)
        self.patch_in = None if patch_in is None else L._param(patch_in)
        self.layers = nn.ModuleList(layers)
        self.mamba = nn.ModuleList(mamba)
        self.shared = nn.ModuleList(shared)
        self.final_norm = L._param(final_norm)
        self.head = None if head is None else L._param(head)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (default the
    generator's): Normal(0, 0.02) weights, zero norm scales (a gain of 1),
    zero padded heads, the Mamba blocks' ``A_log``/``dt_bias`` schedules.
    The reference's layout and distribution, not its numbers. (The dry run
    draws fake CUDA tensors from a CPU generator.)"""
    pdt = L.torch_dtype(cfg.param_dtype)
    D, Vp = cfg.d_model, cfg.vocab_pad
    dev = generator.device if device is None else device

    def zeros():
        return torch.zeros(D, dtype=pdt, device=dev)

    def dense_layer(post_norms: bool, moe: bool = False) -> DenseLayer:
        attn = L.init_attention(cfg, generator, pdt, dev)
        ffn = (L.init_moe if moe else L.init_mlp)(cfg, generator, pdt, dev)
        post = (zeros(), zeros()) if post_norms else (None, None)
        return DenseLayer(zeros(), attn, zeros(), ffn, *post)

    tok = L._normal((Vp, D), generator, pdt, device=dev)
    parts = {}
    if cfg.frontend == "audio":
        parts["frame_in"] = L._normal((D, D), generator, pdt, device=dev)
    if cfg.frontend == "vision":
        parts["patch_in"] = L._normal((D, D), generator, pdt, device=dev)
    if cfg.family not in ("ssm", "hybrid"):
        parts["layers"] = [dense_layer(cfg.post_norms, bool(cfg.n_experts))
                           for _ in range(cfg.n_layers)]
    else:
        parts["mamba"] = [MambaLayer(zeros(), L.init_mamba(cfg, generator,
                                                           pdt, dev))
                          for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            parts["shared"] = [dense_layer(False)
                               for _ in range(cfg.n_shared_blocks)]
    head = None if cfg.tie_embeddings and not cfg.encoder_only \
        else L._normal((D, Vp), generator, pdt, device=dev)
    return LM(tok, zeros(), head, **parts)


# ===========================================================================
# Parameter sharding specs (FSDP over 'data', TP over 'model')
# ===========================================================================

Spec = Tuple[Optional[str], ...]


def param_pspecs(cfg: ModelConfig, stacked: bool = True) -> Dict:
    """The reference's ``param_pspecs``: a tree mirroring its parameter
    tree (``{"embed": {"tok": ...}, "layers": {"attn": {"wq": ...}}, ...}``)
    whose leaves are tuples of axis names (a ``PartitionSpec``'s entries).
    Stacked per-layer leaves get a leading ``None`` (the layer dimension
    unsharded); hybrid shared blocks are stacked over ``n_shared_blocks``
    whatever ``stacked`` says, as in the reference."""
    def st(*spec) -> Spec:
        return ((None,) + spec) if stacked else spec

    attn = {"wq": st("data", "model", None), "wk": st("data", "model", None),
            "wv": st("data", "model", None), "wo": st("model", None, "data")}
    mlp = {"w_gate": st("data", "model"), "w_up": st("data", "model"),
           "w_down": st("model", "data")}
    norm = {"scale": st(None)}
    specs: Dict = {"embed": {"tok": ("model", "data")}}
    if cfg.frontend == "audio":
        specs["embed"]["frame_in"] = ("data", "model")
    if cfg.frontend == "vision":
        specs["embed"]["patch_in"] = ("data", "model")
    if cfg.family in ("hybrid", "ssm"):
        mamba = {
            "in_proj": st("data", "model"), "conv_w": st(None, "model"),
            "conv_b": st("model"), "A_log": st(None), "D_skip": st(None),
            "dt_bias": st(None), "norm_scale": st("model"),
            "out_proj": st("model", "data")}
        specs["mamba"] = {"block": mamba, "ln": norm}
        if cfg.family == "hybrid":
            specs["shared"] = {
                "ln1": {"scale": (None, None)},
                "attn": {"wq": (None, "data", "model", None),
                         "wk": (None, "data", "model", None),
                         "wv": (None, "data", "model", None),
                         "wo": (None, "model", None, "data")},
                "ln2": {"scale": (None, None)},
                "mlp": {"w_gate": (None, "data", "model"),
                        "w_up": (None, "data", "model"),
                        "w_down": (None, "model", "data")}}
    else:
        lp: Dict = {"ln1": norm, "attn": attn, "ln2": norm}
        if cfg.n_experts:
            if cfg.n_experts % max(cfg.tp_shards, 1) == 0:
                lp["moe"] = {"router": st(None, None),
                             "w_gate": st("model", "data", None),
                             "w_up": st("model", "data", None),
                             "w_down": st("model", None, "data")}
            else:
                lp["moe"] = {"router": st(None, None),
                             "w_gate": st(None, "data", "model"),
                             "w_up": st(None, "data", "model"),
                             "w_down": st(None, "model", "data")}
        else:
            lp["mlp"] = mlp
        if cfg.post_norms:
            lp["ln_pa"] = norm
            lp["ln_pf"] = norm
        specs["layers"] = lp
    specs["final_norm"] = {"scale": (None,)}
    if cfg.encoder_only or not cfg.tie_embeddings:
        specs["head"] = ("data", "model")
    return specs


def retarget_fsdp(spec_tree, fsdp_axes):
    """The reference's ``retarget_fsdp``: the spec tree (dicts and named
    tuples of spec tuples, as :func:`param_pspecs` and
    ``train_state_pspecs`` give) with every ``"data"`` (FSDP) entry
    replaced by ``fsdp_axes``, e.g. ``("pod", "data")``, so the state
    shards over the whole data-parallel domain. The port's own sharding
    reads ``"data"`` as :attr:`~.layers.MeshContext.fsdp_axes`, which are
    already the batch axes (``("pod", "data")`` on the multi-pod mesh), so
    ``shard_train_state`` lays a multi-pod state out this way without it;
    the dry run writes and compares the retargeted trees."""
    if fsdp_axes == "data":
        return spec_tree

    def fix(node):
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(fix(v) for v in node))
        return tuple(fsdp_axes if a == "data" else a for a in node)

    return fix(spec_tree)


def leaf_pspecs(model: LM, cfg: Optional[ModelConfig] = None, *,
                tree: Optional[Dict] = None) -> Dict[str, Spec]:
    """``{parameter name: spec}`` for the port's parameters, through
    :func:`~repro_torch.convert.reference_leaves`: a per-layer parameter
    takes its stacked leaf's spec without the leading ``None``. The specs
    are ``tree`` (a tree of the reference's shape, as
    :func:`param_pspecs` gives) or ``param_pspecs(cfg)``."""
    from repro_torch.convert import reference_leaves

    if tree is None:
        tree = param_pspecs(cfg)
    out: Dict[str, Spec] = {}
    for leaf in reference_leaves(model):
        spec = tree
        for key in leaf.path.split("/"):
            spec = spec[key]
        for name in leaf.names:
            out[name] = spec[1:] if leaf.stacked else spec
    return {name: out[name] for name, _ in model.named_parameters()}


# ===========================================================================
# Embedding / head
# ===========================================================================

def embed_tokens(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
                 ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """``[B, S]`` token ids → ``[B, S, D]`` in the compute dtype (times
    ``sqrt(D)``, rounded to that dtype, with ``scale_embed``).

    With ``ctx`` (bound to the ids' global ``(B, S)``): this rank's
    ``(batch, model)`` block of the ids in, its block of the residual
    stream out (:meth:`~.layers.MeshContext.stream`)."""
    x, layout = _embed_block(model, cfg, tokens, ctx)
    if ctx is None:
        return x
    return cst(ctx, x, *ctx.stream(), frm=layout)


def _embed_block(model: LM, cfg: ModelConfig, tokens: torch.Tensor,
                 ctx: Optional[MeshContext]):
    """``(x, layout)``: the embedding of this rank's block of the ids (on a
    mesh, ``ctx`` bound to their global shape) and the layout ``x`` is in.
    Decode-sized inputs (at most 4,096 tokens) and a batch that does not
    divide the data axes take a plain lookup of the block, ``(batch,
    model, None)``; else the lookup is vocab-parallel, the reference's
    ``shard_map`` body: the ids all-gathered over the model axis (its
    ``in_specs``), this model rank's ``V_pad/model`` table rows (the FSDP
    shard all-gathered), a masked gather, a psum over the model axis,
    ``(batch, None, None)``."""
    dt = L.torch_dtype(cfg.dtype)
    layout = ("batch", "model", None)
    if ctx is not None:
        _expect_block(ctx, tokens, ("batch", "model"), "token ids")
    if not _vocab_parallel(ctx):
        x = model.tok[tokens].to(dt)
    else:
        layout = ("batch", None, None)
        tokens = cst(ctx, tokens, "batch", None, frm=("batch", "model"))
        L._divides(ctx, "vocabulary rows", cfg.vocab_pad)
        rows = L._model_slice(ctx, cfg.vocab_pad)
        table = L._fsdp(ctx, L._part(model.tok, 0, cfg.vocab_pad, rows)
                        .to(dt), 1, cfg.d_model)
        local = tokens - rows.start
        ok = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)] * ok[..., None].to(dt)
        x = C.psum(x, ctx.model_axis, mesh=ctx.mesh)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x, layout


def _vocab_parallel(ctx: Optional[MeshContext]) -> bool:
    """Whether :func:`embed_tokens` looks ids up vocab-parallel: on a mesh
    bound to the ids' global ``(B, S)``, above 4,096 tokens, a batch that
    divides the data axes (the reference decides on the global shape)."""
    if ctx is None:
        return False
    B, S = _bound(ctx).shape
    return B * S > 4096 and B % ctx.data_size == 0


def _bound(ctx: MeshContext) -> MeshContext:
    """``ctx``, which must be bound to the inputs' global shape."""
    if ctx.shape is None:
        raise ValueError("on a mesh the entry points take each rank's "
                         "blocks of the inputs: bind their global (B, S) "
                         "into the MeshContext with shard_batch")
    return ctx


def _expect_block(ctx: MeshContext, t: torch.Tensor, layout, what: str
                  ) -> None:
    """Raise unless ``t``'s leading dimensions are this rank's block,
    under ``layout`` (entries ``"batch"``, ``"model"`` or None), of the
    global shape ``ctx`` is bound to."""
    shape = _bound(ctx).shape[:len(layout)]
    want = tuple(size // ctx.block(dim, name, size)[0]
                 for dim, (name, size) in enumerate(zip(layout, shape)))
    if tuple(t.shape[:len(want)]) != want:
        raise ValueError(
            f"{what} {tuple(t.shape)}: on a mesh an entry point takes this "
            f"rank's {want} block of the global {tuple(shape)} "
            f"({layout}); shard_batch gives it")


def embed_input(model: LM, cfg: ModelConfig,
                tokens: Optional[torch.Tensor] = None, *,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None,
                ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The model's input ``[B, S, D]`` in the compute dtype: ``frames [B,
    S, D] @ frame_in`` (audio), ``patches [B, P, D] @ patch_in`` followed
    by the embedded ``tokens [B, S_t]`` (vision: S = P + S_t, P =
    ``cfg.n_vision_tokens``), or the embedded tokens (the reference's
    ``embed_input`` over its ``batch`` dict). With ``ctx`` (bound by
    :func:`shard_batch`): this rank's blocks in, its stream block out —
    frames projected on their ``(batch, model, None)`` block, a vision
    model's patches and tokens each on its block and all-gathered over the
    model axis for the concatenation, as GSPMD reshards them."""
    dt = L.torch_dtype(cfg.dtype)
    if cfg.frontend == "audio":
        if frames is None:
            raise ValueError(f"{cfg.name} (audio) takes frames")
    elif tokens is None or (cfg.frontend == "vision" and patches is None):
        raise ValueError(f"{cfg.name} takes tokens" + (
            " after its patches" if cfg.frontend == "vision" else ""))
    if cfg.frontend == "audio":
        if ctx is not None:
            _expect_block(ctx, frames, ("batch", "model"), "frames")
        x = L.dense(frames.to(dt), model.frame_in, dt)
        return cst(ctx, x, *ctx.stream(), frm=("batch", "model", None)) \
            if ctx is not None else x
    if ctx is None:
        x = embed_tokens(model, cfg, tokens)
        if cfg.frontend == "vision":
            x = torch.cat([L.dense(patches.to(dt), model.patch_in, dt), x],
                          1)
        return x
    if cfg.frontend != "vision":
        return embed_tokens(model, cfg, tokens, ctx)
    B, S = _bound(ctx).shape
    P = cfg.n_vision_tokens
    pctx, tctx = ctx.at(B, P), ctx.at(B, S - P)
    _expect_block(pctx, patches, ("batch", "model"), "patches")
    px = L.dense(patches.to(dt), model.patch_in, dt)
    x, layout = _embed_block(model, cfg, tokens, tctx)
    x = torch.cat([cst(pctx, px, "batch", None, None,
                       frm=("batch", "model", None)),
                   cst(tctx, x, "batch", None, None, frm=layout)], 1)
    return cst(ctx, x, *ctx.stream(), frm=("batch", None, None))


def logits_fn(model: LM, cfg: ModelConfig, x: torch.Tensor,
              ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Final norm and head (tied: the embedding's transpose), float32
    logits, logit softcap, and −1e30 added on padded vocab slots. With
    ``ctx``: this rank's ``V_pad/model`` columns of them (the head's
    columns, a tied table's rows; the whole vocabulary where it does not
    divide the model axis), the padded slots by their global index — the
    reference's ``out_shardings`` of a prefill's or decode step's
    logits."""
    dt = L.torch_dtype(cfg.dtype)
    Vp, V = cfg.vocab_pad, cfg.vocab_size
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    cols = None if ctx is None else L._model_slice(ctx, Vp)
    w = L._part(model.tok, 0, Vp, cols).T if model.head is None \
        else L._part(model.head, 1, Vp, cols)
    logits = (x @ w.to(dt)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    lo = 0 if cols is None else cols.start
    if lo + logits.shape[-1] > V:         # out of place: autograd-safe
        k = max(V - lo, 0)
        logits = torch.cat([logits[..., :k], logits[..., k:] + -1e30], -1)
    return logits


# ===========================================================================
# Inputs and logits on a mesh
# ===========================================================================

def shard_batch(batch: Dict[str, torch.Tensor], ctx: MeshContext,
                grad_accum: int = 1
                ) -> Tuple[Dict[str, torch.Tensor], MeshContext]:
    """``(blocks, ctx.at(B, S))``: this rank's block of each input of the
    global ``batch`` — the port's stand-in for the reference's
    ``in_shardings`` (``launch/specs._batch_struct``): ``tokens``,
    ``targets`` and ``mask`` ``[B, S]`` over (batch axes, model),
    ``frames``/``patches`` ``[B, S, D]`` over (batch axes, model, None), a
    decode step's ``tokens [B]`` over the batch axes; a dimension whose
    size does not divide its axes stays whole (``leaf_split``'s rule).
    ``(B, S)`` is the global shape the entry points read: ``frames``'s,
    the patches and tokens together, or ``(B, 1)`` for a decode step.

    With ``grad_accum = a``, the rows are this rank's block of each
    microbatch in turn, as the reference's step slices global rows ``[i ·
    B/a, (i+1) · B/a)`` and then splits them over the batch axes (so a
    data rank's MoE routes, and drops, the tokens the reference's device
    does). Each block is a copy holding only its own elements."""
    if "frames" in batch:
        B, S = batch["frames"].shape[:2]
    else:
        tok = batch["tokens"]
        B = tok.shape[0]
        S = 1 if tok.ndim == 1 else tok.shape[1] + (
            batch["patches"].shape[1] if "patches" in batch else 0)
    if B % grad_accum:
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{grad_accum} microbatches")
    rows = B // grad_accum
    n, i, _ = ctx.block(0, "batch", rows)
    blocks = {}
    for key, t in batch.items():
        if t.shape[0] != B:
            raise ValueError(f"{key} {tuple(t.shape)} does not hold the "
                             f"batch's {B} rows")
        t = t.unflatten(0, (grad_accum, rows)).narrow(1, i * (rows // n),
                                                      rows // n)
        t = t.flatten(0, 1)
        if t.ndim > 1:
            m, j, _ = ctx.block(1, "model", t.shape[1])
            t = t.narrow(1, j * (t.shape[1] // m), t.shape[1] // m)
        blocks[key] = t.clone(memory_format=torch.contiguous_format)
    return blocks, ctx.at(B, S)


@torch.no_grad()
def gather_logits(logits: torch.Tensor, ctx: Optional[MeshContext],
                  cfg: ModelConfig) -> torch.Tensor:
    """The whole ``[B, V_pad]`` logits from every rank's block of a
    :func:`prefill` or :func:`decode_step` (``ctx`` the one it ran with),
    as ``np.asarray`` of the reference's sharded output gives them: a
    collective, every rank calls it. For tests and tools: nothing on the
    serving path calls it."""
    if ctx is None:
        return logits
    n, _, axis = ctx.block(0, "batch", _bound(ctx).shape[0])
    if n > 1:
        logits = C.all_gather(logits, axis, 0, mesh=ctx.mesh)
    if L._model_slice(ctx, cfg.vocab_pad) is not None and \
            ctx.model_size > 1:
        logits = C.all_gather(logits, ctx.model_axis, logits.ndim - 1,
                              mesh=ctx.mesh)
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
                 use_kernel: Optional[bool],
                 stash: Optional[AttentionStash] = None,
                 ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """One [attention → MLP or MoE] layer with its residuals; ``stash``
    keeps its attention output across a recompute (``save_attn``). A
    layer stored as blocks materializes its weights here
    (:func:`~.layers.local_params`)."""
    lp = L.local_params(lp, cfg, ctx)
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    a, _ = L.attention_block(lp.attn, cfg, h, start, window=window,
                             kv_cache=kv, kv_len=kv_len, ring=ring,
                             use_kernel=use_kernel, stash=stash, ctx=ctx)
    if lp.ln_pa is not None:
        a = L.rms_norm(a, lp.ln_pa, cfg.norm_eps)
    x = x + a
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    f = L.mlp_block(lp.mlp, cfg, h, ctx) if lp.moe is None \
        else L.moe_block(lp.moe, cfg, h, ctx)
    if lp.ln_pf is not None:
        f = L.rms_norm(f, lp.ln_pf, cfg.norm_eps)
    return x + f


def _remat(cfg: ModelConfig) -> bool:
    """Whether to rematerialise each layer: ``cfg.remat`` under grad. Only
    the residual stream between layers is kept, and the layer is
    recomputed in the backward (the reference's ``nothing_saveable``);
    :func:`run_attention_stack` also keeps each attention output under
    ``remat_policy="save_attn"``."""
    return cfg.remat and torch.is_grad_enabled()


def run_attention_stack(model: LM, cfg: ModelConfig, x: torch.Tensor,
                        start: int, cache: Optional["Cache"] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        ring: bool = False,
                        use_kernel: Optional[bool] = None,
                        ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The layers in order (the reference's ``lax.scan``). With a cache,
    layer ``i`` reads and writes ``cache.kv_k[i]``/``cache.kv_v[i]`` in
    place. Without one, under grad and with ``cfg.remat``, each layer runs
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
    with its ``_remat_policy``: ``nothing_saveable``, or under
    ``"save_attn"`` the attention output kept in an
    :class:`~repro_torch.kernels.flash_attention.AttentionStash`, with the
    forward's lse, so the recompute launches no second B4; on a mesh the
    recompute runs the layer's collectives again, in the same order on
    every rank). Returns the final hidden state."""
    remat = cache is None and _remat(cfg)
    save_attn = remat and cfg.remat_policy == "save_attn"
    for i, (lp, window) in enumerate(zip(model.layers, _window_array(cfg))):
        kv = None if cache is None else (cache.kv_k[i], cache.kv_v[i])
        args = (lp, cfg, x, start, int(window), kv, kv_len, ring, use_kernel)
        stash = AttentionStash() if save_attn else None
        x = checkpoint(_dense_layer, *args, stash, ctx,
                       use_reentrant=False) \
            if remat else _dense_layer(*args, None, ctx)
    return x


def _mamba_layer(lp: MambaLayer, cfg: ModelConfig, x: torch.Tensor,
                 use_kernel: Optional[bool],
                 ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """One pre-norm Mamba2 layer with its residual, from a zero state."""
    lp = L.local_params(lp, cfg, ctx)
    m, _ = L.mamba_block(lp.block, cfg, L.rms_norm(x, lp.ln, cfg.norm_eps),
                         use_kernel=use_kernel, ctx=ctx)
    return x + m


def run_mamba_stack(model: LM, cfg: ModelConfig, x: torch.Tensor,
                    cache: Optional["Cache"] = None,
                    use_kernel: Optional[bool] = None,
                    layers: Optional[range] = None,
                    ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The Mamba2 layers ``layers`` (all by default) in order. With a
    cache, layer ``i`` continues from ``cache.conv[i]``/``cache.ssm[i]``
    and writes its new state there in place. Without one, under grad and
    with ``cfg.remat``, each layer runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint`` with ``nothing_saveable``).
    Returns the hidden state."""
    remat = cache is None and _remat(cfg)
    for i in layers if layers is not None else range(len(model.mamba)):
        lp = model.mamba[i]
        if cache is None:
            x = checkpoint(_mamba_layer, lp, cfg, x, use_kernel, ctx,
                           use_reentrant=False) if remat \
                else _mamba_layer(lp, cfg, x, use_kernel, ctx)
            continue
        lp = L.local_params(lp, cfg, ctx)
        h = L.rms_norm(x, lp.ln, cfg.norm_eps)
        m, (conv, ssm) = L.mamba_block(lp.block, cfg, h,
                                       cache=(cache.conv[i], cache.ssm[i]),
                                       use_kernel=use_kernel, ctx=ctx)
        cache.conv[i].copy_(conv)
        cache.ssm[i].copy_(ssm)
        x = x + m
    return x


def _shared_block(sp: DenseLayer, cfg: ModelConfig, x: torch.Tensor,
                  start: int, kv, kv_len: Optional[torch.Tensor],
                  use_kernel: Optional[bool],
                  ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """A hybrid's shared block (full attention, then the MLP) with its
    residuals."""
    h = L.rms_norm(x, sp.ln1, cfg.norm_eps)
    a, _ = L.attention_block(sp.attn, cfg, h, start, window=0, kv_cache=kv,
                             kv_len=kv_len, use_kernel=use_kernel, ctx=ctx)
    x = x + a
    h = L.rms_norm(x, sp.ln2, cfg.norm_eps)
    return x + L.mlp_block(sp.mlp, cfg, h, ctx)


def run_hybrid_stack(model: LM, cfg: ModelConfig, x: torch.Tensor,
                     start: int, cache: Optional["Cache"] = None,
                     kv_len: Optional[torch.Tensor] = None,
                     use_kernel: Optional[bool] = None,
                     ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Zamba2: after each segment of ``shared_attn_every`` Mamba layers,
    shared block ``segment % n_shared_blocks`` (full attention, then the
    MLP). With a cache, application ``segment`` of a shared block reads and
    writes KV slot ``segment``. Without one, under grad and with
    ``cfg.remat``, each Mamba layer and each shared-block application is
    checkpointed on its own, as the reference does. Returns the hidden
    state."""
    k = cfg.shared_attn_every
    remat = cache is None and _remat(cfg)
    # blocks stored as blocks materialize once for all their applications
    shared = [L.local_params(sp, cfg, ctx) for sp in model.shared]
    for seg in range(cfg.n_layers // k):
        x = run_mamba_stack(model, cfg, x, cache, use_kernel,
                            range(seg * k, (seg + 1) * k), ctx)
        sp = shared[seg % cfg.n_shared_blocks]
        kv = None if cache is None else (cache.kv_k[seg], cache.kv_v[seg])
        args = (sp, cfg, x, start, kv, kv_len, use_kernel, ctx)
        x = checkpoint(_shared_block, *args, use_reentrant=False) if remat \
            else _shared_block(*args)
    return x


def _run_stack(model: LM, cfg: ModelConfig, x: torch.Tensor, start: int,
               cache: Optional["Cache"], kv_len: Optional[torch.Tensor],
               ring: bool, use_kernel: Optional[bool],
               ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The family's layer stack."""
    if cfg.family == "ssm":
        return run_mamba_stack(model, cfg, x, cache, use_kernel, ctx=ctx)
    if cfg.family == "hybrid":
        return run_hybrid_stack(model, cfg, x, start, cache, kv_len,
                                use_kernel, ctx)
    return run_attention_stack(model, cfg, x, start, cache, kv_len, ring,
                               use_kernel, ctx)


# ===========================================================================
# Cache and the forward passes
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """How a cache on a mesh is laid out: each field's spec
    (:func:`cache_pspecs`: a tuple of axes, ``"model"`` or None a
    dimension), its whole shape, whether the KV cache's sequence lies over
    the batch axes, and ``conv``: the conv channels' groups ``[x | B |
    C]`` as :func:`~.layers.mamba_channels` gives them, each model rank
    keeping its part of each group in that order (None where every rank
    keeps every channel). Where every group splits, a rank holds ``1 /
    model`` of the ``d_inner + 2N`` channels, as the reference's even
    split does. A dimension whose size does not divide its axes stays
    whole, as :func:`~.layers.leaf_split` says."""
    specs: Dict[str, Spec]
    shapes: Dict[str, Tuple[int, ...]]
    shard_seq: bool = False
    conv: Optional[Tuple[Tuple[int, bool], ...]] = None


@dataclasses.dataclass
class Cache:
    """Decode-time state, updated in place. Fields a family does not use
    hold zero-size tensors, as in the reference.

    ``kv_k``/``kv_v``: ``[L_attn, B, Sc, Hkv_pad, hd]`` in the compute
    dtype. ``conv``: ``[L_mamba, B, cw-1, din + 2N]`` in the compute dtype;
    ``ssm``: ``[L_mamba, B, H, P, N]`` float32. ``pos``: the next position
    to write, the same in every row (static batching), kept as a host int —
    the reference keeps a ``[B]`` array. On a mesh each field is this
    rank's block, as ``layout`` says (None: whole tensors, one device).
    """
    kv_k: torch.Tensor
    kv_v: torch.Tensor
    conv: torch.Tensor
    ssm: torch.Tensor
    pos: int = 0
    layout: Optional[CacheLayout] = None

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


_FIELDS = ("kv_k", "kv_v", "conv", "ssm")


def cache_pspecs(cfg: ModelConfig, batch_axes=("data",),
                 shard_seq: bool = False) -> Dict[str, Spec]:
    """The reference's cache layout (``specs._cache_struct``, its
    ``cache_pspecs`` over ``batch_axes``): batch over the batch axes, KV
    heads, conv channels and SSM heads over ``"model"``; with
    ``shard_seq`` (batch 1) the KV cache's sequence over the batch axes
    instead of its batch. An attention-free family keeps its (empty) KV
    heads whole."""
    b = tuple(batch_axes)
    kv_head = "model" if cache_spec(cfg, 1, 1)[0]["kv_k"][0][0] else None
    rows, seq = (None, b) if shard_seq else (b, None)
    return {"kv_k": (None, rows, seq, kv_head, None),
            "kv_v": (None, rows, seq, kv_head, None),
            "conv": (None, rows, None, "model"),
            "ssm": (None, rows, "model", None, None)}


def _cache_layout(cfg: ModelConfig, batch: int, max_seq: int,
                  ctx: MeshContext, shard_seq: bool) -> CacheLayout:
    spec, _ = cache_spec(cfg, batch, max_seq)
    return CacheLayout(
        cache_pspecs(cfg, ctx.batch_axes, shard_seq),
        {k: tuple(s) for k, (s, _) in spec.items()}, shard_seq,
        L.mamba_channels(cfg, ctx) if spec["ssm"][0][2] else None)


def _block(t: torch.Tensor, field: str, layout: CacheLayout,
           ctx: MeshContext) -> torch.Tensor:
    """This rank's block of the whole cache field ``t``."""
    spec = layout.specs[field]
    if field != "conv":
        return L.block_of(t, spec, ctx)
    t = L.block_of(t, spec[:-1] + (None,), ctx)
    if layout.conv is None:
        return t
    m, i = ctx.model_size, ctx.model_index
    parts, off = [], 0
    for size, split in layout.conv:
        own = size // m if split else size
        parts.append(t[..., off + i * own:off + (i + 1) * own] if split
                     else t[..., off:off + size])
        off += size
    return torch.cat(parts, -1)


def _whole(t: torch.Tensor, field: str, layout: CacheLayout,
           ctx: MeshContext) -> torch.Tensor:
    """The whole cache field from every rank's block ``t`` (a collective
    over the axes the field is split over: every rank calls it)."""
    shape = layout.shapes[field]
    if not int(np.prod(shape)):
        return t.new_zeros(shape)
    spec = layout.specs[field]
    if field != "conv":
        return L.whole_of(t, spec, shape, ctx)
    rows = L.whole_of(t, spec[:-1] + (None,), shape[:-1] + t.shape[-1:],
                      ctx)
    if layout.conv is None:
        return rows
    m = ctx.model_size
    blocks = C.all_gather(rows, ctx.model_axis, 0, tiled=False,
                          mesh=ctx.mesh)
    parts, off = [], 0
    for size, split in layout.conv:
        own = size // m if split else size
        parts += [blocks[r][..., off:off + own]
                  for r in (range(m) if split else (0,))]
        off += own
    return torch.cat(parts, -1)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device, ctx: Optional[MeshContext] = None,
               shard_seq: bool = False) -> Tuple[Cache, bool]:
    """A zeroed cache on ``device`` and whether its KV part is a ring.
    With ``ctx``: this rank's block of each field as :func:`cache_pspecs`
    lays it out (``shard_seq``: the KV cache's slots over the batch axes,
    for decode at batch 1)."""
    spec, ring = cache_spec(cfg, batch, max_seq)
    if ctx is None:
        return Cache(**{k: torch.zeros(s, dtype=d, device=device)
                        for k, (s, d) in spec.items()}), ring
    layout = _cache_layout(cfg, batch, max_seq, ctx, shard_seq)
    fields = {k: torch.zeros(_block(torch.empty(s, device="meta"), k,
                                    layout, ctx).shape, dtype=d,
                             device=device)
              for k, (s, d) in spec.items()}
    return Cache(**fields, layout=layout), ring


@torch.no_grad()
def gather_cache(cache: Cache, ctx: Optional[MeshContext]) -> Cache:
    """The whole cache from every rank's blocks, in the reference's order
    (the conv channels ``[x | B | C]``): a collective, every rank calls it.
    A cache without a layout is returned as it is."""
    if cache.layout is None:
        return cache
    return Cache(**{k: _whole(getattr(cache, k), k, cache.layout, ctx)
                    for k in _FIELDS}, pos=cache.pos)


@torch.no_grad()
def shard_cache(cache: Cache, ctx: MeshContext,
                shard_seq: bool = True) -> Cache:
    """``cache`` (whole, or this rank's blocks in another layout) as this
    rank's blocks of the layout ``shard_seq`` names: a batch-1 prefill's
    cache, whose rows stay whole over the batch axes, into the decode
    layout with the KV cache's slots over them."""
    layout = cache.layout
    if layout is None:
        raise ValueError("shard_cache takes a cache made for the mesh "
                         "(init_cache(ctx=...)), whose layout it reads")
    whole = gather_cache(cache, ctx)
    rows, seq = (None, tuple(ctx.batch_axes)) if shard_seq else (
        tuple(ctx.batch_axes), None)
    specs = {k: (sp[0], rows) + ((seq,) + sp[3:] if k.startswith("kv")
                                 else sp[2:])
             for k, sp in layout.specs.items()}
    layout = dataclasses.replace(layout, shard_seq=shard_seq, specs=specs)
    return Cache(**{k: _block(getattr(whole, k), k, layout, ctx).clone()
                    for k in _FIELDS}, pos=cache.pos, layout=layout)


def _local_model(model, cfg: ModelConfig, ctx: Optional[MeshContext],
                 lookup: bool = False, head: bool = False):
    """The model read through its embedding, head, frontends and final
    norm as this rank's working tensors (:func:`~.layers.local_params`,
    once a forward: a tied table's embedding and head, and every chunk of
    the loss, share one materialized copy); a model stored as blocks
    needs its mesh. Used as stored: an untied table's model rows where
    ``lookup`` (the vocab-parallel lookup gathers its FSDP block itself),
    the head's vocabulary block where ``head`` (:func:`logits_fn` on the
    mesh)."""
    if ctx is None and L.is_blocks(model):
        raise ValueError("a model stored as blocks (shard_train_state) "
                         "runs on its mesh: pass ctx")
    kept = {}
    if ctx is not None and model.head is not None:
        if lookup:
            kept["tok"] = (0, 1)
        if head and L._model_slice(ctx, cfg.vocab_pad) is not None:
            kept["head"] = (1,)
    return L.local_params(model, cfg, ctx, recurse=False, kept=kept)


def _token_ctx(cfg: ModelConfig, ctx: Optional[MeshContext]
               ) -> Optional[MeshContext]:
    """``ctx`` bound to the token ids' global shape: a vision model's
    tokens follow its ``n_vision_tokens`` patches."""
    if ctx is None or cfg.frontend != "vision":
        return ctx
    B, S = _bound(ctx).shape
    return ctx.at(B, S - cfg.n_vision_tokens)


def forward(model: LM, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            use_kernel: Optional[bool] = None, *,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Full-sequence forward of ``[B, S]`` tokens (and the frontend's
    ``frames`` or ``patches``, as :func:`embed_input` takes them); the
    final hidden ``[B, S, D]`` (before the final norm). With ``ctx``
    (bound by :func:`shard_batch`): this rank's blocks of the inputs in,
    its ``[B/data, S/model, D]`` block of the final hidden out
    (:meth:`~.layers.MeshContext.stream`)."""
    lookup = tokens is not None and _vocab_parallel(_token_ctx(cfg, ctx))
    model = _local_model(model, cfg, ctx, lookup=lookup)
    x = embed_input(model, cfg, tokens, frames=frames, patches=patches,
                    ctx=ctx)
    return _run_stack(model, cfg, x, 0, None, None, False, use_kernel, ctx)


def _serve_ctx(cache: Cache, ctx: Optional[MeshContext],
               seq: Optional[int] = None) -> Optional[MeshContext]:
    """``ctx`` (bound to the global ``(batch, seq)``; ``seq`` rebinds the
    sequence: 1 for a decode step) and the cache's layout (a mesh's cache
    comes from ``init_cache(ctx=...)``)."""
    if ctx is None:
        if cache.layout is not None:
            raise ValueError("a cache laid out over a mesh needs its ctx")
        return None
    batch = _bound(ctx).shape[0]
    if seq is not None:
        ctx = ctx.at(batch, seq)
    seq = ctx.shape[1]
    if cache.layout is None:
        raise ValueError("on a mesh the cache is each rank's blocks: make "
                         "it with init_cache(ctx=...)")
    if not cache.layout.shard_seq:
        return ctx
    if seq > 1:
        raise ValueError("a prefill fills a cache laid out by rows: lay its "
                         "KV slots over the batch axes after it "
                         "(shard_cache)")
    if ctx.block(0, "batch")[0] > 1:
        raise ValueError(f"a batch of {batch} rows splits over the batch "
                         "axes: lay the cache out by rows (shard_seq="
                         "False), not by slots")
    return dataclasses.replace(ctx,
                               kv_slots=cache.layout.shapes["kv_k"][2])


def _last_position(ctx: Optional[MeshContext], x: torch.Tensor
                   ) -> torch.Tensor:
    """The last position ``[B_rows, 1, D]`` of a stream block: on a mesh
    whose model axis holds the sequence, the last model rank's last
    position, all-gathered over the model axis."""
    if ctx is None:
        return x[:, -1:]
    n, _, axis = ctx.block(1, ctx.stream()[1])
    if n == 1:
        return x[:, -1:]
    return C.all_gather(x[:, -1:], axis, 1, mesh=ctx.mesh)[:, -1:]


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            cache: Cache, ring: bool, use_kernel: Optional[bool] = None, *,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            ctx: Optional[MeshContext] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt (``[B, S]`` tokens, after the patches of a vision
    model, or an audio model's frames) through the model from position 0,
    filling the cache in place. Returns ``(last-position logits [B,
    V_pad], cache)`` with ``cache.pos`` advanced to the sequence length S.
    Inference only: no autograd graph (the parameters are trainable).

    With ``ctx`` (bound by :func:`shard_batch`): this rank's blocks of the
    inputs, the cache this rank's blocks (``init_cache(ctx=...)``, its
    rows laid out by rows), the model replicated or stored as blocks; this
    rank's ``[B_rows, V_pad/model]`` block of the logits
    (:func:`logits_fn`; :func:`gather_logits` makes them whole)."""
    ctx = _serve_ctx(cache, ctx)
    lookup = tokens is not None and _vocab_parallel(_token_ctx(cfg, ctx))
    model = _local_model(model, cfg, ctx, lookup=lookup, head=True)
    x = embed_input(model, cfg, tokens, frames=frames, patches=patches,
                    ctx=ctx)
    B, S = x.shape[:2] if ctx is None else ctx.shape
    kv_len = cst(ctx, torch.full((B,), S, dtype=torch.int32,
                                 device=x.device), "batch")
    x = _run_stack(model, cfg, x, 0, cache, kv_len, ring, use_kernel, ctx)
    cache.pos = S
    return logits_fn(model, cfg, _last_position(ctx, x), ctx)[:, 0], cache


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, ring: bool, use_kernel: Optional[bool] = None,
                ctx: Optional[MeshContext] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step for ``[B]`` tokens at position ``cache.pos``.
    Returns ``(logits [B, V_pad], cache)`` with ``cache.pos`` advanced by
    one. Raises :class:`ValueError` when a non-ring KV cache is full (an
    ssm model has none and decodes on). With ``ctx`` (bound to the global
    batch: :func:`shard_batch` of the step's tokens, or the prefill's):
    this rank's block of the tokens (its rows; every row at batch 1), the
    cache this rank's blocks (at batch 1 perhaps its block of the KV
    slots: ``shard_cache``), this rank's ``[B_rows, V_pad/model]`` block
    of the logits."""
    Sc = cache.kv_k.shape[2] if cache.layout is None else \
        cache.layout.shapes["kv_k"][2]
    if cache.has_kv and not ring and cache.pos >= Sc:
        raise ValueError(f"decode at position {cache.pos} overruns the "
                         f"{Sc}-slot KV cache; allocate a longer cache")
    ctx = _serve_ctx(cache, ctx, seq=1)
    B = token.shape[0] if ctx is None else ctx.shape[0]
    model = _local_model(model, cfg, ctx, lookup=_vocab_parallel(ctx),
                         head=True)
    x = embed_tokens(model, cfg, token[:, None], ctx)
    kv_len = cst(ctx, torch.full((B,), cache.pos + 1, dtype=torch.int32,
                                 device=token.device), "batch")
    x = _run_stack(model, cfg, x, cache.pos, cache, kv_len, ring,
                   use_kernel, ctx)
    cache.pos += 1
    return logits_fn(model, cfg, x, ctx)[:, 0], cache


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
                 ctx: Optional[MeshContext] = None,
                 chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over the (padded) vocabulary. Above 16,384 vocabulary
    slots and ``chunk`` positions it runs chunk by chunk over the sequence,
    each chunk's logits recomputed in the backward (checkpointed), so the
    ``[B, S, V]`` float32 logits never exist at once — the reference's
    ``lax.map`` over ``jax.checkpoint``-ed chunks.

    With ``ctx`` (bound to the global ``[B, S]``): ``x`` is this rank's
    stream block, ``targets``/``mask`` its ``(batch, model)`` blocks
    (:func:`shard_batch`); the masked numerator and the token count are
    each summed over the mesh before the division, a token held by several
    ranks counting on the first of them only. The value is the global
    mean on every rank; its backward is this rank's term of it."""
    if ctx is None:
        loss, mass = _xent_sums(model, cfg, x, targets, mask, chunk)
        return loss / mass.clamp_min(1.0)
    for t, what in ((targets, "targets"), (mask, "mask")):
        _expect_block(ctx, t, ("batch", "model"), what)
    model = _local_model(model, cfg, ctx)
    layout = ctx.stream()[:2]
    targets, mask = (cst(ctx, t, *layout, frm=("batch", "model"))
                     for t in (targets, mask))
    loss, mass = _xent_sums(model, cfg, x, targets, mask, chunk)
    if not ctx.unique(layout):
        loss, mass = loss * 0.0, mass * 0.0
    world = ctx.mesh_axes
    with torch.no_grad():
        total = C.psum(mass.detach(), world, mesh=ctx.mesh).clamp_min(1.0)
    term = loss / total
    with torch.no_grad():
        value = C.psum(term.detach(), world, mesh=ctx.mesh)
    return value + (term - term.detach())     # the value exactly


def _xent_sums(model: LM, cfg: ModelConfig, x: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor, chunk: int):
    """``(Σ masked nll, Σ mask)`` of :func:`softmax_xent`, chunked as it
    says."""
    B, S, _ = x.shape
    if cfg.vocab_pad <= 16384 or S <= chunk:
        return _chunk_xent(model, cfg, x, targets, mask)
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
    return torch.stack(losses).sum(), torch.stack(masses).sum()


def loss_fn(model: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            use_kernel: Optional[bool] = None,
            ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens`` or the
    frontend's ``frames``/``patches``, ``targets`` ``[B, S]`` and an
    optional float ``mask``); with ``ctx`` (bound by :func:`shard_batch`)
    this rank's blocks of the batch and the global mean
    (:func:`softmax_xent`)."""
    lookup = "tokens" in batch and _vocab_parallel(_token_ctx(cfg, ctx))
    model = _local_model(model, cfg, ctx, lookup=lookup)
    x = forward(model, cfg, batch.get("tokens"), use_kernel,
                frames=batch.get("frames"), patches=batch.get("patches"),
                ctx=ctx)
    targets = batch["targets"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    return softmax_xent(model, cfg, x, targets, mask.float(), ctx)
