"""Per-cell specs of the dry run: the port of ``repro.launch.specs``.

:func:`input_specs` gives each model input of a cell as a ``device="meta"``
tensor (the reference's shapes and dtypes, no bytes) with the
reference's layout of it, a tuple of axis names per dimension as
:func:`~repro_torch.models.transformer.param_pspecs` writes specs.
:func:`build_cell` gives ``(step, args, meta)``: the function the cell
runs on one rank of the mesh and its arguments, this rank's blocks of the
state or parameters, the inputs (:func:`~repro_torch.models.transformer
.shard_batch`, the reference's ``in_shardings``) and the cache, made in
the caller's ``FakeTensorMode`` on ``"cuda"`` (the dry run traces
``step(*args)``; nothing is allocated).

The port's arguments are the reference's per device but for the cache's
``pos``, which the port keeps as a host int where the reference's is a
``[B]`` int32 array (:func:`input_specs` gives it, for the shapes). As
everywhere in the port, a size that does not divide its axis stays whole
(:func:`~repro_torch.models.layers.leaf_split`) where GSPMD pads it; no
production cell of one pod has one.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshContext
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_train_step, shard_train_state)

from .shapes import SHAPES, ShapeCell, cell_plan

__all__ = ["OPT_STATE_DTYPE", "TRAIN_PARAM_DTYPE", "build_cell",
           "cell_step", "input_specs", "serving_config", "training_config"]

#: per-arch optimizer-state dtype (the reference's memory fit policy)
OPT_STATE_DTYPE = {"qwen3_moe_235b": "bfloat16"}
#: per-arch master-param dtype for training: qwen3-moe-235b trains with
#: bf16 master parameters, as in the reference; everything else float32
TRAIN_PARAM_DTYPE = {"qwen3_moe_235b": "bfloat16"}

Spec = Tuple[Any, ...]


def training_config(arch: str, tp: int) -> ModelConfig:
    return get_config(arch, tp_shards=tp,
                      param_dtype=TRAIN_PARAM_DTYPE.get(arch, "float32"),
                      dtype="bfloat16", remat=True)


def serving_config(arch: str, tp: int) -> ModelConfig:
    return get_config(arch, tp_shards=tp, param_dtype="bfloat16",
                      dtype="bfloat16", remat=False)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_struct(cfg: ModelConfig, cell: ShapeCell, baxes,
                  with_targets: bool
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """(meta tensors, specs) of a model input batch."""
    B, S = cell.global_batch, cell.seq_len
    i32, f32, act = torch.int32, torch.float32, L.torch_dtype(cfg.dtype)
    st, sp = {}, {}
    if cfg.frontend == "audio":
        st["frames"] = _meta((B, S, cfg.d_model), act)
        sp["frames"] = (baxes, "model", None)
    elif cfg.frontend == "vision":
        nv = cfg.n_vision_tokens
        st["patches"] = _meta((B, nv, cfg.d_model), act)
        sp["patches"] = (baxes, "model", None)
        st["tokens"] = _meta((B, S - nv), i32)
        sp["tokens"] = (baxes, "model")
    else:
        st["tokens"] = _meta((B, S), i32)
        sp["tokens"] = (baxes, "model")
    if with_targets:
        st["targets"] = _meta((B, S), i32)
        sp["targets"] = (baxes, "model")
        st["mask"] = _meta((B, S), f32)
        sp["mask"] = (baxes, "model")
    return st, sp


def _cache_struct(cfg: ModelConfig, B: int, S: int, baxes,
                  shard_seq_cache: bool):
    """(meta tensors, specs, ring) of a decode cache, the reference's
    fields (``pos`` a ``[B]`` int32 array there)."""
    spec, ring = T.cache_spec(cfg, B, S)
    struct = {k: _meta(s, d) for k, (s, d) in spec.items()}
    struct["pos"] = _meta((B,), torch.int32)
    pspecs = dict(T.cache_pspecs(cfg, baxes, shard_seq_cache))
    pspecs["pos"] = (None,) if shard_seq_cache else (baxes,)
    return struct, pspecs, ring


def input_specs(arch: str, shape: str, multi_pod: bool = False,
                tp: int = 16) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell, with
    their specs: ``batch``/``batch_pspecs`` (train, prefill),
    ``cache``/``cache_pspecs``/``ring`` (prefill but encoder-only,
    decode), ``token``/``token_pspecs`` (decode), and ``config``."""
    cell = SHAPES[shape]
    baxes = ("pod", "data") if multi_pod else ("data",)
    if cell.kind == "train":
        cfg = training_config(arch, tp)
        st, sp = _batch_struct(cfg, cell, baxes, with_targets=True)
        return {"batch": st, "batch_pspecs": sp, "config": cfg}
    cfg = serving_config(arch, tp)
    if cell.kind == "prefill":
        st, sp = _batch_struct(cfg, cell, baxes, with_targets=False)
        out = {"batch": st, "batch_pspecs": sp, "config": cfg}
        if not cfg.encoder_only:
            cs, cp, ring = _cache_struct(cfg, cell.global_batch,
                                         cell.seq_len, baxes,
                                         shard_seq_cache=False)
            out.update({"cache": cs, "cache_pspecs": cp, "ring": ring})
        return out
    shard_seq = cell.global_batch == 1
    cs, cp, ring = _cache_struct(cfg, cell.global_batch, cell.seq_len,
                                 baxes, shard_seq_cache=shard_seq)
    tok = _meta((cell.global_batch,), torch.int32)
    tok_sp = (None,) if shard_seq else (baxes,)
    return {"token": tok, "token_pspecs": tok_sp, "cache": cs,
            "cache_pspecs": cp, "ring": ring, "config": cfg}


def _on(meta: torch.Tensor, device) -> torch.Tensor:
    """A tensor of ``meta``'s shape and dtype on ``device`` (fake under the
    caller's fake mode)."""
    return torch.zeros(meta.shape, dtype=meta.dtype, device=device)


def build_cell(arch: str, shape: str, mesh, multi_pod: bool,
               device="cuda"):
    """``(step, args, meta)`` of one cell on this rank of ``mesh`` (the
    production mesh; ``REPRO_SP=1`` turns the Megatron-SP projections on,
    as in the reference). ``meta["kind"]`` is ``train``, ``encode``,
    ``prefill`` or ``decode``; ``meta["config"]`` the config. Call it in
    a ``FakeTensorMode``: the arguments are this rank's blocks of the
    parameters, state, inputs and cache (a decode cache at its last slot,
    so the step attends every slot)."""
    ok, why = cell_plan(arch, shape)
    if not ok:
        raise ValueError(f"cell ({arch}, {shape}) skipped: {why}")
    cell = SHAPES[shape]
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    cfg = (training_config if cell.kind == "train" else serving_config)(
        arch, tp)
    return cell_step(cfg, cell, mesh, multi_pod, device,
                     OPT_STATE_DTYPE.get(arch, "float32"))


def cell_step(cfg: ModelConfig, cell: ShapeCell, mesh, multi_pod: bool,
              device="cuda", opt_state_dtype: str = "float32"):
    """:func:`build_cell` for any config and cell (the tests' smoke
    configs at small shapes): ``(step, args, meta)``."""
    baxes = ("pod", "data") if multi_pod else ("data",)
    sp = os.environ.get("REPRO_SP", "0") == "1"
    ctx = MeshContext(mesh, baxes, sp_matmuls=sp)
    gen = torch.Generator().manual_seed(0)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=opt_state_dtype)
        state = shard_train_state(
            init_train_state(cfg, opt_cfg, gen, device=device), cfg, ctx)
        batch, ctx = T.shard_batch(
            {k: _on(v, device) for k, v in
             _batch_struct(cfg, cell, baxes, True)[0].items()}, ctx)
        return (make_train_step(cfg, opt_cfg, ctx), (state, batch),
                {"config": cfg, "kind": "train"})

    whole = T.init_params(cfg, gen, device=device)
    params = L.shard_module(whole, T.leaf_pspecs(whole, cfg), ctx)
    del whole
    if cell.kind == "prefill":
        batch, ctx = T.shard_batch(
            {k: _on(v, device) for k, v in
             _batch_struct(cfg, cell, baxes, False)[0].items()}, ctx)
        if cfg.encoder_only:
            @torch.no_grad()
            def encode(model, batch):
                # the reference's out_shardings: the stream's block, every
                # vocabulary column
                x = T.forward(model, cfg, ctx=ctx, **batch)
                return T.logits_fn(T._local_model(model, cfg, ctx), cfg, x)
            return encode, (params, batch), {"config": cfg,
                                             "kind": "encode"}
        cache, ring = T.init_cache(cfg, B, S, device, ctx=ctx)

        def prefill_fn(model, batch, cache):
            return T.prefill(model, cfg, batch.get("tokens"), cache, ring,
                             patches=batch.get("patches"),
                             frames=batch.get("frames"), ctx=ctx)

        return prefill_fn, (params, batch, cache), {"config": cfg,
                                                    "kind": "prefill"}

    cache, ring = T.init_cache(cfg, B, S, device, ctx=ctx,
                               shard_seq=B == 1)
    cache.pos = S - 1
    blocks, ctx = T.shard_batch(
        {"tokens": torch.zeros((B,), dtype=torch.int32, device=device)},
        ctx)
    token = blocks["tokens"]

    def decode_fn(model, token, cache):
        return T.decode_step(model, cfg, token, cache, ring, ctx=ctx)

    return decode_fn, (params, token, cache), {"config": cfg,
                                               "kind": "decode"}
