"""Carrying instance state between the JAX reference and the port as
NumPy arrays (the two packages never import each other).

* :func:`from_jax_instance` — the fields of a reference ``JaxInstance``,
  converted to NumPy, into a :class:`TorchInstance`;
* :func:`to_numpy` — the reverse, the same field names as NumPy arrays;
* :func:`placement_to_numpy` — a port placement as an ``[E, P]`` bool
  array the reference's host oracles (``sigma_np``) can score;
* :func:`model_params_from_jax` — the reference's model parameter tree
  (``init_params`` output of any family, stacked ``[L, ...]`` leaves, as
  NumPy) as the port's
  :class:`~repro_torch.models.LM` (any tree shaped like it, such as its
  gradients, converts the same way);
* :func:`train_state_from_jax` — a reference ``TrainState`` (params, AdamW
  step, m, v) as the port's :class:`~repro_torch.training.TrainState`;
* :func:`reference_leaves` — the other way round: for each leaf of the
  reference's stacked tree, the port's parameters that make it, which is
  what :mod:`repro_torch.models.quant` and
  :mod:`repro_torch.distributed.compression` decide and reduce over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.core.instance import TorchInstance
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, DenseLayer, MambaLayer
from repro_torch.training import AdamWState, TrainState, param_tree

__all__ = ["from_jax_instance", "to_numpy", "placement_to_numpy",
           "model_params_from_jax", "train_state_from_jax", "RefLeaf",
           "reference_leaves"]

_INT_FIELDS = ("u_service", "u_edge", "sm_service")
#: Mamba leaves the reference keeps in float32 whatever the param dtype.
_F32_LEAVES = ("A_log", "D_skip", "dt_bias")


def from_jax_instance(arrays: Dict[str, np.ndarray],
                      device: Union[str, torch.device]) -> TorchInstance:
    """Build a :class:`TorchInstance` from ``{u_alpha, …, R, delta_max}``
    NumPy arrays (a ``JaxInstance``'s fields). Ids become int32, floats
    float32, and ``delta_max`` a Python float."""
    out = {}
    for f in dataclasses.fields(TorchInstance):
        a = np.asarray(arrays[f.name])
        if f.name == "delta_max":
            out[f.name] = float(a)
            continue
        dt = np.int32 if f.name in _INT_FIELDS else np.float32
        out[f.name] = torch.from_numpy(
            np.ascontiguousarray(a.astype(dt))).to(device)
    return TorchInstance(**out)


def to_numpy(ti: TorchInstance) -> Dict[str, np.ndarray]:
    """The fields of ``ti`` as NumPy arrays (``delta_max`` as float32, as
    the reference's ``JaxInstance`` holds it)."""
    out = {}
    for f in dataclasses.fields(TorchInstance):
        val = getattr(ti, f.name)
        out[f.name] = (np.float32(val) if f.name == "delta_max"
                       else val.cpu().numpy())
    return out


def placement_to_numpy(x: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    """A placement ``[E, P]`` as a host bool array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=bool)


def model_params_from_jax(cfg: ModelConfig, tree: Dict,
                          device: Union[str, torch.device] = "cpu") -> LM:
    """The reference's parameter tree — ``{"embed": {"tok", ["frame_in"
    | "patch_in"]}, "layers": {"ln1": {"scale"}, "attn": {"wq", …},
    "ln2", "mlp" | "moe": {…}, ["ln_pa", "ln_pf"]}}`` (dense, moe, audio,
    vlm), ``{"mamba": {"block": {"in_proj", …}, "ln": {"scale"}}}`` (ssm),
    the same plus ``{"shared": {"ln1", "attn", "ln2", "mlp"}}`` (hybrid),
    then ``"final_norm": {"scale"}, ["head"]`` — with
    stacked ``[L, ...]`` leaves, as NumPy arrays, as an :class:`LM` on
    ``device``, in ``cfg.param_dtype`` (the Mamba blocks' ``A_log``,
    ``D_skip`` and ``dt_bias`` and the MoE router stay float32, as in the
    reference)."""
    pdt = L.torch_dtype(cfg.param_dtype)

    def t(a, dtype=pdt) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    def dense_layer(lt, i: int, post_norms: bool) -> DenseLayer:
        at = lt["attn"]
        attn = L.Attention(*(t(at[n][i]) for n in ("wq", "wk", "wv", "wo")))
        if "moe" in lt:
            mt = lt["moe"]
            ffn = L.MoE(t(mt["router"][i], torch.float32),
                        *(t(mt[n][i]) for n in ("w_gate", "w_up", "w_down")))
        else:
            ffn = L.MLP(*(t(lt["mlp"][n][i])
                          for n in ("w_gate", "w_up", "w_down")))
        post = ((t(lt["ln_pa"]["scale"][i]), t(lt["ln_pf"]["scale"][i]))
                if post_norms else (None, None))
        return DenseLayer(t(lt["ln1"]["scale"][i]), attn,
                          t(lt["ln2"]["scale"][i]), ffn, *post)

    def mamba_layer(mt, i: int) -> MambaLayer:
        bt = mt["block"]
        block = L.Mamba(*(t(bt[n][i], torch.float32 if n in _F32_LEAVES
                            else pdt)
                          for n in ("in_proj", "conv_w", "conv_b", "A_log",
                                    "D_skip", "dt_bias", "norm_scale",
                                    "out_proj")))
        return MambaLayer(t(mt["ln"]["scale"][i]), block)

    parts = {}
    if "layers" in tree:
        parts["layers"] = [dense_layer(tree["layers"], i, cfg.post_norms)
                           for i in range(cfg.n_layers)]
    if "mamba" in tree:
        parts["mamba"] = [mamba_layer(tree["mamba"], i)
                          for i in range(cfg.n_layers)]
    if "shared" in tree:
        parts["shared"] = [dense_layer(tree["shared"], i, False)
                           for i in range(cfg.n_shared_blocks)]
    for name in ("frame_in", "patch_in"):
        if name in tree["embed"]:
            parts[name] = t(tree["embed"][name])
    head = t(tree["head"]) if "head" in tree else None
    return LM(t(tree["embed"]["tok"]), t(tree["final_norm"]["scale"]), head,
              **parts)


def train_state_from_jax(cfg: ModelConfig, state,
                         device: Union[str, torch.device] = "cpu"
                         ) -> TrainState:
    """A reference ``TrainState(params, AdamWState(step, m, v))`` (leaves
    as arrays) as the port's :class:`TrainState` on ``device``: the
    parameters through :func:`model_params_from_jax`, the moments as
    ``{name: tensor}`` in their own dtype, the step as an int32 scalar."""
    model = model_params_from_jax(cfg, state.params, device)

    def moments(tree) -> Dict[str, torch.Tensor]:
        dt = np.asarray(tree["embed"]["tok"]).dtype
        sdt = torch.bfloat16 if dt.name == "bfloat16" else torch.float32
        return {n: p.detach().to(sdt) for n, p in param_tree(
            model_params_from_jax(cfg.with_(param_dtype="float32"), tree,
                                  device)).items()}

    step = torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32,
                        device=device)
    return TrainState(model, AdamWState(step, moments(state.opt.m),
                                        moments(state.opt.v)))


class RefLeaf(NamedTuple):
    """One leaf of the reference's parameter tree: its ``path`` (the
    tree's keys joined by ``/``, e.g. ``layers/attn/wq``), the ``names``
    of the port's parameters (``named_parameters``) that make it, in layer
    order, and whether it is ``stacked`` (a leading ``[L]`` axis over
    those parameters) or one parameter as it is."""

    path: str
    names: Tuple[str, ...]
    stacked: bool


_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("w_gate", "w_up", "w_down")
_MAMBA = ("in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
          "norm_scale", "out_proj")


def reference_leaves(model: LM) -> List[RefLeaf]:
    """The leaves of the reference's tree for ``model`` (the tree that
    :func:`model_params_from_jax` reads), in ``jax.tree_util`` flatten
    order: every dict's keys sorted, depth first. A per-layer leaf of the
    reference is ``[L, ...]``, stacked over the port's ``L`` per-layer
    parameters, so a rule that the reference applies to a leaf (a size
    threshold, one scale per leading channel, one top-k threshold) spans
    every layer at once."""
    tree: Dict = {"embed": {"tok": "tok"}, "final_norm": {"scale":
                                                          "final_norm"}}
    for name in ("frame_in", "patch_in"):
        if getattr(model, name) is not None:
            tree["embed"][name] = name
    if model.head is not None:
        tree["head"] = "head"

    def dense(layer: DenseLayer) -> Dict:
        ffn = "moe" if layer.moe is not None else "mlp"
        keys = (("router",) if ffn == "moe" else ()) + _FFN
        sub = {"ln1": {"scale": "ln1"}, "ln2": {"scale": "ln2"},
               "attn": {k: f"attn.{k}" for k in _ATTN},
               ffn: {k: f"{ffn}.{k}" for k in keys}}
        if layer.ln_pa is not None:
            sub.update(ln_pa={"scale": "ln_pa"}, ln_pf={"scale": "ln_pf"})
        return sub

    stacks = []
    if len(model.layers):
        tree["layers"] = dense(model.layers[0])
        stacks.append(("layers", len(model.layers)))
    if len(model.mamba):
        tree["mamba"] = {"block": {k: f"block.{k}" for k in _MAMBA},
                         "ln": {"scale": "ln"}}
        stacks.append(("mamba", len(model.mamba)))
    if len(model.shared):
        tree["shared"] = dense(model.shared[0])
        stacks.append(("shared", len(model.shared)))
    n_of = dict(stacks)

    out: List[RefLeaf] = []

    def walk(node, path: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
            return
        top = path[0]
        if top in n_of:
            names = tuple(f"{top}.{i}.{node}" for i in range(n_of[top]))
            out.append(RefLeaf("/".join(path), names, True))
        else:
            out.append(RefLeaf("/".join(path), (node,), False))

    walk(tree, ())
    return out
