"""The program under test, built from the benchmark's inputs: the port's
model (``repro_torch.models``) holding the benchmark's weights, its
training step and its server. Only the drivers import this module; the
reference never does."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def model_config(cfg: dict) -> ModelConfig:
    """The port's :class:`ModelConfig` of a configuration file: every key
    the dataclass has, lists as tuples."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in names}
    return ModelConfig(**kw)


def build_model(mc: ModelConfig, w: Dict[str, torch.Tensor]) -> T.LM:
    """The port's model whose parameters are the tensors of ``w`` (the
    port's parameter names)."""
    mamba = [T.MambaLayer(w[f"mamba.{i}.ln"], L.Mamba(*(
        w[f"mamba.{i}.block.{k}"] for k in (
            "in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
            "norm_scale", "out_proj"))))
        for i in range(mc.n_layers)]
    shared = [T.DenseLayer(
        w[f"shared.{j}.ln1"],
        L.Attention(*(w[f"shared.{j}.attn.{k}"]
                      for k in ("wq", "wk", "wv", "wo"))),
        w[f"shared.{j}.ln2"],
        L.MLP(*(w[f"shared.{j}.mlp.{k}"]
                for k in ("w_gate", "w_up", "w_down"))))
        for j in range(mc.n_shared_blocks if mc.family == "hybrid" else 0)]
    model = T.LM(w["tok"], w["final_norm"], w.get("head"), mamba=mamba,
                 shared=shared)
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(w):
        raise ValueError("the port's parameters "
                         f"{sorted(set(names) ^ set(w))[:4]} differ from the "
                         "benchmark's weights")
    return model
