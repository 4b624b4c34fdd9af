"""Service catalog: the bridge from the model zoo to the PIES problem.

A *service* is a task family (``chat``, ``audio-encode``, ``vlm-caption``);
each architecture config registered under a service is one *service model*
``(s, m)`` in the paper's sense, with:

* ``accuracy``  — published eval quality mapped to [0, 1] (the paper treats
  A_sm as a cached metric from offline evaluation; sources inline);
* ``comm_cost k_sm``  — request payload units (∝ prompt/frame bytes);
* ``comp_cost w_sm``  — compute units (∝ active params — measured latency
  can be substituted via :meth:`Catalog.profile_with`);
* ``storage r_sm``    — resident HBM GiB (params + steady-state KV).

``to_instance`` assembles a full :class:`repro_torch.core.PIESInstance`
from the catalog plus a request population, so the whole PIES pipeline
(EGP/AGP/OMS) drives real placement decisions for the zoo.

Every field is the reference's (:mod:`repro.serving.catalog`): the
parameter counts come from the port's own config registry, including the
MoE families the port cannot run yet, and the instance draws are
byte-identical per seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.instance import PIESInstance

__all__ = ["ServiceModel", "Catalog", "default_catalog"]


@dataclasses.dataclass
class ServiceModel:
    service: str
    arch: str
    accuracy: float          # A_sm ∈ [0, 1]
    comm_cost: float         # k_sm
    comp_cost: float         # w_sm
    storage: float           # r_sm (GiB-ish units)
    note: str = ""


@dataclasses.dataclass
class Catalog:
    models: List[ServiceModel]

    @property
    def services(self) -> List[str]:
        out = []
        for m in self.models:
            if m.service not in out:
                out.append(m.service)
        return out

    def profile_with(self, arch: str, *, comp_cost: Optional[float] = None,
                     accuracy: Optional[float] = None) -> "Catalog":
        """Override catalog entries with live-measured profiles."""
        models = []
        for m in self.models:
            if m.arch == arch:
                m = dataclasses.replace(
                    m,
                    comp_cost=comp_cost if comp_cost is not None else m.comp_cost,
                    accuracy=accuracy if accuracy is not None else m.accuracy)
            models.append(m)
        return Catalog(models)

    def to_instance(
        self,
        n_users: int,
        n_edges: int = 4,
        *,
        storage_capacity: float = 60.0,
        comm_capacity: Tuple[float, float] = (300.0, 600.0),
        comp_capacity: Tuple[float, float] = (300.0, 600.0),
        delta_max: float = 10.0,
        alpha_scale: float = 0.125,
        delta_scale: float = 1.5,
        seed: int = 0,
    ) -> PIESInstance:
        rng = np.random.default_rng(seed)
        svc_index = {s: i for i, s in enumerate(self.services)}
        P = len(self.models)
        inst = PIESInstance(
            K=rng.uniform(*comm_capacity, size=n_edges),
            W=rng.uniform(*comp_capacity, size=n_edges),
            R=np.full(n_edges, storage_capacity),
            sm_service=np.array([svc_index[m.service] for m in self.models]),
            sm_acc=np.array([m.accuracy for m in self.models]),
            sm_k=np.array([m.comm_cost for m in self.models]),
            sm_w=np.array([m.comp_cost for m in self.models]),
            sm_r=np.array([m.storage for m in self.models]),
            u_edge=rng.integers(0, n_edges, size=n_users),
            u_service=rng.integers(0, len(self.services), size=n_users),
            u_alpha=1.0 - np.clip(rng.exponential(alpha_scale, n_users), 0, 1),
            u_delta=np.clip(rng.exponential(delta_scale, n_users), 0, delta_max),
            delta_max=delta_max,
            model_names=[f"{m.service}/{m.arch}" for m in self.models],
        )
        inst.validate()
        return inst


def _storage_gib(arch: str) -> float:
    cfg = get_config(arch)
    return round(cfg.n_params * 2 / 2**30, 1)  # bf16 resident params


def with_quantized_variants(cat: "Catalog", *, storage_ratio: float = 0.52,
                            accuracy_retention: float = 0.985,
                            comp_ratio: float = 0.8) -> "Catalog":
    """Add an int8 weight-only variant of every implementation — a second
    point on each service's accuracy/cost frontier (the paper's
    multi-implementation premise, manufactured from the same checkpoint).

    Defaults are the reference's constants (the serving digests depend on
    them): storage ≈ 0.52× for int8+scales, top-1 agreement ≈ 0.98–1.0;
    comp_ratio reflects faster weight streaming in the bandwidth-bound
    regimes. The port measures both with :mod:`repro_torch.models.quant`
    (``quantized_bytes``, ``logit_agreement``; ``chip_smoke.py`` phase 23
    at full width on the card). Pass live-measured values to override.
    """
    extra = [
        dataclasses.replace(
            m, arch=m.arch + "-int8",
            accuracy=round(m.accuracy * accuracy_retention, 4),
            storage=round(m.storage * storage_ratio, 2),
            comp_cost=round(m.comp_cost * comp_ratio, 2),
            note=(m.note + " (int8 weight-only)").strip())
        for m in cat.models
    ]
    return Catalog(cat.models + extra)


def default_catalog() -> Catalog:
    """The assigned zoo as a multi-implementation service catalog.

    Accuracies are published benchmark results normalized to [0, 1]
    (MMLU for chat LMs, ImageNet-style proxies elsewhere) — the paper's
    Table-I workflow with cached metrics. comp_cost ∝ active GFLOPs/token.
    """
    def comp(arch):
        return round(get_config(arch).n_active_params * 2 / 1e9, 2)

    rows = [
        # service     arch              A_sm   k_sm  note
        ("chat",      "smollm_360m",    0.34,  1.0, "SmolLM-360M eval"),
        ("chat",      "zamba2_2p7b",    0.55,  1.0, "Zamba2-2.7B MMLU"),
        ("chat",      "mamba2_2p7b",    0.48,  1.0, "Mamba2-2.7B avg"),
        ("chat",      "mixtral_8x7b",   0.71,  1.0, "Mixtral MMLU"),
        ("chat",      "yi_34b",         0.76,  1.0, "Yi-34B MMLU"),
        ("chat",      "gemma2_27b",     0.75,  1.0, "Gemma2-27B MMLU"),
        ("chat",      "command_r_35b",  0.68,  1.0, "Command-R MMLU"),
        ("chat",      "qwen3_moe_235b", 0.88,  1.0, "Qwen3-235B-A22B"),
        ("audio-encode", "hubert_xlarge", 0.95, 4.0, "HuBERT-XL phoneme"),
        ("vlm-caption",  "internvl2_1b",  0.61, 6.0, "InternVL2-1B avg"),
    ]
    return Catalog([
        ServiceModel(service=s, arch=a, accuracy=acc, comm_cost=k,
                     comp_cost=comp(a), storage=_storage_gib(a), note=n)
        for s, a, acc, k, n in rows
    ])
