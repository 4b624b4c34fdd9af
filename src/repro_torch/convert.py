"""Carrying instance state between the JAX reference and the port as
NumPy arrays (the two packages never import each other).

* :func:`from_jax_instance` — the fields of a reference ``JaxInstance``,
  converted to NumPy, into a :class:`TorchInstance`;
* :func:`to_numpy` — the reverse, the same field names as NumPy arrays;
* :func:`placement_to_numpy` — a port placement as an ``[E, P]`` bool
  array the reference's host oracles (``sigma_np``) can score.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

from repro_torch.core.instance import TorchInstance

__all__ = ["from_jax_instance", "to_numpy", "placement_to_numpy"]

_INT_FIELDS = ("u_service", "u_edge", "sm_service")


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
