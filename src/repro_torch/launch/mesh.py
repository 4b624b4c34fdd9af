"""Device meshes over an initialized process group: the port of
``repro.launch.mesh``.

Each factory returns a :class:`torch.distributed.device_mesh.DeviceMesh`
with the reference's axis names, over the ranks of the default process
group (one rank a device: NCCL on the card, gloo for ``device="cpu"``).
The caller starts the process group (``torch.distributed
.init_process_group`` with its address, world size and rank) in every
rank, then calls the factory in every rank. Nothing here touches a
device or a process group at import.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch.distributed as dist

__all__ = ["batch_axes", "make_host_mesh", "make_production_mesh",
           "make_sweep_mesh", "mesh_devices"]


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group is initialized: call torch.distributed."
            "init_process_group (nccl on the card, gloo on the CPU) in "
            "every rank before building a mesh")
    return dist.get_world_size()


def _mesh(device: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The target mesh: ``(data=16, model=16)``, or with ``multi_pod``
    ``(pod=2, data=16, model=16)`` (pure data parallelism across ``pod``).
    The world must hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world()
    if n != int(np.prod(shape)):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs "
            f"{int(np.prod(shape))} ranks; the process group has {n}")
    return _mesh(device, shape, axes)


def make_host_mesh(model: Optional[int] = None, *, device: str = "cuda"):
    """A ``(data=world // model, model)`` mesh over every rank of the
    process group (tests / examples)."""
    n = _world()
    model = model or 1
    if model <= 0 or n % model != 0:
        raise ValueError(
            f"cannot build a (data={n}//{model}, model={model}) mesh: the "
            f"model-parallel degree must be a positive divisor of the "
            f"{n} available device(s); pick a divisor of {n} or use "
            f"make_sweep_mesh() for 1-D batch sharding")
    return _mesh(device, (n // model, model), ("data", "model"))


def make_sweep_mesh(n_items: Optional[int] = None, *, device: str = "cuda"):
    """A 1-D ``("data",)`` mesh for batch-sharded sweeps: every rank,
    capped at ``n_items`` when given (the first ``n_items`` ranks). The
    port's sweeps split over ``devices=`` instead (``repro_torch.sweeps``);
    this is the reference's factory for callers of its API."""
    from torch.distributed.device_mesh import DeviceMesh

    n = _world()
    d = n if n_items is None else max(1, min(int(n_items), n))
    if d == n:
        return _mesh(device, (d,), ("data",))
    return DeviceMesh(device, list(range(d)), mesh_dim_names=("data",))


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def mesh_devices(mesh) -> int:
    return int(np.prod(tuple(mesh.shape)))
