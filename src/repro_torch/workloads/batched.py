"""Instance evaluation on the device: padded and bucketed batches through
the dense placement path, the sparse scale path, and the host oracle.

* :func:`pad_instances` pads instances to one ``(U, P, E)`` envelope and
  stacks them into a batched :class:`~repro_torch.core.TorchInstance`;
  :func:`evaluate_batch` runs QoS (the ``qos_matrix`` kernel), greedy
  placement (:func:`~repro_torch.core.placement.egp_place_torch` /
  :func:`~repro_torch.core.placement.agp_place_torch`'s lock-step loop,
  the ``greedy_argmax`` kernel in it) and σ for the whole stack: all B
  instances' edges advance together in one loop.
* :func:`bucket_instances` groups instances into power-of-two ``(U, P,
  E)`` size classes, each padded to its own envelope, so one outlier does
  not inflate every instance's pad; the envelope is a function of an
  instance's own dims alone, so its result does not depend on its batch
  neighbours.
* :func:`evaluate_sparse` — the scale path: per-user top-k candidate pairs
  (one fused kernel launch) feed the lock-step sparse EGP loop and σ over
  the pairs; no ``[U, P]`` matrix is built. Exact vs
  :func:`evaluate_host` when ``k`` keeps every eligible implementation
  (the default).
* :func:`evaluate_host` — NumPy reference: ``egp_np``/``agp_np`` +
  ``sigma_np`` per instance.
* :func:`sweep` — every (scenario, seed, tick) instance of the scenario
  registry bucketed and evaluated in one :func:`evaluate_batch` call.

With tracing on (:mod:`repro_torch.obs`), a bucketed batch's pad waste
goes to the ``placement.bucket_pad_waste`` gauge and the sparse path's
``k`` to ``placement.candidate_k``, as in the reference.

Padding is inert, as in :mod:`repro.workloads.batched`: padded users
request the dummy service ``S`` that no model implements and sit on a
padded edge; padded models carry the dummy service ``S + 1`` (no user
requests it) and a storage cost above any budget; padded edges have no
storage, and at least one exists to host the padded users.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.candidates import impl_table_np
from repro_torch.core.instance import PIESInstance, TorchInstance
from repro_torch.core.placement import (_agp_lockstep, _egp_lockstep,
                                        agp_np, agp_place_torch, egp_np,
                                        egp_place_sparse_torch,
                                        egp_place_torch, sigma_sparse_torch)
from repro_torch.core.qos import eligibility_torch, qos_matrix_np
from repro_torch.core.scheduling import sigma_np, sigma_torch
from repro_torch.device import resolve_device

__all__ = [
    "PaddedBatch",
    "BucketedBatch",
    "pad_instances",
    "bucket_envelope",
    "bucket_indices",
    "bucket_instances",
    "single_evaluator",
    "evaluate_batch",
    "evaluate_sparse",
    "evaluate_host",
    "sweep",
]

#: Storage cost assigned to padded model rows — larger than any edge budget.
_PAD_STORAGE = 1e9

Device = Union[str, torch.device, None]


@dataclasses.dataclass
class PaddedBatch:
    """A stack of instances padded to a common (U, P, E) envelope.

    Every tensor of ``torch_instance`` is batched ``[B, ...]`` and its
    ``delta_max`` is a ``[B]`` float32 tensor (the reference's
    ``JaxInstance`` leaves, on the batch's device)."""

    torch_instance: TorchInstance
    n_services: int                    # scatter width (incl. dummy ids)
    dims: List[Tuple[int, int, int]]   # true (U, P, E) per instance

    @property
    def B(self) -> int:
        return len(self.dims)


@dataclasses.dataclass
class BucketedBatch:
    """Instances grouped into per-size-class :class:`PaddedBatch`\\ es.

    ``index[b]`` maps bucket ``b``'s rows back to positions in the original
    instance sequence; ``envelopes[b]`` is the bucket's ``(U_pad, P_pad,
    E_pad)``. Buckets are ordered by envelope.
    """

    buckets: List[PaddedBatch]
    index: List[np.ndarray]
    envelopes: List[Tuple[int, int, int]]
    dims: List[Tuple[int, int, int]]   # true (U, P, E) in original order

    @property
    def B(self) -> int:
        return len(self.dims)

    @property
    def pad_waste(self) -> float:
        """Fraction of evaluated (U·P·E) cells that are padding, in [0, 1)."""
        true = sum(u * p * (e + 1) for u, p, e in self.dims)
        padded = sum(len(idx) * up * pp * ep
                     for idx, (up, pp, ep) in zip(self.index, self.envelopes))
        return 1.0 - true / padded if padded else 0.0


def _pow2_ceil(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def bucket_envelope(U: int, P: int, E: int,
                    cap: Optional[Tuple[int, int, int]] = None
                    ) -> Tuple[int, int, int]:
    """Geometric (power-of-two) size class of one instance's dims, a pure
    function of ``(U, P, E)`` and the static ``cap``; the edge axis buckets
    ``E + 1`` (a padded host edge always exists)."""
    env = (_pow2_ceil(U), _pow2_ceil(P), _pow2_ceil(E + 1))
    if cap is not None:
        env = tuple(min(a, int(c)) for a, c in zip(env, cap))
    if not (env[0] >= U and env[1] >= P and env[2] > E):
        raise ValueError(f"cap {cap} below instance dims ({U},{P},{E})")
    return env


def bucket_indices(instances: Sequence[PIESInstance],
                   cap: Optional[Tuple[int, int, int]] = None
                   ) -> List[Tuple[Tuple[int, int, int], List[int]]]:
    """Group instance positions by :func:`bucket_envelope`, sorted by
    envelope; within a bucket, original order is preserved."""
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, inst in enumerate(instances):
        groups.setdefault(bucket_envelope(inst.U, inst.P, inst.E, cap),
                          []).append(i)
    return sorted(groups.items())


def bucket_instances(instances: Sequence[PIESInstance],
                     cap: Optional[Tuple[int, int, int]] = None, *,
                     device: Device = None) -> BucketedBatch:
    """Stack ``instances`` into one :class:`PaddedBatch` per size bucket,
    on ``device`` (``None``: CUDA, raising without it)."""
    if not instances:
        raise ValueError("cannot bucket an empty batch")
    dev = resolve_device(device)
    buckets, index, envelopes = [], [], []
    for env, idx in bucket_indices(instances, cap):
        buckets.append(pad_instances([instances[i] for i in idx], *env,
                                     device=dev))
        index.append(np.asarray(idx))
        envelopes.append(env)
    return BucketedBatch(buckets=buckets, index=index, envelopes=envelopes,
                         dims=[(i.U, i.P, i.E) for i in instances])


def _share_factors(inst: PIESInstance) -> Tuple[np.ndarray, np.ndarray]:
    counts = inst.covered_counts()
    return (counts[inst.u_edge] / inst.K[inst.u_edge],
            counts[inst.u_edge] / inst.W[inst.u_edge])


def pad_instances(instances: Sequence[PIESInstance],
                  u_pad: Optional[int] = None,
                  p_pad: Optional[int] = None,
                  e_pad: Optional[int] = None, *,
                  device: Device = None) -> PaddedBatch:
    """Stack ``instances`` into one batched, fixed-shape TorchInstance on
    ``device`` (``None``: CUDA, raising without it). Floats are built in
    float64 and cast once to float32, ids to int32, as the reference's
    leaves are."""
    if not instances:
        raise ValueError("cannot pad an empty batch")
    dev = resolve_device(device)
    U_pad = u_pad or max(i.U for i in instances)
    P_pad = p_pad or max(i.P for i in instances)
    # +1 guarantees a padded edge exists in every instance (hosts pad users)
    E_pad = e_pad or (max(i.E for i in instances) + 1)
    S_max = max(int(i.sm_service.max()) + 1 if i.P else 0 for i in instances)
    user_dummy, model_dummy = S_max, S_max + 1

    rows: Dict[str, List[np.ndarray]] = {f.name: [] for f in
                                         dataclasses.fields(TorchInstance)}
    dims = []
    for inst in instances:
        U, P, E = inst.U, inst.P, inst.E
        if not (U <= U_pad and P <= P_pad and E < E_pad):
            raise ValueError(f"instance ({U},{P},{E}) exceeds pad envelope "
                             f"({U_pad},{P_pad},{E_pad})")
        dims.append((U, P, E))
        du, dp, de = U_pad - U, P_pad - P, E_pad - E
        share_k, share_w = _share_factors(inst)

        def upad(a, fill):
            return np.concatenate([np.asarray(a, np.float64),
                                   np.full(du, fill)])

        def ppad(a, fill):
            return np.concatenate([np.asarray(a, np.float64),
                                   np.full(dp, fill)])

        rows["u_alpha"].append(upad(inst.u_alpha, 0.0))
        rows["u_delta"].append(upad(inst.u_delta, 0.0))
        rows["u_share_k"].append(upad(share_k, 0.0))
        rows["u_share_w"].append(upad(share_w, 0.0))
        rows["u_service"].append(np.concatenate(
            [inst.u_service, np.full(du, user_dummy, dtype=np.int64)]))
        rows["u_edge"].append(np.concatenate(
            [inst.u_edge, np.full(du, E_pad - 1, dtype=np.int64)]))
        rows["sm_service"].append(np.concatenate(
            [inst.sm_service, np.full(dp, model_dummy, dtype=np.int64)]))
        rows["sm_acc"].append(ppad(inst.sm_acc, 0.0))
        rows["sm_k"].append(ppad(inst.sm_k, 0.0))
        rows["sm_w"].append(ppad(inst.sm_w, 0.0))
        rows["sm_r"].append(ppad(inst.sm_r, _PAD_STORAGE))
        rows["R"].append(np.concatenate([inst.R, np.zeros(de)]))
        rows["delta_max"].append(np.float64(inst.delta_max))

    int_fields = {"u_service", "u_edge", "sm_service"}
    leaves = {
        name: torch.from_numpy(np.ascontiguousarray(np.stack(vals).astype(
            np.int32 if name in int_fields else np.float32))).to(dev)
        for name, vals in rows.items()
    }
    return PaddedBatch(torch_instance=TorchInstance(**leaves),
                       n_services=model_dummy + 1, dims=dims)


def single_evaluator(algo: str, n_services: int, max_iters: int, *,
                     use_kernel: Optional[bool] = None):
    """The per-instance evaluator ``TorchInstance -> (value, x)``: QoS
    (``qos_matrix`` dispatcher), EGP or AGP over all edges, σ; ``value`` a
    float32 0-d tensor, ``x [E, P]`` bool."""
    if algo not in ("egp", "agp"):
        raise ValueError(f"unknown batched algorithm {algo!r}")
    from repro_torch.kernels.qos_matrix.ops import qos_matrix

    def one(ti: TorchInstance):
        # the dispatcher itself, not qos_matrix_from_instance: the
        # reference's batched evaluator computes QoS in jnp and records no
        # kernel.qos_matrix span per item, so neither does this one
        Q = qos_matrix(ti.u_alpha, ti.u_delta, ti.u_share_k, ti.u_share_w,
                       ti.u_service, ti.sm_acc, ti.sm_k, ti.sm_w,
                       ti.sm_service, delta_max=ti.delta_max,
                       use_kernel=use_kernel)
        elig = eligibility_torch(ti)
        if algo == "egp":
            x = egp_place_torch(Q, elig, ti.u_edge, ti.u_service,
                                ti.sm_service, ti.sm_r, ti.R, n_services,
                                max_iters=max_iters, use_kernel=use_kernel)
        else:
            x = agp_place_torch(Q, elig, ti.u_edge, ti.sm_r, ti.R,
                                max_iters=max_iters, use_kernel=use_kernel)
        return sigma_torch(Q, elig, ti.u_edge, x), x

    return one


def _evaluate_padded(batch: PaddedBatch, algo: str, max_iters: int,
                     use_kernel: Optional[bool]
                     ) -> Tuple[np.ndarray, torch.Tensor]:
    """All B instances in one lock-step loop over their B × E_pad edges."""
    from repro_torch.kernels.qos_matrix.ops import qos_matrix

    if algo not in ("egp", "agp"):
        raise ValueError(f"unknown batched algorithm {algo!r}")
    ti = batch.torch_instance
    B, U = ti.u_edge.shape
    P, E = ti.sm_service.shape[1], ti.R.shape[1]
    dev = ti.u_edge.device
    Q = torch.stack([
        qos_matrix(ti.u_alpha[b], ti.u_delta[b], ti.u_share_k[b],
                   ti.u_share_w[b], ti.u_service[b], ti.sm_acc[b],
                   ti.sm_k[b], ti.sm_w[b], ti.sm_service[b],
                   delta_max=dm, use_kernel=use_kernel)
        for b, dm in enumerate(ti.delta_max.tolist())])     # [B, U, P]
    elig = ti.u_service[:, :, None] == ti.sm_service[:, None, :]
    Qm = torch.where(elig, Q, 0.0).reshape(B * U, P)
    # edge row b·E + e; each row's own instance's models
    u_row = (torch.arange(B, device=dev)[:, None] * E
             + ti.u_edge.long()).reshape(-1)
    of_row = torch.arange(B, device=dev).repeat_interleave(E)
    sm_r = ti.sm_r[of_row]
    if algo == "egp":
        sm_service = ti.sm_service.long()[of_row]
        # relevant[row, p] ⇔ some user of the row requests service of p
        req = torch.zeros((B * E, batch.n_services), dtype=torch.bool,
                          device=dev)
        req[u_row, ti.u_service.long().reshape(-1)] = True
        relevant = req.gather(1, sm_service)
        x = _egp_lockstep(Qm, u_row, sm_service, sm_r, ti.R.reshape(-1),
                          relevant, max_iters, use_kernel)
    else:
        x = _agp_lockstep(Qm, u_row, sm_r, ti.R.reshape(-1), max_iters,
                          use_kernel)
    x = x.view(B, E, P)
    values = torch.stack([sigma_torch(Q[b], elig[b], ti.u_edge[b], x[b])
                          for b in range(B)])
    return values.double().cpu().numpy(), x


def evaluate_batch(batch: Union[PaddedBatch, BucketedBatch],
                   algo: str = "egp", max_iters: int = 512, *,
                   use_kernel: Optional[bool] = None):
    """Batched placement evaluation: ``(values [B] float64, x)``.

    For a :class:`PaddedBatch` all B instances run in one lock-step loop
    and ``x`` is ``[B, E_pad, P_pad]`` bool on the batch's device. For a
    :class:`BucketedBatch` each bucket runs at its own envelope and the
    results are re-assembled in original instance order: ``x`` is a list
    of per-instance ``[E_pad_b, P_pad_b]`` placements. ``values[b]`` is σ
    of instance ``b``'s EGP/AGP placement; padding contributes exactly
    zero, so values match the host path up to float32 accumulation.
    ``use_kernel`` goes to the kernel dispatchers (``None``: the kernels
    exactly on CUDA). Pad waste is published on the
    ``placement.bucket_pad_waste`` obs gauge.
    """
    if isinstance(batch, BucketedBatch):
        values = np.empty(batch.B, dtype=np.float64)
        xs: List = [None] * batch.B
        for pb, idx in zip(batch.buckets, batch.index):
            v, x = _evaluate_padded(pb, algo, max_iters, use_kernel)
            values[idx] = v
            for j, i in enumerate(idx):
                xs[int(i)] = x[j]
        tracer = obs.get_tracer()
        if tracer is not None:
            tracer.metrics.gauge("placement.bucket_pad_waste").set(
                batch.pad_waste)
        return values, xs
    return _evaluate_padded(batch, algo, max_iters, use_kernel)


def evaluate_sparse(instances: Sequence[PIESInstance],
                    k: Optional[int] = None, max_iters: Optional[int] = None,
                    use_kernel: Optional[bool] = None,
                    device: Device = None
                    ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """Top-k sparse EGP placement per instance: ``(values [B] float64,
    x list)``.

    ``k`` defaults to every eligible implementation (exact); a smaller
    ``k`` is the documented approximation. ``max_iters=None`` uses
    ``P + 1`` (an edge never picks more than P models). ``device=None``
    means CUDA and raises without it; ``use_kernel`` is passed to the
    kernel dispatchers (``None``: kernels exactly when on CUDA). Each
    ``x`` is an ``[E, P]`` bool tensor on ``device``. The impl table goes
    to the device once per instance, with the instance. The effective
    ``k`` is published on the ``placement.candidate_k`` obs gauge.
    """
    from repro_torch.kernels.qos_matrix.ops import qos_candidates_from_instance

    dev = resolve_device(device)
    values, xs = [], []
    tracer = obs.get_tracer()
    for inst in instances:
        ti = TorchInstance.from_pies(inst, dev)
        table = torch.from_numpy(
            impl_table_np(inst.sm_service, inst.S).astype(np.int32)).to(dev)
        cand_idx, cand_q = qos_candidates_from_instance(
            ti, table, k, use_kernel=use_kernel)
        if tracer is not None:
            tracer.metrics.gauge("placement.candidate_k").set(
                int(cand_idx.shape[1]))
        mi = int(max_iters) if max_iters is not None else inst.P + 1
        x, _ = egp_place_sparse_torch(cand_idx, cand_q, ti.u_edge,
                                      ti.sm_service, ti.sm_r, ti.R,
                                      max_iters=mi, use_kernel=use_kernel)
        values.append(float(sigma_sparse_torch(cand_idx, cand_q,
                                               ti.u_edge, x)))
        xs.append(x)
    return np.asarray(values, np.float64), xs


def evaluate_host(instances: Sequence[PIESInstance],
                  algo: str = "egp") -> np.ndarray:
    """NumPy reference: per-instance greedy placement + σ, no batching."""
    place = {"egp": egp_np, "agp": agp_np}[algo]
    out = []
    for inst in instances:
        Q = qos_matrix_np(inst)
        out.append(sigma_np(inst, place(inst, Q), Q))
    return np.asarray(out)


def sweep(scenario_names: Sequence[str], seeds: Sequence[int],
          n_ticks: Optional[int] = None, algo: str = "egp", *,
          device: Device = None, **overrides) -> Dict:
    """Monte-Carlo sweep: every (scenario, seed, tick) instance bucketed
    on ``device`` (``None``: CUDA, raising without it) and evaluated in
    one :func:`evaluate_batch` call.

    Returns ``{"values": {name: [n_seeds, n_ticks] np.ndarray},
    "instances": [...], "labels": [(name, seed, tick)], "batch": batch}``.
    """
    from .scenarios import get_scenario

    dev = resolve_device(device)
    instances: List[PIESInstance] = []
    labels: List[Tuple[str, int, int]] = []
    ticks_of: Dict[str, int] = {}
    for name in scenario_names:
        scenario = get_scenario(name, **overrides)
        T = int(n_ticks or scenario.n_ticks)
        ticks_of[name] = T
        for seed in seeds:
            for tick, inst in enumerate(scenario.horizon(seed, T)):
                instances.append(inst)
                labels.append((name, int(seed), tick))

    batch = bucket_instances(instances, device=dev)
    values, _ = evaluate_batch(batch, algo=algo)

    shaped: Dict[str, np.ndarray] = {}
    off = 0
    for name in scenario_names:
        T = ticks_of[name]
        n = len(seeds) * T
        shaped[name] = values[off:off + n].reshape(len(seeds), T)
        off += n
    return {"values": shaped, "instances": instances, "labels": labels,
            "batch": batch}
