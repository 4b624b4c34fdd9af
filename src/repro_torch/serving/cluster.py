"""Edge cluster: PIES placement driving a real serving data plane.

Each :class:`EdgeGroup` models one edge cloud of the paper's 3-tier
architecture. The cluster (1) builds a PIES instance from the catalog and
a request population, (2) places with the router's algorithm (EGP by
default) over the QoS matrix (the B1 kernel on a card), (3) loads the
placed implementations as :class:`~.engine.ModelServer`\\ s at their
reduced (smoke) configs, (4) routes each request with OMS and executes
it batched (B4 and B7, or B8, on a card), and (5) scores *realized* QoS
from the measured wall-clock latency of each batch through Eq. (1)–(3)
(:func:`~.scheduler.realized_qos_np`) — the paper's real-world experiment
(§VI-C) as a reusable harness. The port of the reference's
``serving/cluster.py``, with a ``device`` (``None``: CUDA) for the router
and every model server.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Union

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.instance import PIESInstance
from repro_torch.device import resolve_device

from .catalog import Catalog
from .engine import ModelServer
from .router import Router
from .scheduler import realized_qos_np

__all__ = ["EdgeCluster", "EdgeGroup", "ServeReport"]


@dataclasses.dataclass
class ServeReport:
    served: int
    dropped: int
    skipped: int                # assigned but never executed (no resident
                                # server for the impl on the user's edge)
    mean_expected_qos: float    # from the QoS model (router view)
    mean_realized_qos: float    # from measured latency + catalog accuracy
    per_model_counts: Dict[str, int]
    placement: np.ndarray
    total_wall_s: float


class EdgeGroup:
    """One edge cloud's resident model servers, keyed by implementation
    index. ``smoke`` is kept for the reference's signature and, as there,
    never read: every placed model loads at its smoke config."""

    def __init__(self, gid: int, smoke: bool = True, bucket_batch: int = 4,
                 bucket_seq: int = 64,
                 device: Union[str, torch.device, None] = None):
        self.gid = gid
        self.smoke = smoke
        self.bucket_batch = bucket_batch
        self.bucket_seq = bucket_seq
        self.device = resolve_device(device)
        self.resident: Dict[int, ModelServer] = {}

    def load_placement(self, x_row: np.ndarray, catalog: Catalog):
        wanted = set(np.nonzero(x_row)[0].tolist())
        for p in list(self.resident):
            if p not in wanted:
                del self.resident[p]          # evict
        for p in wanted:
            if p not in self.resident:
                arch = catalog.models[p].arch
                cfg = get_smoke_config(arch)
                if cfg.encoder_only or cfg.frontend != "none":
                    # modality stubs serve via their LM/encoder backbone;
                    # the cluster feeds token ids either way
                    cfg = get_smoke_config("smollm_360m")
                self.resident[p] = ModelServer(
                    cfg, bucket_batch=self.bucket_batch,
                    bucket_seq=self.bucket_seq, seed=p, device=self.device)


class EdgeCluster:
    """The router and ``n_edges`` edge groups on one ``device``."""

    def __init__(self, catalog: Catalog, n_edges: int = 2,
                 placement_algo: str = "egp", bucket_batch: int = 4,
                 bucket_seq: int = 64,
                 device: Union[str, torch.device, None] = None):
        self.catalog = catalog
        self.router = Router(placement_algo, device=device)
        self.groups = [EdgeGroup(g, bucket_batch=bucket_batch,
                                 bucket_seq=bucket_seq, device=device)
                       for g in range(n_edges)]

    def serve(self, inst: PIESInstance, prompts: np.ndarray,
              max_new_tokens: int = 4) -> ServeReport:
        """inst: PIES instance whose users are the requests; prompts:
        ``[U, s]`` token prompts. Runs placement + routing + execution."""
        t0 = time.perf_counter()
        x = self.router.place(inst)
        decision = self.router.route(inst)
        for g in self.groups:
            g.load_placement(x[g.gid], self.catalog)

        realized = np.zeros(inst.U)
        executed = np.zeros(inst.U, dtype=bool)
        counts: Dict[str, int] = {}
        served = 0
        for e, group in enumerate(self.groups):
            for p in sorted(group.resident):
                uids = np.nonzero((decision.assignment == p)
                                  & (inst.u_edge == e))[0]
                if uids.size == 0:
                    continue
                server = group.resident[p]
                bb = server.bucket_batch
                for i in range(0, uids.size, bb):
                    batch_uids = uids[i:i + bb]
                    batch_prompts = prompts[batch_uids]
                    t_b = time.perf_counter()
                    server.generate(batch_prompts, n_steps=max_new_tokens)
                    latency = time.perf_counter() - t_b
                    # realized QoS: Eq. (1) with measured latency
                    acc = self.catalog.models[p].accuracy
                    realized[batch_uids], _ = realized_qos_np(
                        latency, inst.u_delta[batch_uids], acc,
                        inst.u_alpha[batch_uids], inst.delta_max)
                    executed[batch_uids] = True
                    served += batch_uids.size
                name = self.catalog.models[p].arch
                counts[name] = counts.get(name, 0) + int(uids.size)
        dropped = int((decision.assignment < 0).sum())
        # a user can be assigned an implementation whose server is not
        # resident on its edge (placement row loaded elsewhere): it never
        # executed, so its zero entry must not deflate the realized mean
        skipped = int(((decision.assignment >= 0) & ~executed).sum())
        return ServeReport(
            served=served, dropped=dropped, skipped=skipped,
            mean_expected_qos=float(decision.expected_qos.mean()),
            mean_realized_qos=float(realized[executed].mean())
            if served else 0.0,
            per_model_counts=counts, placement=x,
            total_wall_s=time.perf_counter() - t0)
