"""Serving launcher: a PIES-placed edge cluster serving batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --users 48 --edges 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Builds the multi-implementation service catalog (the 10-arch zoo), samples
a request population with the paper's threshold distributions, runs EGP
placement + OMS routing, executes every request on real (reduced-config)
models, and reports expected vs realized QoS. ``--fail-edge`` shows
elastic re-placement after an edge-cloud loss. It runs on the CUDA card
(the kernels) unless ``--device cpu`` asks for the plain path.
"""
from __future__ import annotations

import argparse

import numpy as np


def run_serving(n_users: int = 48, n_edges: int = 2, seed: int = 0,
                storage: float = 60.0, placement: str = "egp",
                max_new_tokens: int = 4, fail_edge: int = -1,
                verbose: bool = True, device=None):
    """One cluster's placement, routing and execution of ``n_users``
    16-token prompts; with ``fail_edge >= 0``, then again after that edge
    fails. Returns the :class:`~repro_torch.serving.ServeReport` (a pair
    of them with ``fail_edge``). ``device=None`` means CUDA."""
    from repro_torch.serving import EdgeCluster, default_catalog

    catalog = default_catalog()
    cluster = EdgeCluster(catalog, n_edges=n_edges, placement_algo=placement,
                          device=device)
    inst = catalog.to_instance(n_users, n_edges, storage_capacity=storage,
                               seed=seed)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, 200, size=(n_users, 16)).astype(np.int32)

    report = cluster.serve(inst, prompts, max_new_tokens=max_new_tokens)
    if verbose:
        print(f"[serve] served={report.served} dropped={report.dropped} "
              f"skipped={report.skipped} "
              f"expectedQoS={report.mean_expected_qos:.3f} "
              f"realizedQoS={report.mean_realized_qos:.3f} "
              f"wall={report.total_wall_s:.1f}s")
        for name, n in sorted(report.per_model_counts.items()):
            print(f"[serve]   {name:20s} {n:4d} requests")

    if fail_edge >= 0:
        inst2, _ = cluster.router.handle_edge_failure(inst, [fail_edge])
        report2 = cluster.serve(inst2, prompts,
                                max_new_tokens=max_new_tokens)
        if verbose:
            print(f"[serve] after edge-{fail_edge} failure: "
                  f"served={report2.served} "
                  f"expectedQoS={report2.mean_expected_qos:.3f}")
        return report, report2
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--users", type=int, default=48)
    ap.add_argument("--edges", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--storage", type=float, default=60.0)
    ap.add_argument("--placement", default="egp",
                    choices=["egp", "agp", "opt"])
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--fail-edge", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain path)")
    args = ap.parse_args(argv)
    run_serving(args.users, args.edges, args.seed, args.storage,
                args.placement, args.max_new_tokens, args.fail_edge,
                device=args.device)


if __name__ == "__main__":
    main()
