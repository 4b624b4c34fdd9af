"""The port's edge cluster and serving launcher
(repro_torch.serving.cluster, repro_torch.launch.serve) against the JAX
reference's on the CPU (the kernels at the smoke shapes the cluster
serves are held on the card by tests/test_torch_attention.py and
tests/test_torch_ssd.py).

``run_serving`` at (48 users, 2 edges, 60 GiB), which places no MoE
model, and at (24, 2, 1000 GiB), which places all ten, each followed by
the failure of edge 0: the placement, each user's routed implementation,
the served/dropped/skipped counts and the requests per model equal the
reference's, and the mean expected QoS is within 1e-6. The realized QoS
comes from each batch's measured latency; under one fixed-step stand-in
for ``time.perf_counter`` in both packages' cluster and engine modules
(each batch reads it five times in both) it is equal too. The reference
runs once per module (about 45 s, mostly jit); ``chip_smoke.py``'s
``CLUSTER_EXPECTED`` constants are recomputed from that run."""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.serving.cluster as ref_cluster  # noqa: E402
import repro.serving.engine as ref_engine  # noqa: E402
import repro.serving.router as ref_router  # noqa: E402
from repro.launch.serve import run_serving as ref_run_serving  # noqa: E402
from repro.serving import default_catalog as ref_catalog  # noqa: E402
import repro_torch.serving.cluster as port_cluster  # noqa: E402
import repro_torch.serving.engine as port_engine  # noqa: E402
import repro_torch.serving.router as port_router  # noqa: E402
from repro_torch.launch.serve import run_serving  # noqa: E402
from repro_torch.serving import default_catalog  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CASES = [(48, 2, 60.0), (24, 2, 1000.0)]
QOS_TOL = 1e-6
#: Seconds the stand-in clock advances per read: a batch's latency is four
#: steps (its five reads), 1 s.
STEP = 0.25


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` advances ``STEP`` a
    read, from 0."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += STEP
        return self.t


def _traced(mp, cluster_mod, engine_mod, router_mod) -> list:
    """Give a package's cluster and engine modules a fresh stand-in clock
    and record every routing decision of its Router; the list of
    decisions."""
    clock = types.SimpleNamespace(perf_counter=_Clock().perf_counter)
    mp.setattr(cluster_mod, "time", clock)
    mp.setattr(engine_mod, "time", clock)
    routes = []
    route = router_mod.Router.route

    def recorded(self, *args, **kw):
        routes.append(route(self, *args, **kw))
        return routes[-1]

    mp.setattr(router_mod.Router, "route", recorded)
    return routes


def _run(fn, mp, mods, case, **kw):
    routes = _traced(mp, *mods)
    U, E, R = case
    reports = fn(U, E, storage=R, fail_edge=0, verbose=False, **kw)
    assert len(routes) == 2
    return list(zip(reports, routes))


PORT = (port_cluster, port_engine, port_router)
REF = (ref_cluster, ref_engine, ref_router)


@pytest.fixture(scope="module")
def reference():
    """The reference's (report, decision) pairs per case, before and after
    the failure."""
    out = {}
    for case in CASES:
        with pytest.MonkeyPatch.context() as mp:
            out[case] = _run(ref_run_serving, mp, REF, case)
    return out


@pytest.mark.parametrize("case", CASES, ids=["storage60", "storage1000"])
def test_run_serving_matches_reference(reference, case, monkeypatch):
    cs = _chip_smoke()
    got = _run(run_serving, monkeypatch, PORT, case, device="cpu")
    for (rep, dec), (ref_rep, ref_dec) in zip(got, reference[case]):
        mine = cs.cluster_record(rep, dec.assignment)
        want = cs.cluster_record(ref_rep, ref_dec.assignment)
        assert abs(mine.pop("expected_qos")
                   - want.pop("expected_qos")) <= QOS_TOL
        assert mine == want
        np.testing.assert_array_equal(rep.placement, ref_rep.placement)
        np.testing.assert_allclose(dec.expected_qos, ref_dec.expected_qos,
                                   atol=QOS_TOL)
        assert rep.mean_realized_qos == ref_rep.mean_realized_qos
        assert rep.total_wall_s == ref_rep.total_wall_s


@pytest.mark.parametrize("case", CASES, ids=["storage60", "storage1000"])
def test_chip_smoke_cluster_constants_are_the_reference(reference, case):
    """chip_smoke.py holds the card's cluster decisions to constants; they
    are the reference's."""
    cs = _chip_smoke()
    assert tuple(CASES) == cs.CLUSTER_CASES and cs.CLUSTER_FAIL_EDGE == 0
    for (rep, dec), want in zip(reference[case], cs.CLUSTER_EXPECTED[case]):
        got = cs.cluster_record(rep, dec.assignment)
        assert abs(got.pop("expected_qos")
                   - want["expected_qos"]) <= 1e-12
        assert got == {k: v for k, v in want.items() if k != "expected_qos"}


def test_edge_cluster_reloads_and_evicts_like_the_reference(monkeypatch):
    """One cluster serves the storage-60 population, then the storage-1000
    one: each edge evicts and loads as the reference's does (the resident
    implementations equal after each serve), the servers are smoke
    configs (frontend and encoder-only configs swapped for smollm's), and
    the reports agree."""
    reports = {}
    for name, mods, cat_fn, kw in (
            ("port", PORT, default_catalog, dict(device="cpu")),
            ("ref", REF, ref_catalog, {})):
        _traced(monkeypatch, *mods)
        catalog = cat_fn()
        cluster = mods[0].EdgeCluster(catalog, n_edges=2, **kw)
        prompts = np.random.default_rng(0).integers(0, 200, (20, 16))
        seen = []
        for storage in (60.0, 1000.0):
            inst = catalog.to_instance(20, 2, storage_capacity=storage,
                                       seed=3)
            rep = cluster.serve(inst, prompts.astype(np.int32),
                                max_new_tokens=2)
            seen.append((rep, [sorted(g.resident) for g in cluster.groups],
                         {p: s.cfg.name for g in cluster.groups
                          for p, s in g.resident.items()}))
        reports[name] = seen
    for (rep, res, names), (ref_rep, ref_res, ref_names) in zip(
            reports["port"], reports["ref"]):
        assert res == ref_res and names == ref_names
        assert rep.per_model_counts == ref_rep.per_model_counts
        assert (rep.served, rep.dropped, rep.skipped) == (
            ref_rep.served, ref_rep.dropped, ref_rep.skipped)
        assert abs(rep.mean_expected_qos - ref_rep.mean_expected_qos) \
            <= QOS_TOL
        assert rep.mean_realized_qos == ref_rep.mean_realized_qos
        archs = {p: m.arch for p, m in enumerate(default_catalog().models)}
        assert all(n.endswith("-smoke") for n in names.values())
        assert all(n == "smollm-360m-smoke" for p, n in names.items()
                   if archs[p] in ("hubert_xlarge", "internvl2_1b"))


def test_launcher_prints_the_reference_lines(capsys):
    from repro_torch.launch.serve import main

    main(["--users", "24", "--storage", "1000", "--fail-edge", "0",
          "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] served=24 dropped=0 skipped=0 "
                             "expectedQoS=0.943")
    assert "[serve]   qwen3_moe_235b          7 requests" in out
    assert out[-1].startswith("[serve] after edge-0 failure: served=24 "
                              "expectedQoS=0.925")
