"""The port's workload generators against the JAX package's, byte for
byte: arrival processes, population dynamics (the uint64 splitmix hash),
every registered scenario's horizon (every field of every instance), the
elastic planner the scenarios call, the scenario cache, the batched
``sweep`` and the obs gauges the batched path sets."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import repro.distributed.elastic as RE
import repro.workloads as RW
import repro.workloads.arrivals as RA
import repro.workloads.population as RP
import repro_torch.distributed.elastic as TE
import repro_torch.workloads as TW
import repro_torch.workloads.arrivals as TA
import repro_torch.workloads.population as TP
import repro_torch.workloads.scenarios as TS
from repro import obs as robs
from repro_torch import obs as tobs

DATA = Path(__file__).resolve().parents[1] / "examples" / "data"

SCENARIOS = ["diurnal", "edge_failure", "flash_crowd", "mobility_churn",
             "steady", "trace_replay", "trace_replay_azure",
             "trace_replay_bursty"]
#: Shrunk scenarios: a smaller slot pool and catalog keep horizons fast.
SMALL = {"n_user_slots": 40, "n_services": 8, "max_impls": 3}
#: The reference's batched-vs-host tolerance (tests/test_workloads.py).
BATCH_ATOL = 1e-4

INSTANCE_FIELDS = ("K", "W", "R", "sm_service", "sm_acc", "sm_k", "sm_w",
                   "sm_r", "u_edge", "u_service", "u_alpha", "u_delta")


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_instance(a, b):
    for f in INSTANCE_FIELDS:
        _same_bytes(getattr(a, f), getattr(b, f))
    assert a.delta_max == b.delta_max


# ===========================================================================
# arrivals
# ===========================================================================

ARRIVALS = [
    ("PoissonArrivals", dict(rate=64.0)),
    ("PoissonArrivals", dict(rate=3.5)),
    ("MMPPArrivals", dict(base_rate=36.0, burst_rate=92.0, p_burst=0.4,
                          block=2)),
    ("DiurnalArrivals", dict(base_rate=56.0, amplitude=0.7, period=8,
                             phase=1.5)),
    ("TraceArrivals", dict(counts=(3, 0, 17, 9))),
]


@pytest.mark.parametrize("cls,kw", ARRIVALS,
                         ids=[f"{c}-{i}" for i, (c, _) in
                              enumerate(ARRIVALS)])
def test_arrivals_byte_identical(cls, kw):
    ra, ta = getattr(RA, cls)(**kw), getattr(TA, cls)(**kw)
    for seed in (0, 7, 2**40 + 3):
        for tick in (0, 1, 5, 13, 1000):
            assert ta.rate_at(seed, tick) == ra.rate_at(seed, tick)
            assert ta.count_at(seed, tick) == ra.count_at(seed, tick)
            _same_bytes(ta.times_in_tick(seed, tick, 0.25),
                        ra.times_in_tick(seed, tick, 0.25))
    if cls == "MMPPArrivals":
        assert [ta.is_burst(3, t) for t in range(20)] == \
            [ra.is_burst(3, t) for t in range(20)]


@pytest.mark.parametrize("name", ["diurnal_trace.csv",
                                  "bursty_weekend_trace.csv"])
def test_trace_from_file_identical(name):
    path = DATA / name
    assert TA.TraceArrivals.from_file(path).counts == \
        RA.TraceArrivals.from_file(path).counts
    assert TA.TraceArrivals.from_sequence([1.9, 2, 3]).counts == \
        RA.TraceArrivals.from_sequence([1.9, 2, 3]).counts


def test_trace_fallbacks_identical():
    """A checkout without examples/data/ degrades to the same counts."""
    import repro.workloads.scenarios as RS

    for name in ("_FALLBACK_DAY_TRACE", "_FALLBACK_WEEKEND_TRACE",
                 "_FALLBACK_AZURE_TRACE", "_AZURE_TARGET_MEAN"):
        assert getattr(TS, name) == getattr(RS, name)
    assert TS._bundled_azure_trace().counts == TS._FALLBACK_AZURE_TRACE


def test_trace_from_azure_csv_identical(tmp_path):
    path = DATA / "azure_function_excerpt.csv"
    for kw in (dict(), dict(minutes_per_tick=30, target_mean=17.0)):
        assert TA.TraceArrivals.from_azure_csv(path, **kw).counts == \
            RA.TraceArrivals.from_azure_csv(path, **kw).counts
    bad = tmp_path / "neg.csv"
    bad.write_text("minute,count\n-1,5\n")
    for mod in (RA, TA):
        with pytest.raises(ValueError, match="negative"):
            mod.TraceArrivals.from_azure_csv(bad)


# ===========================================================================
# population
# ===========================================================================

def test_hash_u64_and_uniform_byte_identical():
    slots = np.arange(1000)
    for seed in (0, 1, 2**63 + 11, -5):
        for comps in ((RP.TAG_SERVICE, slots, 3), (RP.TAG_MOVE, 7, slots),
                      (slots,)):
            _same_bytes(TP.hash_u64(seed, *comps), RP.hash_u64(seed, *comps))
            _same_bytes(TP.hash_uniform(seed, *comps),
                        RP.hash_uniform(seed, *comps))
    for tag in ("TAG_SERVICE", "TAG_ALPHA", "TAG_DELTA", "TAG_PHASE",
                "TAG_HOME", "TAG_MOVE", "TAG_DEST"):
        assert getattr(TP, tag) == getattr(RP, tag)


@pytest.mark.parametrize("kw", [dict(exponent=1.1),
                                dict(exponent=1.4, drift_period=2,
                                     drift_step=5)])
def test_zipf_and_churn_byte_identical(kw):
    rz, tz = RP.ZipfPopularity(24, **kw), TP.ZipfPopularity(24, **kw)
    u = RP.hash_uniform(3, 9, np.arange(500))
    rc = RP.ChurnModel(lifetime=6, alpha_scale=0.2)
    tc = TP.ChurnModel(lifetime=6, alpha_scale=0.2)
    for tick in (0, 1, 2, 7, 31):
        _same_bytes(tz.weights_at(tick), rz.weights_at(tick))
        _same_bytes(tz.sample(u, tick), rz.sample(u, tick))
        _same_bytes(tc.generation_at(5, tick, 300),
                    rc.generation_at(5, tick, 300))
        for a, b in zip(tc.attributes_at(5, tick, 300, tz),
                        rc.attributes_at(5, tick, 300, rz)):
            _same_bytes(a, b)


def test_mobility_byte_identical():
    rm, tm = RP.MarkovMobility(7, 0.3), TP.MarkovMobility(7, 0.3)
    _same_bytes(tm.home_edges(2, 200), rm.home_edges(2, 200))
    _same_bytes(tm.trajectory(2, 9, 200), rm.trajectory(2, 9, 200))
    _same_bytes(tm.edges_at(2, 4, 200), rm.edges_at(2, 4, 200))


# ===========================================================================
# elastic
# ===========================================================================

def test_elastic_outputs_equal():
    for n_hosts, dph, failed, mp in ((6, 8, (), 4), (6, 8, (1,), 4),
                                     (6, 8, (1, 4), 4), (16, 4, (3,), 16),
                                     (9, 2, (0, 8), 2)):
        rs = RE.ClusterState(n_hosts, dph, frozenset(failed))
        ts = TE.ClusterState(n_hosts, dph, frozenset(failed))
        assert ts.alive == rs.alive and ts.alive_devices == rs.alive_devices
        assert TE.plan_survivor_mesh(ts, mp) == RE.plan_survivor_mesh(rs, mp)
        d0, _ = RE.plan_survivor_mesh(RE.ClusterState(n_hosts, dph), mp)
        kw = dict(model_parallel=mp, global_batch=d0 * mp, old_data=d0,
                  edge_of_host={h: h % 5 for h in range(n_hosts)})
        assert TE.recovery_plan(ts, **kw) == RE.recovery_plan(rs, **kw)
        assert TE.recovery_plan(ts, **{**kw, "edge_of_host": None}) == \
            RE.recovery_plan(rs, **{**kw, "edge_of_host": None})
    assert TE.elastic_batch_plan(64, 8, 4) == RE.elastic_batch_plan(64, 8, 4)
    assert TE.elastic_batch_plan(64, 4, 8, 2) == \
        RE.elastic_batch_plan(64, 4, 8, 2)
    for mod in (RE, TE):
        with pytest.raises(RuntimeError, match="cannot form"):
            mod.plan_survivor_mesh(mod.ClusterState(2, 2, frozenset({0})), 4)
    rng = np.random.default_rng(0)
    rmon, tmon = RE.StragglerMonitor(5, patience=2), \
        TE.StragglerMonitor(5, patience=2)
    for step in range(12):
        t = rng.uniform(0.9, 1.1, 5)
        t[3] *= 2.0 if step > 2 else 1.0
        assert tmon.observe(t) == rmon.observe(t)
        if step == 7:
            rmon.reset(3)
            tmon.reset(3)


# ===========================================================================
# scenarios
# ===========================================================================

def test_registry_names_equal():
    assert TW.list_scenarios() == RW.list_scenarios() == SCENARIOS
    with pytest.raises(KeyError, match="unknown scenario"):
        TW.get_scenario("no_such")


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_horizon_byte_identical(name):
    ref = RW.get_scenario(name, **SMALL)
    port = TW.get_scenario(name, **SMALL)
    T = min(port.n_ticks, 7)
    for seed in (0, 3):
        rh = RW.horizon(name, seed=seed, n_ticks=T, **SMALL)
        th = TW.horizon(name, seed=seed, n_ticks=T, **SMALL)
        assert len(th) == len(rh) == T
        for a, b in zip(th, rh):
            _same_instance(a, b)
        # seekable: one tick alone equals the horizon's
        _same_instance(port.instance_at(seed, T - 1), rh[-1])
        assert port.dead_edges_at(T - 1) == ref.dead_edges_at(T - 1)
    assert port.description and port.n_ticks == ref.n_ticks
    # the same arrival process and churn (both frozen dataclasses)
    assert dataclasses.asdict(port.arrivals) == \
        dataclasses.asdict(ref.arrivals)
    assert dataclasses.astuple(port.churn) == dataclasses.astuple(ref.churn)


def test_edge_failure_places_nothing_on_dead_edges():
    h = TW.horizon("edge_failure", seed=1, n_ticks=7, **SMALL)
    for tick, inst in enumerate(h):
        dead = [e for t, e in ((3, 1), (5, 4)) if t <= tick]
        assert all(inst.R[e] == 0.0 for e in dead)
        assert not np.isin(inst.u_edge, dead).any()


def test_scenario_hashes_and_hits_its_caches():
    """A Scenario (frozen, with a Callable field) hashes and compares as
    the reference's does: one object hits its lru caches across a
    horizon; two factory calls hold distinct lambdas, as in the
    reference."""
    s = TW.get_scenario("edge_failure", **SMALL)
    same = dataclasses.replace(s)
    assert same == s and hash(same) == hash(s)
    assert (s == TW.get_scenario("edge_failure", **SMALL)) == \
        (RW.get_scenario("edge_failure", **SMALL) ==
         RW.get_scenario("edge_failure", **SMALL))
    TS._dead_edges_cached.cache_clear()
    TS._infrastructure_cached.cache_clear()
    s.horizon(0, 7)
    dead, infra = TS._dead_edges_cached.cache_info(), \
        TS._infrastructure_cached.cache_info()
    assert dead.misses == 2 and dead.hits == 2     # ticks 3-4 and 5-6
    assert infra.misses == 1 and infra.hits == 6


# ===========================================================================
# the batched sweep and the obs gauges
# ===========================================================================

def test_sweep_matches_reference_and_host():
    names, seeds = ("steady", "edge_failure"), (0, 2)
    kw = dict(n_ticks=6, algo="egp", n_user_slots=40, n_services=8,
              max_impls=3)
    ref = RW.sweep(names, seeds, **kw)
    got = TW.sweep(names, seeds, device="cpu", **kw)
    assert got["labels"] == ref["labels"]
    for a, b in zip(got["instances"], ref["instances"]):
        _same_instance(a, b)
    host = TW.evaluate_host(got["instances"], "egp")
    off = 0
    for name in names:
        assert got["values"][name].shape == (2, 6)
        np.testing.assert_allclose(got["values"][name],
                                   ref["values"][name], atol=BATCH_ATOL)
        np.testing.assert_allclose(got["values"][name].ravel(),
                                   host[off:off + 12], atol=BATCH_ATOL)
        off += 12


def test_gauges_read_as_the_reference_sets_them():
    import repro.core as R
    import repro_torch.core as T

    sizes = [(40, 0), (90, 1), (300, 2)]
    rmix = [R.synthetic_instance(u, n_edges=max(2, u // 40), seed=s)
            for u, s in sizes]
    tmix = [T.synthetic_instance(u, n_edges=max(2, u // 40), seed=s)
            for u, s in sizes]
    try:
        rtr, ttr = robs.enable(), tobs.enable()
        RW.evaluate_batch(RW.bucket_instances(rmix))
        TW.evaluate_batch(TW.bucket_instances(tmix, device="cpu"))
        RW.evaluate_sparse(rmix[:1], k=3)
        TW.evaluate_sparse(tmix[:1], k=3, device="cpu")
    finally:
        robs.disable()
        tobs.disable()
    for name in ("placement.bucket_pad_waste", "placement.candidate_k"):
        a = ttr.metrics.gauge(name).value
        assert not np.isnan(a)
        assert a == rtr.metrics.gauge(name).value
    assert ttr.metrics.gauge("placement.candidate_k").value == 3.0
