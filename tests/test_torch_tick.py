"""The port's serving tick against the JAX package's: the hysteresis EGP
and DynamicPlacer decision for decision, evaluate_horizon's floats, the
continuous-batching scheduler's finish times byte for byte (with the
reference's event-heap regression cases), the service catalog field by
field, and run_horizon's result digest over every registered scenario and
policy — the digests chip_smoke.py holds on the card among them."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro.core as RC
import repro.core.dynamic as RD
import repro.serving.catalog as RCAT
import repro.serving.horizon as RH
import repro.serving.scheduler as RS
import repro.workloads as RW
import repro_torch.core as TC
import repro_torch.core.dynamic as TD
import repro_torch.serving.catalog as TCAT
import repro_torch.serving.horizon as TH
import repro_torch.serving.scheduler as TS
import repro_torch.workloads as TW
from repro import obs as robs
from repro.gateway.control import result_digest
from repro.obs import ledger as rledger
from repro.obs import reqtrace as rreqtrace
from repro_torch import obs as tobs
from repro_torch.obs import ledger as tledger
from repro_torch.obs import reqtrace as treqtrace

ROOT = Path(__file__).resolve().parents[1]
#: The reference's shrunk, congested horizon (tests/test_horizon.py).
SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
LOAD = dict(prompt_tokens=768, new_tokens=64, max_batch=4)
POLICIES = ("edf", "fcfs", "feedback")


@pytest.fixture(autouse=True)
def _recorders_off():
    """The obs tracer, the decision ledger and the request tracer are off
    in both packages, and a test leaves them off."""
    for mod in (tobs, robs):
        assert not mod.enabled()
    for mod in (tledger, rledger):
        assert mod._LEDGER is None
    for mod in (treqtrace, rreqtrace):
        assert mod._REQTRACER is None
    yield
    for mod in (tobs, robs):
        mod.disable()
    for mod in (tledger, rledger):
        mod.disable_ledger()
    for mod in (treqtrace, rreqtrace):
        mod.disable_request_tracing()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(mod, **kw):
    base = dict(scenario="flash_crowd", overrides=tuple(SMALL.items()),
                policy="edf", seed=0, n_ticks=3, **LOAD)
    base.update(kw)
    return mod.HorizonConfig(**base)


def _same_fields(a, b):
    return dataclasses.astuple(a) == dataclasses.astuple(b)


# ===========================================================================
# the hysteresis placer
# ===========================================================================

@pytest.mark.parametrize("seed,bonus", [(0, 0.0), (1, 3.0), (2, 0.5),
                                        (3, 12.0)])
def test_egp_with_bias_is_the_reference(seed, bonus):
    rinst = RC.synthetic_instance(120, n_edges=5, seed=seed)
    tinst = TC.synthetic_instance(120, n_edges=5, seed=seed)
    resident = np.random.default_rng(seed).random(
        (tinst.E, tinst.P)) < 0.3
    got = TD._egp_with_bias(tinst, TC.qos_matrix_np(tinst), resident,
                            bonus)
    want = RD._egp_with_bias(rinst, RC.qos_matrix_np(rinst), resident,
                             bonus)
    assert np.array_equal(got, want)
    if bonus == 0.0:
        assert np.array_equal(got, TC.egp_np(tinst))


@pytest.mark.parametrize("scenario", ["steady", "flash_crowd",
                                      "edge_failure", "mobility_churn"])
def test_dynamic_placer_steps_are_the_reference(scenario):
    ticks = dict(seed=1, n_ticks=6, **SMALL)
    rp, tp = RD.DynamicPlacer(2.0, 3.0), TD.DynamicPlacer(2.0, 3.0)
    for ri, ti in zip(RW.horizon(scenario, **ticks),
                      TW.horizon(scenario, **ticks)):
        rx, rv, rl = rp.step(ri)
        tx, tv, tl = tp.step(ti)
        assert np.array_equal(tx, rx) and tv == rv and tl == rl
        assert np.array_equal(tp.new_loads, rp.new_loads)
        assert np.array_equal(tp.evicted, rp.evicted)


@pytest.mark.parametrize("scenario", ["flash_crowd", "steady"])
def test_evaluate_horizon_is_the_reference(scenario):
    kw = dict(switching_cost=1.5, stickiness=2.0, seed=2, n_ticks=5)
    got = TC.evaluate_horizon(scenario, **kw)
    assert got == RC.evaluate_horizon(scenario, **kw)
    assert set(got) == {"static", "greedy", "hysteresis"}


# ===========================================================================
# the continuous-batching scheduler
# ===========================================================================

def _req(mod, uid, prompt, arrival=0.0, delta=10.0, new_tokens=0):
    return mod.ArrivingRequest(uid=uid, impl=0, edge=0, arrival=arrival,
                               prompt_tokens=prompt, new_tokens=new_tokens,
                               alpha=0.0, delta=delta, accuracy=0.9)


def _finish(reqs):
    return np.array([(r.start, r.finish) for r in reqs]).tobytes()


def _regression_cases(mod):
    """The reference's event-heap regression cases
    (tests/test_scheduler.py): the slot that frees at the true completion
    time, exact finish-time ties, tie-heavy bulk under both policies,
    tick-incremental runs and a model-load gate."""
    out = []
    prof = mod.ExecutorProfile(prefill_per_token_s=1e-3,
                               decode_per_step_s=0.0, max_batch=3)
    reqs = [_req(mod, u, p) for u, p in
            enumerate((1000, 2609, 1539, 1600, 100))]
    mod.ContinuousScheduler({(0, 0): prof}, policy="fcfs").run(reqs)
    out.append(reqs)
    wide = mod.ExecutorProfile(prefill_per_token_s=1e-3,
                               decode_per_step_s=0.0, max_batch=64)
    pair = [_req(mod, 0, 23), _req(mod, 1, 20)]
    mod.ContinuousScheduler({(0, 0): wide}, policy="fcfs").run(pair)
    assert pair[0].finish == pair[1].finish == 0.023
    out.append(pair)
    for policy in ("edf", "fcfs"):
        bulk = [r for m in range(1, 26)
                for r in (_req(mod, 2 * m, 23 * m),
                          _req(mod, 2 * m + 1, 20 * m))]
        bulk += [_req(mod, 100 + u, 0, arrival=float(u % 3))
                 for u in range(50)]
        mod.ContinuousScheduler({(0, 0): wide}, policy=policy).run(bulk)
        out.append(bulk)
    two = mod.ExecutorProfile(prefill_per_token_s=1e-3,
                              decode_per_step_s=0.0, max_batch=2)
    reqs = [_req(mod, u, 400, arrival=0.25 * u) for u in range(12)]
    sched = mod.ContinuousScheduler({(0, 0): two}, policy="edf")
    sched.submit(reqs[:6])
    sched.run_until(1.5)
    assert sched.in_flight() > 0
    sched.submit(reqs[6:])
    sched.run_until(3.0)
    sched.drain()
    assert sched.backlog() == 0
    out.append(reqs)
    sched = mod.ContinuousScheduler({(0, 0): two}, policy="fcfs")
    sched.delay_executor((0, 0), 2.0)
    gated = [_req(mod, 0, 100, arrival=1.0)]
    sched.submit(gated)
    sched.run_until(1.5)
    assert sched.queue_depth() == 1 and sched.in_flight() == 0
    sched.drain()
    assert gated[0].start == 2.0
    out.append(gated)
    return out


def test_scheduler_regression_cases_are_the_reference():
    for got, want in zip(_regression_cases(TS), _regression_cases(RS)):
        assert _finish(got) == _finish(want)
    with pytest.raises(ValueError):
        TS.ContinuousScheduler(policy="sjf")
    with pytest.raises(KeyError):
        TS.ContinuousScheduler(policy="edf").submit([_req(TS, 0, 10)])


@pytest.mark.parametrize("policy,rate", [("edf", 20.0), ("fcfs", 20.0),
                                         ("edf", 200.0)])
def test_simulate_is_the_reference(policy, rate):
    """simulate over a catalog instance routed by the host EGP + OMS, with
    the default i.i.d. arrivals and with a scenario's arrival process."""
    tcat, rcat = TCAT.default_catalog(), RCAT.default_catalog()
    tinst = tcat.to_instance(150, 2, storage_capacity=80.0, seed=3)
    rinst = rcat.to_instance(150, 2, storage_capacity=80.0, seed=3)
    _, y, _ = TC.place_and_schedule(tinst)
    comp = np.array([m.comp_cost for m in tcat.models])
    for arrivals in (None, "flash_crowd"):
        kw = dict(policy=policy, arrival_rate=rate, seed=3, max_batch=4)
        tkw, rkw = dict(kw), dict(kw)
        if arrivals:
            tkw["arrivals"] = TW.get_scenario(arrivals).arrivals
            rkw["arrivals"] = RW.get_scenario(arrivals).arrivals
        got = TS.simulate(tinst, y, comp, **tkw)
        assert got == RS.simulate(rinst, y, comp, **rkw)
        assert got["served"] == int((y >= 0).sum())
    lat = np.array([0.1, 2.0, 0.5])
    for a, b in zip(TS.realized_qos_np(lat, 1.0, 0.9, 0.8, 10.0),
                    RS.realized_qos_np(lat, 1.0, 0.9, 0.8, 10.0)):
        assert a.tobytes() == b.tobytes()


# ===========================================================================
# the catalog
# ===========================================================================

def test_catalog_is_the_reference():
    from repro.configs import paper_catalog as RP
    from repro_torch.configs import paper_catalog as TP

    for got, want in (
            (TCAT.default_catalog(), RCAT.default_catalog()),
            (TCAT.with_quantized_variants(TCAT.default_catalog()),
             RCAT.with_quantized_variants(RCAT.default_catalog())),
            (TCAT.with_quantized_variants(TCAT.default_catalog(),
                                          storage_ratio=0.3,
                                          comp_ratio=0.5),
             RCAT.with_quantized_variants(RCAT.default_catalog(),
                                          storage_ratio=0.3,
                                          comp_ratio=0.5)),
            (TCAT.default_catalog().profile_with("yi_34b", comp_cost=9.0),
             RCAT.default_catalog().profile_with("yi_34b", comp_cost=9.0)),
            (TP.zoo_catalog(), RP.zoo_catalog())):
        assert got.services == want.services
        assert [dataclasses.asdict(m) for m in got.models] == \
            [dataclasses.asdict(m) for m in want.models]
    # the MoE rows, which the port cannot serve yet, count as the reference
    from repro.configs import get_config as rconfig
    from repro_torch.configs import get_config as tconfig
    for arch in ("mixtral_8x7b", "qwen3_moe_235b"):
        t, r = tconfig(arch), rconfig(arch)
        assert (t.n_params, t.n_active_params) == \
            (r.n_params, r.n_active_params)
        assert t.n_active_params < t.n_params
    kw = dict(n_edges=3, storage_capacity=70.0, seed=5)
    got = TCAT.default_catalog().to_instance(90, **kw)
    want = RCAT.default_catalog().to_instance(90, **kw)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    for name in ("K", "W", "R", "sm_service", "sm_acc", "sm_r", "u_edge",
                 "u_service", "u_alpha", "u_delta"):
        a, b = getattr(TP.numerical(60, 1), name), \
            getattr(RP.numerical(60, 1), name)
        assert a.tobytes() == b.tobytes()
        a, b = getattr(TP.realworld(2), name), getattr(RP.realworld(2), name)
        assert a.tobytes() == b.tobytes()
    assert TP.TABLE_I == RP.TABLE_I


# ===========================================================================
# the horizon
# ===========================================================================

@pytest.fixture(scope="module")
def digests():
    """result_digest of seed 0's horizon at the benchmark load, every
    registered scenario × policy, from each package."""
    names = TW.list_scenarios()
    assert names == RW.list_scenarios()
    out = {}
    for sc in names:
        for pol in POLICIES:
            kw = dict(scenario=sc, policy=pol, seed=0, **LOAD)
            t = TH.run_horizon(TH.HorizonConfig(**kw))
            r = RH.run_horizon(RH.HorizonConfig(**kw))
            out[(sc, pol)] = (t, result_digest(r))
    return out


def test_run_horizon_digest_is_the_reference(digests):
    for (sc, pol), (res, want) in digests.items():
        assert result_digest(res) == want, (sc, pol)


def test_chip_smoke_digest_constants_are_the_reference(digests):
    """chip_smoke.py holds the card's horizons to constant digests; they
    are the reference's, and its own copy of result_digest is the
    reference's function."""
    cs = _chip_smoke()
    assert cs.TICK_LOAD == LOAD and cs.TICK_POLICIES == POLICIES
    assert set(cs.TICK_DIGESTS) == set(digests)
    for key, (res, want) in digests.items():
        assert cs.TICK_DIGESTS[key] == want, key
        assert cs.result_digest(res) == want, key


def test_horizon_conservation_and_eviction_requeue():
    """The reference's horizon properties (tests/test_horizon.py), held on
    the port: conservation per tick, sane request timing, backlog spilled
    across ticks, evicted backlog requeued through OMS, and byte-identical
    reruns and TickReports against the reference."""
    for scenario, seed in (("steady", 1), ("flash_crowd", 1),
                           ("flash_crowd", 0)):
        kw = dict(scenario=scenario, seed=seed, n_ticks=4)
        res = TH.run_horizon(_cfg(TH, **kw))
        want = RH.run_horizon(_cfg(RH, **kw))
        for t in res.per_tick:
            assert t.served + t.dropped == t.submitted
            assert 0.0 <= t.mean_realized_qos <= 1.0
        assert res.served + res.dropped == res.submitted
        assert res.served == len(res.requests)
        for r in res.requests:
            assert r.finish >= r.start >= r.arrival >= 0.0
        assert all(_same_fields(a, b)
                   for a, b in zip(res.per_tick, want.per_tick))
    res = TH.run_horizon(_cfg(TH, seed=0, n_ticks=4))
    assert sum(t.requeued for t in res.per_tick) > 0
    assert any(r.finish > int(r.arrival) + 1 for r in res.requests)
    again = TH.run_horizon(_cfg(TH, seed=0, n_ticks=4))
    assert res.tick_values().tobytes() == again.tick_values().tobytes()


def test_horizon_config_and_overrides_are_the_reference():
    ov = {**SMALL, "switching_cost": 0.5, "max_batch": 2}
    assert TH.split_serving_overrides(ov) == RH.split_serving_overrides(ov)
    assert TH.SERVING_PARAM_KEYS == RH.SERVING_PARAM_KEYS
    for sc in TW.list_scenarios():
        for knobs in ({}, {"stickiness": 1.0}, ov):
            got = TH.HorizonConfig.from_overrides(sc, knobs, "edf", 3, 2)
            want = RH.HorizonConfig.from_overrides(sc, knobs, "edf", 3, 2)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert [f.name for f in dataclasses.fields(TH.TickReport)] == \
        [f.name for f in dataclasses.fields(RH.TickReport)]


def test_controller_step_idle_is_the_reference():
    """The caller-agnostic TickController with an idle tick between two
    placed ones (a live caller's resilience path) gives the reference's
    result."""
    def drive(mod):
        ctl = mod.TickController(_cfg(mod, n_ticks=3))
        ctl.step(0, ctl.materialize(0))
        ctl.step_idle(1)
        ctl.step(2, ctl.materialize(2))
        return ctl.finalize()

    got, want = drive(TH), drive(RH)
    assert result_digest(got) == result_digest(want)
    assert got.per_tick[1].submitted == 0


def test_digest_is_sensitive_to_a_finish_time():
    """A control: result_digest moves when one finish time moves by one
    ulp, so digest equality is byte equality."""
    res = TH.run_horizon(_cfg(TH))
    before = result_digest(res)
    r = res.requests[len(res.requests) // 2]
    r.finish = float(np.nextafter(r.finish, np.inf))
    assert result_digest(res) != before
