"""The port's decision ledger and request tracer against the JAX
package's: equal ledger JSONL for the host EGP and the serving tick, each
package reading the other's ledger and request-trace files with the same
``why``/``explain`` text, no TickReport byte moved by either recorder, and
the traced sparse EGP (``with_trace=True``) against
``egp_place_sparse_jax(..., with_trace=True)``."""
import json

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.serving.horizon as RH
import repro_torch.core as TC
import repro_torch.serving.horizon as TH
from repro import obs as robs
from repro.gateway.control import result_digest
from repro.obs import ledger as rledger
from repro.obs import reqtrace as rreqtrace
from repro_torch import obs as tobs
from repro_torch.obs import ledger as tledger
from repro_torch.obs import reqtrace as treqtrace

#: The reference's shrunk, congested horizon (tests/test_obs_v3.py).
SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
LOAD = dict(prompt_tokens=768, new_tokens=64, max_batch=4)
#: Same float32 data, another summation order: the traced benefit, gain
#: and remaining budget against the reference's, relative (a benefit that
#: cancels, relative to its iteration's scale).
TRACE_RTOL = 1e-5
#: The sparse ledger's gains telescope to σ to float32 summation order
#: (the reference's documented bound, tests/test_obs_v3.py).
GAIN_SUM_RTOL = 1e-3


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


def _cfg(mod, **kw):
    base = dict(scenario="flash_crowd", overrides=tuple(SMALL.items()),
                policy="edf", seed=0, n_ticks=3, **LOAD)
    base.update(kw)
    return mod.HorizonConfig(**base)


def _recorded(horizon, ledger, reqtrace, cfg, sample_every=4):
    """One horizon with its package's ledger and request tracer on."""
    reqtrace.enable_request_tracing(sample_every=sample_every)
    ledger.enable_ledger()
    try:
        res = horizon.run_horizon(cfg)
    finally:
        rt = reqtrace.disable_request_tracing()
        led = ledger.disable_ledger()
    return res, rt, led


# ===========================================================================
# the ledger on the host paths
# ===========================================================================

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_place_and_schedule_ledger_is_the_reference(seed):
    tinst = TC.synthetic_instance(60, n_edges=4, seed=seed)
    rinst = RC.synthetic_instance(60, n_edges=4, seed=seed)
    x_off = TC.place_and_schedule(tinst)[0]
    tled, rled = tledger.enable_ledger(), rledger.enable_ledger()
    try:
        tled.begin(tick=0, seed=seed, algo="egp")
        x, _, value = TC.place_and_schedule(tinst, algo="egp")
        rled.begin(tick=0, seed=seed, algo="egp")
        RC.place_and_schedule(rinst, algo="egp")
    finally:
        tledger.disable_ledger()
        rledger.disable_ledger()
    assert np.array_equal(x, x_off)
    assert tled.to_jsonl() == rled.to_jsonl()
    rec = tled.records()[-1]
    assert abs(rec["gain_sum"] - value) <= 1e-6 and rec["cert_ok"]
    # the sink is the port's own: the reference's core saw none of it
    import repro.core.placement as rplacement
    import repro_torch.core.placement as tplacement
    assert tplacement._DECISION_SINK is None
    assert rplacement._DECISION_SINK is None


@pytest.mark.parametrize("policy", ["edf", "fcfs", "feedback"])
def test_serving_ledger_and_reqtrace_are_the_reference(policy, tmp_path):
    cfg_t, cfg_r = _cfg(TH, policy=policy), _cfg(RH, policy=policy)
    off = TH.run_horizon(cfg_t)
    res, rt, led = _recorded(TH, tledger, treqtrace, cfg_t)
    want, rrt, rled = _recorded(RH, rledger, rreqtrace, cfg_r)
    # neither recorder moves a byte of the result
    assert result_digest(res) == result_digest(off) == result_digest(want)
    assert [tuple(vars(a).values()) for a in res.per_tick] == \
        [tuple(vars(a).values()) for a in off.per_tick]
    # one ledger record a tick, equal strings
    assert [r["tick"] for r in led.records()] == [0, 1, 2]
    assert led.to_jsonl() == rled.to_jsonl()
    for rec in led.records():
        assert abs(rec["gain_sum"] - rec["sigma"]) <= 1e-6
    # request-trace documents equal as JSON
    assert rt.kept()
    assert json.dumps(rt.snapshot(), sort_keys=True) == \
        json.dumps(rrt.snapshot(), sort_keys=True)
    # each package reads the other's files, with the same text
    for a, b, name in ((led, rled, "ledger"), (rt, rrt, "reqtrace")):
        a.save(tmp_path / f"port_{name}")
        b.save(tmp_path / f"ref_{name}")
    for who in ("port", "ref"):
        t_recs = tledger.load_ledger(tmp_path / f"{who}_ledger")
        r_recs = rledger.load_ledger(tmp_path / f"{who}_ledger")
        assert t_recs == r_recs and len(t_recs) == 3
        edge = t_recs[-1]["picks"][0]["edge"]
        for e in (None, edge):
            assert tledger.why_text(t_recs[-1], edge=e) == \
                rledger.why_text(r_recs[-1], edge=e)
        t_doc = treqtrace.load_reqtrace(tmp_path / f"{who}_reqtrace")
        r_doc = rreqtrace.load_reqtrace(tmp_path / f"{who}_reqtrace")
        assert t_doc == r_doc
        uid = t_doc["records"][0]["uid"]
        assert treqtrace.explain_uid(t_doc, uid) == \
            rreqtrace.explain_uid(r_doc, uid)


def test_obs_spans_of_the_tick(tmp_path):
    """The tick's spans, gauges and latency histograms land in the port's
    tracer, the artifact loads in the reference, and tracing moves no
    byte."""
    cfg = _cfg(TH)
    off = result_digest(TH.run_horizon(cfg))
    tr = tobs.enable()
    try:
        on = TH.run_horizon(cfg)
    finally:
        tobs.disable()
    assert result_digest(on) == off
    tr.save(tmp_path / "obs.json")
    doc = robs.load_artifact(tmp_path / "obs.json")
    names = {doc["names"][i] for i in doc["spans"]["name"]}
    assert {"horizon.run", "tick.materialize", "tick.place", "tick.route",
            "tick.execute", "kernel.qos_matrix_np", "horizon.drain"} <= names
    assert tr.counters["serving.submitted"] == on.submitted
    assert tr.metrics.histogram("serving.latency_s", scenario=cfg.scenario,
                                policy=cfg.policy).count == on.served
    assert tobs.kernel_span("x") is tobs.span("kernel.x")
    assert tobs.get_publisher() is None


def test_ledger_and_reqtrace_guards(tmp_path):
    for mod in (tledger, rledger):
        path = tmp_path / f"bad_{mod.__name__}.jsonl"
        path.write_text(json.dumps({"ledger_schema": 99, "picks": []})
                        + "\n")
        with pytest.raises(ValueError, match="schema"):
            mod.load_ledger(path)
    for mod in (treqtrace, rreqtrace):
        doc = {"records": [{"uid": 1, "events": []}]}
        with pytest.raises(ValueError, match="sampled"):
            mod.explain_uid(doc, 7)
    t, r = tledger.DecisionLedger(capacity=2), rledger.DecisionLedger(
        capacity=2)
    for led in (t, r):
        for tick in range(3):
            led.begin(tick=tick)
            led.pick(edge=0, impl=1, benefit=2.0, gain=0.5, remaining=3.0,
                     n_candidates=4, rank=1, placed=True, bias=0.25)
            led.end(sigma=0.5, sigma_bound=0.6)
    assert t.to_jsonl() == r.to_jsonl() and t.evicted_records == 1


# ===========================================================================
# the traced sparse EGP against egp_place_sparse_jax(with_trace=True)
# ===========================================================================

def _traced_pair(n_users, n_edges, seed):
    from repro.core.candidates import impl_table_np as r_table
    from repro.core.placement import egp_place_sparse_jax, sigma_sparse_jnp
    from repro.kernels.qos_matrix.ops import \
        qos_candidates_from_instance as r_cands
    from repro_torch.kernels.qos_matrix.ops import \
        qos_candidates_from_instance as t_cands

    rinst = RC.synthetic_instance(n_users, n_edges=n_edges, seed=seed)
    ji = rinst.as_jax()
    ci, cq = r_cands(ji, r_table(rinst.sm_service, rinst.S), None)
    rx, rtrace = egp_place_sparse_jax(ci, cq, ji.u_edge, ji.sm_service,
                                      ji.sm_r, ji.R,
                                      max_iters=rinst.P + 1,
                                      with_trace=True)
    rsigma = float(sigma_sparse_jnp(ci, cq, ji.u_edge, rx))

    tinst = TC.synthetic_instance(n_users, n_edges=n_edges, seed=seed)
    ti = TC.TorchInstance.from_pies(tinst, "cpu")
    table = torch.from_numpy(
        TC.impl_table_np(tinst.sm_service, tinst.S).astype(np.int32))
    tci, tcq = t_cands(ti, table)
    args = (tci, tcq, ti.u_edge, ti.sm_service, ti.sm_r, ti.R)
    x_off, it_off = TC.egp_place_sparse_torch(*args,
                                              max_iters=tinst.P + 1)
    x, it, trace = TC.egp_place_sparse_torch(*args, max_iters=tinst.P + 1,
                                             with_trace=True)
    assert torch.equal(x, x_off) and it == it_off
    tsigma = float(TC.sigma_sparse_torch(tci, tcq, ti.u_edge, x))
    return (tinst, x, it, trace, tsigma), (np.asarray(rx), rtrace, rsigma)


@pytest.mark.parametrize("n_users,n_edges,seed", [(80, 4, 0), (400, 5, 0),
                                                  (400, 5, 1), (400, 5, 2)])
def test_traced_sparse_egp_is_the_reference(n_users, n_edges, seed):
    (inst, x, it, trace, sigma), (rx, rtrace, rsigma) = \
        _traced_pair(n_users, n_edges, seed)
    assert np.array_equal(x.numpy(), rx)
    assert it == int(rtrace["n_iters"]) == trace["n_iters"]
    for name in ("pick", "placed", "n_candidates"):
        got, want = trace[name].numpy(), np.asarray(rtrace[name])
        assert got.shape == want.shape and np.array_equal(got, want), name
    for name in ("gain", "remaining"):
        got, want = trace[name].numpy(), np.asarray(rtrace[name])
        np.testing.assert_allclose(got, want, rtol=TRACE_RTOL, atol=0,
                                   err_msg=name)
    # a re-scored benefit is Σ_unsat (Q[u, p] − Q[u, p*]) and can cancel
    # to near zero, where a different float32 summation order moves it by
    # an ulp of its terms: every benefit is held within TRACE_RTOL of its
    # iteration's largest |benefit| (the scale its argmax compares), and
    # those not cancelled below a tenth of that scale elementwise
    got, want = trace["benefit"].numpy(), np.asarray(rtrace["benefit"])
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= TRACE_RTOL * scale).all()
    big = np.abs(want) >= 0.1 * scale
    np.testing.assert_allclose(got[big], want[big], rtol=TRACE_RTOL, atol=0)
    # rows after the last iteration stay as allocated
    assert (trace["pick"][it:] == -1).all() and not trace["placed"][it:].any()
    bound = TC.sigma_upper_bound_np(inst)
    rec = tledger.ingest_sparse_trace(tledger.DecisionLedger(), trace,
                                      tick=0, seed=seed, sigma=sigma,
                                      sigma_bound=bound)
    rrec = rledger.ingest_sparse_trace(rledger.DecisionLedger(), rtrace,
                                       tick=0, seed=seed, sigma=rsigma,
                                       sigma_bound=bound)
    assert rec["gain_sum"] == pytest.approx(sigma, rel=GAIN_SUM_RTOL)
    assert rec["algo"] == "egp_sparse" and 0.0 < rec["ratio"] <= 1.0
    assert rec["n_picks"] == int((trace["pick"] >= 0).sum()) == \
        rrec["n_picks"]
    assert rec["n_placed"] == int(x.sum()) == rrec["n_placed"]
    assert [(p["edge"], p["impl"], p["placed"]) for p in rec["picks"]] == \
        [(p["edge"], p["impl"], p["placed"]) for p in rrec["picks"]]
