"""The port's live control plane (repro_torch.gateway) against the JAX
package's (repro.gateway): the virtual-clock replay's result digest,
finish times and TickReports equal the reference gateway's and the port's
run_horizon; the wire protocol is the same in both directions; malformed
input is counted alike; and the wall-clock paths (TCP ingest, an empty
run, the soak) run end to end, checked on structure only — their timings
and verdicts judge this host's clock, not the code."""
import asyncio
import dataclasses
import json

import numpy as np
import pytest

import repro.gateway as RG
import repro.gateway.cli as RGCLI
import repro.serving.horizon as RH
import repro.workloads as RW
import repro_torch.gateway as TG
import repro_torch.gateway.cli as TGCLI
import repro_torch.serving.horizon as TH
import repro_torch.workloads as TW
from torch_recorders import recorders_off  # noqa: F401  (autouse)

#: The reference's shrunk, congested horizon (tests/test_gateway.py).
SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
LOAD = dict(prompt_tokens=768, new_tokens=64, max_batch=4)


def _cfg(horizon, **kw):
    base = dict(scenario="flash_crowd", overrides=tuple(SMALL.items()),
                policy="edf", seed=0, n_ticks=3, **LOAD)
    base.update(kw)
    return horizon.HorizonConfig(**base)


def _replay(gateway, hconfig, extra_lines=(), **gw_kw):
    """Virtual-clock in-process replay: loadgen lines → gateway."""
    gw = gateway.Gateway(gateway.GatewayConfig(horizon=hconfig,
                                               mode="virtual", **gw_kw))

    async def _run():
        async def send(line):
            gw.submit_line(line)

        task = asyncio.ensure_future(gw.run())
        for line in extra_lines:
            gw.submit_line(line)
        await gateway.run_loadgen(send, hconfig, wall=False)
        return await task

    return asyncio.run(_run()), gw


def _both(**kw):
    """(port result, port gateway, reference result, reference gateway)
    of one virtual replay of the same configuration."""
    t, tgw = _replay(TG, _cfg(TH, **kw))
    r, rgw = _replay(RG, _cfg(RH, **kw))
    return t, tgw, r, rgw


def _reports(result):
    """Each TickReport's field tuple as text (NaN equal to NaN)."""
    return [repr(dataclasses.astuple(rep)) for rep in result.per_tick]


def _same_result(t, r):
    assert TG.result_digest(t) == RG.result_digest(r)
    assert np.array([q.finish for q in t.requests]).tobytes() == \
        np.array([q.finish for q in r.requests]).tobytes()
    assert _reports(t) == _reports(r)


# ===========================================================================
# virtual-clock parity
# ===========================================================================

@pytest.mark.parametrize("policy", ["edf", "fcfs", "feedback"])
def test_virtual_replay_equals_reference_and_run_horizon(policy):
    t, _, r, _ = _both(policy=policy, seed=3, n_ticks=4)
    _same_result(t, r)
    offline = TH.run_horizon(_cfg(TH, policy=policy, seed=3, n_ticks=4))
    assert TG.result_digest(t) == TG.result_digest(offline)
    assert t.tick_values().tobytes() == offline.tick_values().tobytes()
    assert _reports(t) == _reports(offline)


@pytest.mark.parametrize("scenario", ["steady", "trace_replay_bursty"])
@pytest.mark.parametrize("seed", [0, 7])
def test_parity_across_seeds_and_scenarios(scenario, seed):
    t, _, r, _ = _both(scenario=scenario, seed=seed, policy="feedback")
    _same_result(t, r)
    offline = TH.run_horizon(_cfg(TH, scenario=scenario, seed=seed,
                                  policy="feedback"))
    assert TG.result_digest(t) == TG.result_digest(offline)


def test_replay_cli_prints_the_reference_digests(capsys):
    argv = ["replay", "--scenario", "flash_crowd", "--seed", "1",
            "--n-ticks", "3", "--policy", "fcfs"]
    for k, v in {**SMALL, **LOAD}.items():
        argv += ["--override", f"{k}={v}"]
    outs = []
    for cli in (TGCLI, RGCLI):
        rc = cli.main(list(argv))
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0 and "parity: OK" in outs[0][1]


# ===========================================================================
# wire protocol
# ===========================================================================

def test_envelope_lines_are_equal_and_each_parses_the_others():
    rng = np.random.default_rng(0)
    for _ in range(50):
        kw = dict(tick=int(rng.integers(0, 9)), u=int(rng.integers(0, 99)),
                  edge=int(rng.integers(0, 9)),
                  service=int(rng.integers(0, 99)),
                  alpha=float(rng.random()), delta=float(rng.random() * 10),
                  arrival=float(rng.random() * 100))
        t, r = TG.RequestEnvelope(**kw), RG.RequestEnvelope(**kw)
        assert t.to_line() == r.to_line()
        assert TG.RequestEnvelope.from_wire(TG.parse_frame(r.to_line())) \
            == t
        assert RG.RequestEnvelope.from_wire(RG.parse_frame(t.to_line())) \
            == r
    assert TG.eot_frame(3, 41) == RG.eot_frame(3, 41)
    assert TG.eos_frame() == RG.eos_frame()
    assert TG.GATEWAY_PROTOCOL_VERSION == RG.GATEWAY_PROTOCOL_VERSION


@pytest.mark.parametrize("line", [
    "", "   \n", "not json\n", '{"v": 99, "type": "req"}',
    '{"v": 1, "type": "nope"}', "[1,2,3]", '"a string"', "17",
    '{"type": "eot", "tick": 1}', '{"v": 1, "type": "eot", "tick": 2, '
    '"n": 5}', '{"v": 1, "type": "eos"}', '{"v": "1", "type": "req"}'])
def test_parse_frame_agrees_on_garbage_and_frames(line):
    assert TG.parse_frame(line) == RG.parse_frame(line)


def test_instance_from_requests_equal_and_raise_alike():
    t_sc = TW.get_scenario("edge_failure", **SMALL)
    r_sc = RW.get_scenario("edge_failure", **SMALL)
    t_cfg, r_cfg = _cfg(TH, scenario="edge_failure"), \
        _cfg(RH, scenario="edge_failure")
    for tick in (0, 4):     # edge 1 is dead from tick 3 on
        t_env = TG.tick_envelopes(t_sc, t_cfg, tick)
        r_env = RG.tick_envelopes(r_sc, r_cfg, tick)
        assert [e.to_line() for e in t_env] == [e.to_line() for e in r_env]
        t_inst, t_times = TG.instance_from_requests(t_sc, 0, tick,
                                                    t_env[::-1])
        r_inst, r_times = RG.instance_from_requests(r_sc, 0, tick, r_env)
        for f in ("K", "W", "R", "sm_service", "sm_acc", "sm_k", "sm_w",
                  "sm_r", "u_edge", "u_service", "u_alpha", "u_delta"):
            assert np.asarray(getattr(t_inst, f)).tobytes() == \
                np.asarray(getattr(r_inst, f)).tobytes(), f
        assert t_times.tobytes() == r_times.tobytes()
        for bad in ([], t_env[1:], t_env + t_env[:1]):
            with pytest.raises(ValueError) as te:
                TG.instance_from_requests(t_sc, 0, tick, bad)
            with pytest.raises(ValueError) as re_:
                RG.instance_from_requests(
                    r_sc, 0, tick, [RG.RequestEnvelope(
                        **dataclasses.asdict(e)) for e in bad])
            assert str(te.value) == str(re_.value)


def test_malformed_lines_are_counted_not_fatal():
    junk = ("garbage that is not json\n", '{"v": 7, "type": "req"}\n')
    t, tgw = _replay(TG, _cfg(TH, n_ticks=2), junk)
    r, rgw = _replay(RG, _cfg(RH, n_ticks=2), junk)
    assert tgw.counters == rgw.counters
    assert tgw.counters["gateway.malformed"] == 2
    assert tgw.tick_log == rgw.tick_log
    _same_result(t, r)


def test_step_idle_equals_the_reference():
    def run(horizon):
        ctl = horizon.TickController(_cfg(horizon, n_ticks=3))
        ctl.step(0, ctl.materialize(0))
        ctl.step_idle(1)
        ctl.step(2, ctl.materialize(2))
        return ctl.finalize()

    t, r = run(TH), run(RH)
    _same_result(t, r)
    assert t.per_tick[1].submitted == 0 and t.per_tick[1].served == 0


# ===========================================================================
# wall clock: structure only
# ===========================================================================

def test_tcp_ingest_wall_mode_end_to_end():
    cfg = _cfg(TH, n_ticks=3, seed=1)
    gw = TG.Gateway(TG.GatewayConfig(horizon=cfg, mode="wall", speed=50.0))

    async def _run():
        server = asyncio.ensure_future(gw.serve())
        while gw.bound_port is None:
            await asyncio.sleep(0.005)
        lg = await TG.tcp_loadgen("127.0.0.1", gw.bound_port, cfg,
                                  speed=50.0, n_ticks=3)
        return await server, lg

    result, lg = asyncio.run(_run())
    assert lg.ticks == 3 and lg.sent > 0
    assert set(lg.to_json()) == {f.name for f in
                                 dataclasses.fields(RG.LoadgenReport)}
    # frames still queued when the last deadline passes are neither
    # admitted nor late: a loaded host may leave some
    assert 0 < gw.counters["gateway.admitted"] + \
        gw.counters["gateway.late"] <= lg.sent
    assert len(result.per_tick) == 3
    assert result.served + result.dropped == result.submitted
    assert gw.registry.histogram("gateway.loop_lag_ms").count == 3
    assert gw.registry.histogram("gateway.admission_ms").count == \
        gw.counters["gateway.admitted"]
    assert [e["tick"] for e in gw.tick_log] == [0, 1, 2]


def test_wall_mode_empty_run_exits_cleanly():
    gw = TG.Gateway(TG.GatewayConfig(horizon=_cfg(TH, n_ticks=2),
                                     mode="wall", speed=10.0,
                                     start_timeout_s=0.05))
    result = asyncio.run(gw.run())
    assert result.per_tick == [] and result.requests == []
    assert gw.counters["gateway.ticks"] == 0


def test_gateway_config_rejects_what_the_reference_rejects():
    for kw in ({"mode": "fast"}, {"speed": 0.0}, {"speed": -1.0}):
        with pytest.raises(ValueError) as te:
            TG.GatewayConfig(**kw)
        with pytest.raises(ValueError) as re_:
            RG.GatewayConfig(**kw)
        assert str(te.value) == str(re_.value)


def test_soak_runs_and_reports_on_structure_only():
    """The soak's verdict, rates and latencies judge the host's wall clock;
    here only its shape is held (chip_smoke.py prints the verdict of a
    soak on a CUDA host)."""
    report = TG.run_soak("flash_crowd", seed=0, policy="feedback",
                         speed=40.0, duration_s=0.5,
                         overrides={**SMALL, **LOAD})
    d = report.to_json()
    assert set(d) == {f.name for f in dataclasses.fields(RG.SoakReport)} \
        | {"ok"}
    assert report.ticks >= 1 and report.sent > 0
    assert report.admitted + report.late + report.dropped_ingress \
        <= report.sent
    assert isinstance(report.ok, bool) and isinstance(report.bounded, bool)
    assert report.line().startswith(("[OK ] soak flash_crowd/s0",
                                      "[FAIL] soak flash_crowd/s0"))
    json.dumps(d)
