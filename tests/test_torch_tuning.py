"""The port's tuning layer against the JAX package's: the packaged lookup
table byte for byte, load_table/recommend for every scenario, fit_table
over a serving store either package wrote, the FeedbackPlacer's clamps and
direction, and a feedback horizon byte for byte."""
from pathlib import Path

import numpy as np
import pytest

import repro.serving.horizon as RH
import repro.sweeps as RSW
import repro.tuning.controller as RCTL
import repro.tuning.fit as RFIT
import repro_torch.serving.horizon as TH
import repro_torch.sweeps as TSW
import repro_torch.tuning as TT
import repro_torch.tuning.controller as TCTL
import repro_torch.tuning.fit as TFIT
from repro import obs as robs
from repro.gateway.control import result_digest
from repro.obs import ledger as rledger
from repro.obs import reqtrace as rreqtrace
from repro_torch import obs as tobs
from repro_torch.obs import ledger as tledger
from repro_torch.obs import reqtrace as treqtrace
from repro_torch.workloads import list_scenarios

ROOT = Path(__file__).resolve().parents[1]
#: The reference's shrunk scenario and congested load point, and its
#: open-loop knob grid (tests/test_tuning.py).
SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
LOAD = {"prompt_tokens": 768, "new_tokens": 64, "max_batch": 4}
KNOBS = ((0.0, 0.0), (0.0, 3.0), (2.0, 0.0), (2.0, 3.0))


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


def _grid():
    return tuple(
        tuple(sorted({**SMALL, **LOAD, "switching_cost": sc,
                      "stickiness": st}.items()))
        for sc, st in KNOBS)


def _spec(mod, **kw):
    base = dict(kind="serving", scenarios=("flash_crowd", "steady"),
                seeds=(0, 1), n_ticks=2, algos=("edf", "fcfs"),
                override_grid=_grid())
    base.update(kw)
    return mod.SweepSpec(**base)


def test_packaged_table_is_a_byte_copy():
    ref = ROOT / "src" / "repro" / "tuning" / "tables" / "default.json"
    assert TFIT.DEFAULT_TABLE_PATH.read_bytes() == ref.read_bytes()
    assert TFIT.DEFAULT_TABLE_PATH == \
        ROOT / "src" / "repro_torch" / "tuning" / "tables" / "default.json"
    assert (TFIT.TABLE_ENV_VAR, TFIT.TABLE_VERSION) == \
        (RFIT.TABLE_ENV_VAR, RFIT.TABLE_VERSION)
    assert "repro_torch.tuning" in (ROOT / "pyproject.toml").read_text()


def test_load_table_and_recommend_are_the_reference(tmp_path, monkeypatch):
    assert TFIT.load_table() == RFIT.load_table()
    for sc in list(list_scenarios()) + ["no_such_scenario"]:
        assert TT.recommend(sc) == RFIT.recommend(sc), sc
    # a table named by the environment moves both packages alike
    table = {"table_version": 1, "scenarios": {
        "steady": {"switching_cost": 1.0, "stickiness": 5.0}}}
    TFIT.save_table(table, tmp_path / "t.json")
    monkeypatch.setenv(TFIT.TABLE_ENV_VAR, str(tmp_path / "t.json"))
    assert TT.recommend("steady") == RFIT.recommend("steady") == \
        {"switching_cost": 1.0, "stickiness": 5.0}
    assert TT.recommend("diurnal") is None
    # a foreign layout or a missing file is ignored, never raised
    (tmp_path / "v9.json").write_text('{"table_version": 9}')
    for path in (tmp_path / "v9.json", tmp_path / "absent.json"):
        assert TFIT.load_table(path) is None
        assert RFIT.load_table(path) is None


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_fit_table_is_the_reference(writer, tmp_path):
    """Either package's serving store fits to the same table in both."""
    mod = TSW if writer == "port" else RSW
    store = tmp_path / "store"
    mod.run_sweep(_spec(mod), store_dir=store)
    got = TFIT.fit_table(store, source="grid")
    assert got == RFIT.fit_table(store, source="grid")
    assert set(got["scenarios"]) == {"flash_crowd", "steady"}
    assert [r.value for r in TFIT.read_serving_records(store)] == \
        [r.value for r in RFIT.read_serving_records(store)]
    # the fitted knobs flow into a horizon's config as in the reference
    TFIT.save_table(got, tmp_path / "fit.json")
    row = TT.recommend("steady", path=tmp_path / "fit.json")
    assert row == RFIT.recommend("steady", path=tmp_path / "fit.json")
    with pytest.raises(ValueError):
        TFIT.fit_table(tmp_path / "empty")


@pytest.mark.parametrize("gain,s0", [(1.05, -5.0), (1.5, 3.0), (4.0, 20.0),
                                     (2.0, 0.0)])
def test_feedback_placer_clamps_and_arithmetic(gain, s0):
    """Stickiness stays within its clamps through a long observation
    sequence, step for step equal to the reference's EWMA arithmetic."""
    rng = np.random.default_rng(int(gain * 100) + int(s0))
    t = TCTL.FeedbackPlacer(stickiness=s0, gain=gain)
    r = RCTL.FeedbackPlacer(stickiness=s0, gain=gain)
    assert (TT.STICKINESS_MIN, TT.STICKINESS_MAX) == \
        (RCTL.STICKINESS_MIN, RCTL.STICKINESS_MAX)
    assert TT.STICKINESS_MIN <= t.current_stickiness <= TT.STICKINESS_MAX
    for qos, miss, n in zip(rng.random(40), rng.random(40) ** 3,
                            rng.integers(0, 20, 40)):
        s = t.observe(float(qos), float(miss), int(n))
        assert s == r.observe(float(qos), float(miss), int(n))
        assert TT.STICKINESS_MIN <= s <= TT.STICKINESS_MAX


def test_feedback_controller_direction():
    fp = TCTL.FeedbackPlacer(stickiness=2.0, gain=2.0, target_miss=0.1)
    s = [fp.observe(0.8, 0.9, 10) for _ in range(3)][-1]
    assert s > 2.0                       # sustained misses: lock in
    assert fp.observe(0.0, 0.0, 0) == s  # no completions, no signal
    fp2 = TCTL.FeedbackPlacer(stickiness=4.0, gain=2.0, target_miss=0.5)
    fp2.observe(0.95, 0.0, 10)
    for _ in range(4):
        fp2.observe(0.05, 0.0, 10)       # QoS collapses, misses fine
    assert fp2.current_stickiness < 4.0  # the placement went stale: loosen
    with pytest.raises(ValueError):
        TCTL.FeedbackPlacer(gain=1.0)
    with pytest.raises(ValueError):
        TCTL.FeedbackPlacer(ewma=0.0)


@pytest.mark.parametrize("scenario", ["flash_crowd", "edge_failure"])
def test_feedback_horizon_is_the_reference(scenario):
    kw = dict(scenario=scenario, overrides=tuple(SMALL.items()),
              policy="feedback", seed=0, n_ticks=6, **LOAD)
    res = TH.run_horizon(TH.HorizonConfig(**kw))
    assert result_digest(res) == \
        result_digest(RH.run_horizon(RH.HorizonConfig(**kw)))
    assert all(TT.STICKINESS_MIN <= t.stickiness <= TT.STICKINESS_MAX
               for t in res.per_tick)
    assert res.per_tick[0].stickiness == res.config.stickiness
    again = TH.run_horizon(TH.HorizonConfig(**kw))
    assert result_digest(again) == result_digest(res)
