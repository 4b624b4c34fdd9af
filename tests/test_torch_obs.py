"""The port's obs core against the JAX package's: the same spans, counters,
gauges and histograms give the same artifact; each package loads the
other's saved artifact; the Chrome export validates in both; spans mirror
into torch.profiler with ``annotations=True``; and tracing changes no byte
of a stored sweep."""
import json
import os

import numpy as np
import pytest

from repro import obs as robs
from repro_torch import obs as tobs

SMALL = (("max_impls", 3), ("n_services", 8), ("n_user_slots", 40))


@pytest.fixture(autouse=True)
def _obs_off():
    """Tracing is off by default and never leaks between tests."""
    assert not tobs.enabled() and not robs.enabled()
    yield
    tobs.disable()
    robs.disable()


def _fake_clock(step_ns=1000, start=1000):
    state = {"t": start - step_ns}

    def clock():
        state["t"] += step_ns
        return state["t"]

    return clock


def _drive(mod, capacity=16):
    """One sequence of recordings: nested spans with args, counters, gauge
    samples and labelled metrics series."""
    tr = mod.Tracer(capacity=capacity, clock=_fake_clock())
    with tr.span("sweep.chunk", {"items": 3, "algo": "egp"}):
        with tr.span("sweep.materialize"):
            tr.sample("queue", 2.0)
        with tr.span("store.add_chunk", {"rows": 3}):
            pass
    tr.count("items", 3)
    tr.count("items", 2.5)
    reg = tr.metrics
    reg.counter("sweep.items", executor="accel").inc(64)
    reg.counter("sweep.items", executor="accel").inc(1)
    reg.gauge("placement.bucket_pad_waste").set(0.375)
    h = reg.histogram("sweep.items_per_s", executor="host")
    for v in (1e-12, 0.5, 3.0, 3.0, 1e4, float("nan")):
        h.observe(v)
    reg.histogram("lat", growth=2.0, min_value=1e-3).observe_many(
        [0.001, 0.002, 0.5])
    return tr


def _comparable(doc):
    return {k: v for k, v in doc.items() if k not in ("pid", "anchor")}


def test_same_recordings_give_the_reference_artifact():
    tdoc, rdoc = _drive(tobs).snapshot(), _drive(robs).snapshot()
    assert _comparable(tdoc) == _comparable(rdoc)
    assert tdoc["obs_schema"] == robs.OBS_SCHEMA_VERSION == \
        tobs.OBS_SCHEMA_VERSION
    # nesting: inner spans close first, at depth 1
    names = [tdoc["names"][i] for i in tdoc["spans"]["name"]]
    assert names == ["sweep.materialize", "store.add_chunk", "sweep.chunk"]
    assert tdoc["spans"]["depth"] == [1, 1, 0]
    assert tdoc["span_args"] == {"1": {"rows": 3},
                                 "2": {"items": 3, "algo": "egp"}}
    assert tdoc["counters"] == {"items": 5.5}
    assert set(tdoc["anchor"]) == {"wall_ns", "mono_ns"}


def test_ring_wrap_and_metrics_parity():
    t, r = _drive(tobs, capacity=2), _drive(robs, capacity=2)
    assert t.dropped_spans == r.dropped_spans == 1
    assert _comparable(t.snapshot()) == _comparable(r.snapshot())
    assert t.metrics.to_jsonl() == r.metrics.to_jsonl()
    assert json.dumps(t.metrics.histograms()) == \
        json.dumps(r.metrics.histograms())
    np.testing.assert_array_equal(t.span_durations_s("sweep.chunk"),
                                  r.span_durations_s("sweep.chunk"))
    # each registry rebuilds from the other's snapshot, and merges alike
    tr_ = tobs.MetricsRegistry.from_snapshot(r.metrics.snapshot())
    rt_ = robs.MetricsRegistry.from_snapshot(t.metrics.snapshot())
    assert tr_.to_jsonl() == rt_.to_jsonl() == t.metrics.to_jsonl()
    assert tr_.merge(t.metrics).to_jsonl() == rt_.merge(r.metrics).to_jsonl()
    rng = np.random.default_rng(0)
    vals = rng.lognormal(-3, 1.5, 2000)
    th, rh = tobs.Histogram(), robs.Histogram()
    th.observe_many(vals)
    rh.observe_many(vals)
    assert th.summary() == rh.summary() and th.record() == rh.record()
    with pytest.raises(ValueError):
        tobs.Histogram(growth=1.0)


def test_module_switch_and_env(monkeypatch, tmp_path):
    assert tobs.get_tracer() is None and not tobs.enabled()
    with tobs.span("off"):
        pass
    tobs.count("off")
    tobs.sample("off", 1.0)
    assert tobs.save(tmp_path / "none.json") is False
    tr = tobs.enable(capacity=8)
    with tobs.span("on", k=1):
        tobs.count("c", 2)
        tobs.sample("g", 3.0)
    assert tobs.disable() is tr and tr.n_spans == 1
    assert tr.counters == {"c": 2}
    monkeypatch.setenv("REPRO_OBS", "0")
    assert tobs.enable_from_env() is None
    monkeypatch.setenv("REPRO_OBS", "1")
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    assert tobs.enable_from_env() is tobs.get_tracer() is not None


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_loads_the_others_artifact(tmp_path, writer):
    mods = {"port": (tobs, robs), "ref": (robs, tobs)}[writer]
    tr = _drive(mods[0])
    path = tmp_path / "obs.json"
    tr.save(path)
    doc = mods[1].load_artifact(path)
    assert doc == json.loads(path.read_text())
    assert _comparable(doc) == _comparable(_drive(mods[1]).snapshot())
    bad = dict(doc, obs_schema=99)
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="schema"):
        mods[1].load_artifact(tmp_path / "bad.json")


def test_chrome_export_validates_in_both_packages():
    doc = _drive(tobs).snapshot()
    doc["pid"] = 7
    tchrome, rchrome = tobs.to_chrome_trace(doc), robs.to_chrome_trace(doc)
    assert tobs.validate_chrome_trace(tchrome) == \
        robs.validate_chrome_trace(tchrome) == 3
    # the reference's export, apart from the process name
    assert tchrome["traceEvents"][0]["args"] == {"name": "repro_torch.obs"}
    assert tchrome["traceEvents"][1:] == rchrome["traceEvents"][1:]
    assert tchrome["otherData"] == rchrome["otherData"]
    assert tobs.Tracer(clock=_fake_clock()).chrome_trace()["traceEvents"]
    for bad in ({}, {"traceEvents": [{"ph": "X", "name": "a", "ts": 0,
                                      "dur": 0, "pid": 0, "tid": 0}]}):
        with pytest.raises(ValueError):
            tobs.validate_chrome_trace(bad)


def test_annotations_mirror_spans_into_torch_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    tr = tobs.enable(annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tobs.span("sweep.chunk", items=1):
            torch.ones(4).sum()
    assert tr.n_spans == 1
    assert "sweep.chunk" in {e.key for e in prof.key_averages()}


def test_tracing_changes_no_stored_sweep_byte(tmp_path):
    from repro_torch.sweeps import SweepSpec, SweepStore, run_sweep

    spec = SweepSpec(scenarios=("flash_crowd", "edge_failure"), seeds=(0, 1),
                     n_ticks=4, algos=("egp", "agp", "sck"),
                     override_grid=(SMALL,))
    off = run_sweep(spec, store_dir=tmp_path / "off", device="cpu",
                    chunk_size=3)
    tr = tobs.enable(annotations=True)
    on = run_sweep(spec, store_dir=tmp_path / "on", device="cpu",
                   chunk_size=3)
    tobs.disable()
    names = {tr._names[i] for i in tr.snapshot()["spans"]["name"]}
    assert names == {"sweep.materialize", "sweep.chunk", "store.add_chunk"}
    assert tr.metrics.counter("sweep.items", executor="accel").value == 32
    for key in off.values:
        assert off.values[key].tobytes() == on.values[key].tobytes()
    a, b = SweepStore(tmp_path / "off"), SweepStore(tmp_path / "on")
    assert a.keys() == b.keys() and len(a) == 48
    for key in a.keys():
        assert np.float64(a.value(key)).tobytes() == \
            np.float64(b.value(key)).tobytes()
    ca, cb = a.chunks(), b.chunks()
    assert [c["keys"] for c in ca] == [c["keys"] for c in cb]
    assert [c["shard"] for c in ca] == [c["shard"] for c in cb]
    for c, d in zip(ca, cb):       # wall times are exempt
        assert {k: v for k, v in c["meta"].items() if k != "wall_s"} == \
            {k: v for k, v in d["meta"].items() if k != "wall_s"}
        va, vb = a.chunk_data(c["shard"]), b.chunk_data(d["shard"])
        assert va["values"].tobytes() == vb["values"].tobytes()
    assert sorted(os.listdir(tmp_path / "off" / "shards")) == \
        sorted(os.listdir(tmp_path / "on" / "shards"))
