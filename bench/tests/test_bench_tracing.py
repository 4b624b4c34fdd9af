"""The reduction of a traced window: the card's busy time is the union of
its operations inside the window, and each idle gap is labelled by the
innermost host range open at its middle."""
from bench.tracing import Trace, breakdown


def test_busy_is_the_union_inside_the_window():
    t = Trace(device=[("a", 0, 30), ("b", 20, 40), ("c", 90, 120)],
              window=(10, 100))
    assert t.busy_s() == (30 + 10) / 1e6
    assert t.seconds_by_name() == {"a": 20e-6, "b": 20e-6, "c": 10e-6}
    # busy time inside a stretch of the window: 25..40 and 90..95
    assert t.busy_between(25, 95) == (15 + 5) / 1e6


def test_idle_readers_take_device_time_over_the_untraced_window():
    from pathlib import Path
    from types import SimpleNamespace

    from bench import harness
    from bench.tracing import CALL

    metrics = Path(__file__).resolve().parents[1] / "metrics"
    # two traced steps of 30 us of device time each, against an untraced
    # window of 4 steps in 240 us: 60 us a step, so half of it idle
    t = Trace(device=[("k", 0, 30), ("k", 100, 130)], window=(0, 200))
    view = SimpleNamespace(trace=t, record={
        "steps": 4, "window_s": 240e-6, "traced": {"steps": 2}})
    train = harness.load_module(metrics / "device_idle_pct.train.py", "t")
    assert abs(train.read(view) - 50.0) < 1e-9
    # traced calls of lengths 8 and 16 with 10 and 30 us of device time;
    # the window served 8, 16, 8 in a span of 100 us: 50 us busy
    t = Trace(device=[("k", 0, 10), ("k", 20, 50)],
              host=[(CALL, 0, 15), (CALL, 15, 60)], window=(0, 60))
    view = SimpleNamespace(trace=t, record={
        "calls": [{"len": 8}, {"len": 16}, {"len": 8}], "span_s": 100e-6,
        "traced": {"calls": [{"len": 8}, {"len": 16}]}})
    score = harness.load_module(metrics / "device_idle_pct.score.py", "s")
    assert abs(score.read(view) - 50.0) < 1e-9


def test_idle_gaps_by_the_innermost_open_host_range():
    t = Trace(device=[("k", 10, 20), ("k", 50, 60)],
              host=[("outer", 0, 100), ("inner", 25, 45), ("late", 61, 70)],
              window=(0, 100))
    assert t.idle_gaps() == {"gaps under 20 us": 10e-6, "inner": 30e-6,
                             "outer": 40e-6}
    t = Trace(device=[("k", 10, 20)], host=[("a", 0, 5), ("b", 30, 40)],
              window=(0, 100))
    assert t.idle_gaps()["host outside any range"] == 80e-6
    assert breakdown(t)["device_ops"] == [["k", 10e-6]]
