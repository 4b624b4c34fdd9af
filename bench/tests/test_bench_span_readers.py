"""The readers of the program's own ranges, on hand-built traces:
``prefill_device_ms.score`` takes the card's busy time inside each traced
call's ``serve.prefill`` range, by prompt length, weighted by the
window's calls; ``optimizer_ms.train`` pairs the window's launch calls
with its device operations in order and sums the operations launched
inside ``train.optimizer``; both read nothing where the program marks no
such range."""
from pathlib import Path
from types import SimpleNamespace

from bench import harness
from bench.tracing import CALL, Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _reader(name):
    return harness.load_module(METRICS / f"{name}.py",
                               "bench_metric_" + name.replace(".", "_"))


def _score_view(trace, window_lens):
    return SimpleNamespace(trace=trace, record={
        "calls": [{"len": n} for n in window_lens], "span_s": 1.0,
        "traced": {"calls": [{"len": 8}, {"len": 16}, {"len": 8}]}})


def _score_trace(prefill=True):
    # three traced calls: lengths 8, 16, 8; in each, a prefill followed by
    # a decode step the reading leaves out
    host = [(CALL, 0, 100), (CALL, 100, 200), (CALL, 200, 300)]
    if prefill:
        host += [("serve.prefill", 5, 50), ("serve.prefill", 105, 170),
                 ("serve.prefill", 205, 260)]
    device = [("k", 10, 30), ("k", 40, 50), ("dec", 60, 90),   # 30 us
              ("k", 110, 170), ("dec", 175, 190),              # 60 us
              ("k", 210, 250), ("dec", 265, 280)]              # 40 us
    return Trace(device=device, host=host, window=(0, 300))


def test_prefill_device_time_by_length_weighted_by_the_window():
    read = _reader("prefill_device_ms.score").read
    # length 8: (30 + 40) / 2 = 35 us; length 16: 60 us; the window served
    # 8, 16, 16: (35 + 60 + 60) / 3 us
    got = read(_score_view(_score_trace(), [8, 16, 16]))
    assert abs(got - 1e-3 * (35 + 60 + 60) / 3) < 1e-12
    got = read(_score_view(_score_trace(), [8, 8, 8, 16]))
    assert abs(got - 1e-3 * (3 * 35 + 60) / 4) < 1e-12
    # a length the traced calls did not take: no reading
    assert read(_score_view(_score_trace(), [8, 32])) is None


def _train_trace(optimizer=True):
    host = [("train.step", 0, 65),
            ("cudaLaunchKernel", 10, 12),                    # A
            ("cudaLaunchKernel", 20, 22),                    # B
            ("cudaLaunchKernel", 35, 37),                    # C
            # a cuLaunchKernel reported inside its cudaLaunchKernel: one launch
            ("cudaLaunchKernel", 40, 45), ("cuLaunchKernel", 41, 43),  # D
            ("cudaMemcpyAsync", 50, 52),                     # E
            ("aten::mul", 49, 53),
            ("cudaLaunchKernel", 70, 72)]                    # F, next step
    if optimizer:
        host.append(("train.optimizer", 30, 60))
    device = [("A", 15, 40),   # launched before the range, runs into it
              ("B", 40, 55),   # launched before the range, runs inside it
              ("C", 55, 65),   # launched inside: 10 us
              ("Stream Sync", 50, 60),   # the profiler's record, no op
              ("D", 65, 80),   # launched inside, runs after it: 15 us
              ("Memcpy DtoD (Device -> Device)", 80, 85),   # E: 5 us
              ("F", 85, 100)]
    return Trace(device=device, host=host, window=(0, 120))


def test_optimizer_time_pairs_launches_with_operations_in_order():
    read = _reader("optimizer_ms.train").read
    view = SimpleNamespace(trace=_train_trace(),
                           record={"traced": {"steps": 1}})
    assert abs(read(view) - 30e-3) < 1e-12
    view.record["traced"]["steps"] = 2
    assert abs(read(view) - 15e-3) < 1e-12


def test_no_reading_without_the_programs_ranges():
    train = _reader("optimizer_ms.train").read
    score = _reader("prefill_device_ms.score").read
    assert train(SimpleNamespace(trace=_train_trace(optimizer=False),
                                 record={"traced": {"steps": 1}})) is None
    assert train(SimpleNamespace(trace=None,
                                 record={"traced": {"steps": 0}})) is None
    assert score(_score_view(_score_trace(prefill=False), [8])) is None
    assert score(_score_view(None, [8])) is None
