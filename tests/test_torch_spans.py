"""The program's phases on the profiler's timeline: the training step
(``train.step`` nesting ``train.forward``/``train.backward`` once a
microbatch, then ``train.optimizer``) and ``ModelServer.generate``
(``serve.generate`` nesting ``serve.init_cache``, ``serve.prefill``, a
``serve.decode_step`` a step and ``serve.readback``) appear as
``record_function`` ranges whenever a torch profiler collects, whether or
not the obs ring is on; with neither on a span is the shared no-op and
``record_function`` is never entered; and spans move no bit of a loss, a
parameter or a generated token."""
import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.obs import torchprof
from repro_torch.obs.trace import _NULL_SPAN
from repro_torch.serving.engine import ModelServer
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_train_step, param_tree)
from torch_recorders import recorders_off  # noqa: F401  (autouse)

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def _cfg():
    return get_smoke_config("mamba2_2p7b").with_(dtype="float32")


def _batch(cfg, B=4, S=16):
    return {k: torch.from_numpy(v) for k, v in
            TokenPipeline(cfg, global_batch=B, seq_len=S, seed=2)
            .batch_at(0).items()}


def _state(cfg):
    return init_train_state(cfg, OPT, torch.Generator().manual_seed(5),
                            device="cpu")


def _server(cfg):
    return ModelServer(cfg, bucket_batch=2, bucket_seq=32, seed=3,
                       device="cpu")


def _prompts(cfg):
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12))


def _ranges(prof, prefix):
    """``[(name, start_us, end_us)]`` of the profile's ranges whose name
    starts with ``prefix``, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_spans_nest_in_order(grad_accum):
    cfg = _cfg()
    step = make_train_step(cfg, OPT, grad_accum=grad_accum)
    state, batch = _state(cfg), _batch(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    got = _ranges(prof, "train.")
    outer, inner = got[0], got[1:]
    assert outer[0] == "train.step"
    assert [n for n, _, _ in inner] == \
        ["train.forward", "train.backward"] * grad_accum + \
        ["train.optimizer"]
    assert all(_inside(r, outer) for r in inner)
    # one after another, none inside the one before
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_generate_spans_nest_in_order():
    cfg = _cfg()
    server = _server(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.generate(_prompts(cfg), n_steps=2)
    got = _ranges(prof, "serve.")
    outer, inner = got[0], got[1:]
    assert outer[0] == "serve.generate"
    assert [n for n, _, _ in inner] == [
        "serve.init_cache", "serve.prefill", "serve.decode_step",
        "serve.decode_step", "serve.readback"]
    assert all(_inside(r, outer) for r in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_the_ring_records_the_phases_with_their_args():
    cfg = _cfg()
    step = make_train_step(cfg, OPT)
    server = _server(cfg)
    state, batch = _state(cfg), _batch(cfg)
    tracer = obs.enable()
    try:
        step(state, batch)
        server.generate(_prompts(cfg), n_steps=2)
    finally:
        obs.disable()
    doc = tracer.snapshot()
    names = [doc["names"][i] for i in doc["spans"]["name"]]
    # a span is recorded when it closes: the inner ones first
    assert names == ["train.forward", "train.backward", "train.optimizer",
                     "train.step", "serve.init_cache", "serve.prefill",
                     "serve.decode_step", "serve.decode_step",
                     "serve.readback", "serve.generate"]
    depth = dict(zip(names, doc["spans"]["depth"]))
    assert depth["train.step"] == depth["serve.generate"] == 0
    assert depth["train.optimizer"] == depth["serve.prefill"] == 1
    assert doc["span_args"][str(names.index("serve.generate"))] == \
        {"b": 2, "s": 12, "n_steps": 2}


def test_neither_on_enters_no_record_function(monkeypatch):
    """With no tracer and no profiler a span is the shared no-op, and the
    step and a call run without entering ``record_function``."""

    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered with nothing on")

    monkeypatch.setattr(autograd_profiler, "record_function", Refused)
    assert not obs.enabled()
    assert not autograd_profiler._is_profiler_enabled
    assert obs.span("train.step") is _NULL_SPAN
    assert obs.kernel_span("qos_matrix", U=3) is _NULL_SPAN
    assert torchprof.named_scope("qos_matrix_ref") is _NULL_SPAN
    cfg = _cfg()
    make_train_step(cfg, OPT, grad_accum=2)(_state(cfg), _batch(cfg))
    _server(cfg).generate(_prompts(cfg), n_steps=2)


def test_spans_move_no_bit():
    """The loss, every parameter after a step and the generated tokens are
    the same bits with the profiler and the ring on as with both off."""
    cfg = _cfg()

    def run():
        state, batch = _state(cfg), _batch(cfg)
        state, met = make_train_step(cfg, OPT, grad_accum=2)(state, batch)
        toks, _, _ = _server(cfg).generate(_prompts(cfg), n_steps=3)
        return met["loss"], param_tree(state.params), toks

    loss0, params0, toks0 = run()
    obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            loss1, params1, toks1 = run()
    finally:
        obs.disable()
    assert any(e.name == "train.optimizer" for e in prof.events())
    assert torch.equal(loss0, loss1)
    assert params0.keys() == params1.keys()
    assert all(torch.equal(params0[n], params1[n]) for n in params0)
    np.testing.assert_array_equal(toks0, toks1)
