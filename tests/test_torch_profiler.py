"""The torch-profiler adapter (repro_torch.obs.torchprof) and the kernel
spans of the port's QoS dispatchers: with both packages' tracers on and
the same instance, the port records the reference's ``kernel.qos_matrix``
and ``kernel.qos_candidates`` spans with the reference's args; the
dispatchers' named scopes and the obs spans land in a CPU
``profile_trace`` dump, ring on or off, which is a valid Chrome trace; the
repo's device sums skip those ranges; outputs and launch counts do not
move; and on a card the profile finds each QoS kernel by name, as often
as ``LAUNCHES`` counts it, inside its dispatcher's scope.

JAX is imported by a fixture, so this file also runs where only the port
is installed (as on a card without JAX): the comparison with the
reference skips there and the card test runs."""
import json
import types

import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch import obs as tobs
from repro_torch.kernels.qos_matrix import ops
from repro_torch.obs import torchprof
from torch_recorders import recorders_off  # noqa: F401  (autouse)

#: The QoS kernels, the named scope of their dispatcher's CUDA branch,
#: and their LAUNCHES key.
KERNELS = (("qos_matrix_kernel", "qos_matrix_cuda", "qos_matrix"),
           ("topk_candidates_kernel", "qos_candidates_cuda",
            "qos_candidates"),
           ("greedy_argmax_kernel", "greedy_argmax_cuda", "greedy_argmax"))


@pytest.fixture
def ref():
    """The JAX package's core, QoS dispatchers and obs."""
    pytest.importorskip("jax")
    import repro.core as RC
    import repro.kernels.qos_matrix.ops as rops
    from repro import obs as robs

    return types.SimpleNamespace(core=RC, ops=rops, obs=robs)


def _spans(doc):
    """``[(name, args)]`` of every span of a saved artifact, in order."""
    names = doc["names"]
    args = doc.get("span_args", {})
    return [(names[nid], args.get(str(row), {}))
            for row, nid in enumerate(doc["spans"]["name"])]


def _instance(U=300, E=6, seed=3):
    return TC.synthetic_instance(U, n_edges=E, seed=seed)


def _port_calls(inst, k):
    ti = TC.TorchInstance.from_pies(inst, "cpu")
    table = TC.impl_table_np(inst.sm_service, inst.S)
    q = ops.qos_matrix_from_instance(ti)
    cand = ops.qos_candidates_from_instance(ti, table, k)
    return q, cand


@pytest.mark.parametrize("k", [None, 2])
def test_dispatchers_record_the_references_kernel_spans(ref, k):
    inst = _instance()
    rinst = ref.core.synthetic_instance(300, n_edges=6, seed=3)
    assert np.array_equal(rinst.u_alpha, inst.u_alpha)
    rtable = ref.core.impl_table_np(rinst.sm_service, rinst.S)
    ttr = tobs.enable()
    rtr = ref.obs.enable()
    try:
        _port_calls(inst, k)
        ji = rinst.as_jax()
        ref.ops.qos_matrix_from_instance(ji, use_kernel=False)
        ref.ops.qos_candidates_from_instance(ji, rtable, k,
                                             use_kernel=False)
    finally:
        tobs.disable()
        ref.obs.disable()
    port, want = _spans(ttr.snapshot()), _spans(rtr.snapshot())
    assert port == want
    assert port == [("kernel.qos_matrix", {"U": 300, "P": inst.P,
                                           "use_kernel": False}),
                    ("kernel.qos_candidates", {"U": 300,
                                               "k": -1 if k is None else k,
                                               "use_kernel": False})]


def test_spans_move_no_output_and_no_launch_count():
    inst = _instance(U=200, E=4, seed=5)
    ops.reset_launch_counts()
    q0, (ci0, cq0) = _port_calls(inst, None)
    tobs.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            q1, (ci1, cq1) = _port_calls(inst, None)
    finally:
        tobs.disable()
    assert torch.equal(q0, q1) and torch.equal(ci0, ci1) and \
        torch.equal(cq0, cq1)
    assert not any(ops.LAUNCHES.values())  # the plain versions launch none


def test_named_scope_follows_the_annotation_switch(ref):
    """The scope is a profiler range while a profiler collects, with the
    obs ring on or off, and the shared no-op span otherwise."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import _NULL_SPAN

    assert torchprof.named_scope("qos_matrix_ref") is _NULL_SPAN
    tobs.enable()
    try:
        assert torchprof.named_scope("qos_matrix_ref") is _NULL_SPAN
    finally:
        tobs.disable()
    for ring in (False, True):
        if ring:
            tobs.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                assert isinstance(torchprof.named_scope("qos_matrix_ref"),
                                  torch.profiler.record_function)
        finally:
            tobs.disable()
    assert torchprof.named_scope("qos_matrix_ref") is _NULL_SPAN
    assert torchprof.have_torch_profiler()
    assert tobs.kernel_span is torchprof.kernel_span
    robs = ref.obs
    assert set(robs.__all__) - set(tobs.__all__) == {"have_jax_profiler"}
    assert set(tobs.__all__) - set(robs.__all__) == {"have_torch_profiler"}


def test_a_profile_without_annotations_holds_no_scope(tmp_path):
    """A profile taken with the obs ring off holds the dispatcher's scope
    and its kernel span as ranges (user annotations), and the repo's
    device sums skip such events: a range on the device's timeline is no
    device work."""
    import chip_smoke

    inst = _instance(U=120, E=3, seed=1)
    ti = TC.TorchInstance.from_pies(inst, "cpu")
    with torchprof.profile_trace(tmp_path) as path:
        ops.qos_matrix_from_instance(ti)
    names = {e.get("name") for e in json.loads(open(path).read())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"qos_matrix_ref", "kernel.qos_matrix"} <= names
    assert "qos_matrix_cuda" not in names
    cuda = torch.autograd.DeviceType.CUDA
    events = [types.SimpleNamespace(name=n, device_type=cuda,
                                    is_user_annotation=ann)
              for n, ann in (("kernel.qos_matrix", True),
                             ("qos_matrix_kernel", False))]
    events.append(types.SimpleNamespace(
        name="aten::mul", device_type=torch.autograd.DeviceType.CPU,
        is_user_annotation=False))
    assert [e.name for e in chip_smoke.device_ops(events)] == \
        ["qos_matrix_kernel"]


def test_cpu_profile_trace_holds_scopes_and_spans(tmp_path):
    inst = _instance(U=120, E=3, seed=1)
    ti = TC.TorchInstance.from_pies(inst, "cpu")
    v = torch.rand(3, inst.P, generator=torch.Generator().manual_seed(0))
    tobs.enable()
    try:
        with torchprof.profile_trace(tmp_path / "prof") as path:
            ops.qos_matrix_from_instance(ti)
            ops.qos_candidates_from_instance(
                ti, TC.impl_table_np(inst.sm_service, inst.S))
            ops.greedy_argmax(v, v > 0.5)
    finally:
        tobs.disable()
    doc = json.loads(open(path).read())
    # a valid Chrome trace: every duration event is complete
    events = doc["traceEvents"]
    assert isinstance(events, list) and events
    xs = [e for e in events if e.get("ph") == "X"]
    for e in xs:
        assert {"name", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["dur"] >= 0
    ranges = {}
    for e in xs:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    for outer, inner in (("kernel.qos_matrix", "qos_matrix_ref"),
                         ("kernel.qos_candidates", "qos_candidates_ref")):
        (a0, a1), = ranges[outer]
        (b0, b1), = ranges[inner]
        assert a0 <= b0 <= b1 <= a1, (outer, inner)
    assert len(ranges["greedy_argmax_ref"]) == 1
    assert "greedy_argmax_cuda" not in ranges


def test_profile_trace_refuses_to_drop_cuda(tmp_path, monkeypatch):
    """On a CUDA machine whose torch cannot record CUDA activity the
    profile raises rather than hold the CPU alone."""
    import torch.profiler as tprof

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tprof, "supported_activities",
                        lambda: {tprof.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUDA"):
        with torchprof.profile_trace(tmp_path):
            pass


def test_kernel_launches_reads_a_chrome_trace():
    """Two launches of one kernel, one inside its scope, one outside; a
    kernel of another name; a launch call without a device event."""
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "greedy_argmax_cuda",
         "ts": 10.0, "dur": 5.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 11.0, "dur": 1.0, "pid": 1, "tid": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20.0, "dur": 1.0, "pid": 1, "tid": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12.0, "dur": 1.0, "pid": 1, "tid": 1,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "greedy_argmax_kernel(float)",
         "ts": 30.0, "dur": 4.0, "pid": 0, "tid": 7,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "greedy_argmax_kernel(float)",
         "ts": 40.0, "dur": 2.0, "pid": 0, "tid": 7,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "qos_matrix_kernel",
         "ts": 50.0, "dur": 2.0, "pid": 0, "tid": 7,
         "args": {"correlation": 10}},
        {"ph": "s", "name": "ac2g", "id": 7}]}
    got = torchprof.kernel_launches(doc, "greedy_argmax_kernel",
                                    "greedy_argmax_cuda")
    assert got == {"launches": 2, "device_ms": [0.004, 0.002],
                   "queued_ms": [0.019, 0.02], "in_scope": 1}
    assert torchprof.kernel_launches(doc, "qos_matrix_kernel",
                                     "qos_matrix_cuda")["in_scope"] == 0


def test_scope_device_ms_reads_a_chrome_trace():
    """Two ranges of one name: each sums the kernels, copies and sets its
    launch calls launched, whenever they ran; an operation launched
    before a range opened stays out of it; a device operation without its
    launch call is counted apart."""
    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1.0, "pid": 1, "tid": 1,
                "args": {"correlation": corr}}

    def device(cat, corr, ts, dur):
        return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur,
                "pid": 0, "tid": 7, "args": {"correlation": corr}}

    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "train.optimizer",
         "ts": 10.0, "dur": 10.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "train.optimizer",
         "ts": 100.0, "dur": 10.0, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train.optimizer",
         "ts": 12.0, "dur": 50.0, "pid": 0, "tid": 7},
        launch(1, 5.0), launch(2, 12.0), launch(3, 15.0), launch(4, 105.0),
        device("kernel", 1, 8.0, 10.0),        # launched before the range
        device("kernel", 2, 18.0, 4.0),
        device("gpu_memcpy", 3, 30.0, 2.0),    # runs after the range closed
        device("gpu_memset", 4, 106.0, 1.0),
        device("kernel", 5, 107.0, 3.0)]}      # no launch call
    got = torchprof.scope_device_ms(doc, "train.optimizer")
    assert got == {"ranges": [(10.0, 20.0), (100.0, 110.0)],
                   "device_ms": [0.006, 0.001], "ops": [2, 1],
                   "unpaired": 1}


@pytest.mark.cuda
def test_card_profile_finds_each_kernel_in_its_scope(tmp_path):
    """A sparse tick and a dense route on the card, profiled with the obs
    ring on: each QoS kernel appears by name as often as LAUNCHES counts
    it, every launch inside its dispatcher's scope."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.serving import Router
    from repro_torch.workloads import evaluate_sparse

    dev = torch.device("cuda")
    inst = _instance(U=4000, E=20, seed=2)
    router = Router(device=dev)
    _, xs = evaluate_sparse([inst], device=dev)      # warm: build, upload
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tobs.enable()
    try:
        with torchprof.profile_trace(tmp_path) as path:
            _, xs = evaluate_sparse([inst], device=dev)
            router.route(inst, placement=xs[0])
    finally:
        tobs.disable()
    for kernel, scope, key in KERNELS:
        got = torchprof.kernel_launches(path, kernel, scope)
        assert got["launches"] == ops.LAUNCHES[key] > 0, kernel
        assert got["in_scope"] == got["launches"], kernel
