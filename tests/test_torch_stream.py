"""The port's live telemetry stream (repro_torch.obs.stream) against the JAX
package's: the same bytes on the wire, each package reads and validates
the other's files, a gateway replay and a horizon publish the reference's
frames in the reference's order, streaming changes no digest and no
stored sweep byte, the sweep engine publishes its chunk frames (also
through the sweep CLI's --stream), and a follower survives a truncated
file."""
import asyncio
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.gateway as RG
import repro.obs.stream as RS
import repro.serving.horizon as RH
import repro.sweeps.shard as RSH
import repro_torch.gateway as TG
import repro_torch.obs.stream as TS
import repro_torch.serving.horizon as TH
import repro_torch.sweeps.shard as TSH
from repro import obs as robs
from repro_torch import obs as tobs
from torch_recorders import recorders_off  # noqa: F401  (autouse)

SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
LOAD = dict(prompt_tokens=768, new_tokens=64, max_batch=4)
#: The only frame fields that read a clock: the frame's wall time. (The
#: hello's pid is the same process in both runs; the virtual gateway's
#: lag and admission samples are not taken, so its frames read no clock.)
CLOCK_FIELDS = ("t",)
PKG = {"port": (tobs, TS, TG, TH), "ref": (robs, RS, RG, RH)}


def _fake_clock(step=1.0, start=100.0):
    state = {"t": start - step}

    def clock():
        state["t"] += step
        return state["t"]

    return clock


def _cfg(horizon, **kw):
    base = dict(scenario="flash_crowd", overrides=tuple(SMALL.items()),
                policy="edf", seed=0, n_ticks=3, **LOAD)
    base.update(kw)
    return horizon.HorizonConfig(**base)


def _replay(gateway, hconfig, **gw_kw):
    gw = gateway.Gateway(gateway.GatewayConfig(horizon=hconfig,
                                               mode="virtual", **gw_kw))

    async def _run():
        async def send(line):
            gw.submit_line(line)

        task = asyncio.ensure_future(gw.run())
        await gateway.run_loadgen(send, hconfig, wall=False)
        return await task

    return asyncio.run(_run())


def _streamed(pkg, path, run):
    """``run()`` with ``pkg``'s stream on to ``path``; its result."""
    obs = PKG[pkg][0]
    obs.enable_stream(str(path), source="stream-test")
    try:
        return run()
    finally:
        obs.disable_stream()


def _without_clock(frame):
    return {k: v for k, v in frame.items() if k not in CLOCK_FIELDS}


# ===========================================================================
# the wire
# ===========================================================================

def test_publishers_write_the_same_bytes(tmp_path):
    lines = {}
    for name, (_, stream, _, _) in PKG.items():
        path = tmp_path / f"{name}.jsonl"
        pub = stream.StreamPublisher(stream.FileSink(path), source="golden",
                                     clock=_fake_clock())
        pub.emit("tick", {"tick": 0, "queue_depth": 3, "qos": 0.5})
        pub.emit("chunk", {"executor": "accel", "items": 4,
                           "items_per_s": None})
        pub.close()
        lines[name] = path.read_bytes()
    assert lines["port"] == lines["ref"]
    assert TS.STREAM_SCHEMA_VERSION == RS.STREAM_SCHEMA_VERSION


@pytest.mark.parametrize("spec", ["1", "true", "ON", "unix:/tmp/x.sock",
                                  "tcp:0.0.0.0:9000", "tcp:9000",
                                  "/a/b.jsonl", "relative.jsonl"])
def test_parse_stream_spec_agrees(spec):
    assert TS.parse_stream_spec(spec, "d.jsonl") == \
        RS.parse_stream_spec(spec, "d.jsonl")
    assert TS.parse_stream_spec(spec) == RS.parse_stream_spec(spec)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_reads_the_others_stream(tmp_path, writer):
    path = tmp_path / "s.jsonl"
    _, _, gateway, horizon = PKG[writer]
    _streamed(writer, path, lambda: _replay(gateway, _cfg(horizon)))
    reader = "ref" if writer == "port" else "port"
    stream = PKG[reader][1]
    frames = list(stream.read_stream(str(path)))
    assert frames == list(PKG[writer][1].read_stream(str(path)))
    v = stream.FrameValidator(contiguous=True)
    for line in path.read_text().splitlines():
        v.feed_line(line)
    kinds = [f["type"] for f in frames]
    assert kinds[0] == "hello" and kinds[-1] == "bye"
    assert kinds.count("gateway") == 3 and "horizon" in kinds


@pytest.mark.parametrize("mode", ["gateway", "horizon"])
def test_frames_equal_the_reference_except_clock_fields(tmp_path, mode):
    frames = {}
    for pkg, (obs, stream, gateway, horizon) in PKG.items():
        path = tmp_path / f"{pkg}.jsonl"
        if mode == "gateway":
            def run():
                return _replay(gateway, _cfg(horizon, policy="feedback",
                                             seed=2), metrics_every=2)
        else:
            def run():
                obs.enable_ledger()
                obs.enable_request_tracing(sample_every=4)
                try:
                    return horizon.run_horizon(_cfg(
                        horizon, scenario="edge_failure", n_ticks=5))
                finally:
                    obs.disable_request_tracing()
                    obs.disable_ledger()
        _streamed(pkg, path, run)
        frames[pkg] = [_without_clock(f)
                       for f in stream.read_stream(str(path))]
    kinds = [f["type"] for f in frames["port"]]
    assert kinds == [f["type"] for f in frames["ref"]]
    assert frames["port"] == frames["ref"]
    expect = {"gateway": {"hello", "tick", "gateway", "metrics", "horizon",
                          "bye"},
              "horizon": {"hello", "tick", "reqtrace", "ledger", "horizon",
                          "bye"}}[mode]
    assert set(kinds) == expect


# ===========================================================================
# streaming is observational only
# ===========================================================================

def test_stream_on_changes_no_digest(tmp_path):
    cfg = _cfg(TH, policy="feedback", n_ticks=4)
    off = TG.result_digest(_replay(TG, cfg))
    on = _streamed("port", tmp_path / "g.jsonl", lambda: _replay(TG, cfg))
    assert TG.result_digest(on) == off
    horizon_off = TG.result_digest(TH.run_horizon(cfg))
    horizon_on = _streamed("port", tmp_path / "h.jsonl",
                           lambda: TH.run_horizon(cfg))
    assert TG.result_digest(horizon_on) == horizon_off == off


def test_stream_on_changes_no_stored_sweep_byte(tmp_path):
    from repro_torch.sweeps import SweepSpec, SweepStore, run_sweep

    grid = ({**SMALL, **LOAD, "switching_cost": 0.0, "stickiness": 0.0},)
    serving = SweepSpec(kind="serving", scenarios=("steady",), seeds=(0, 1),
                        n_ticks=2, algos=("edf",), override_grid=grid)
    accel = SweepSpec(scenarios=("flash_crowd",), seeds=(0, 1), n_ticks=2,
                      algos=("egp", "sck"),
                      override_grid=({"n_user_slots": 24},))
    for name, spec in (("serving", serving), ("accel", accel)):
        run_sweep(spec, store_dir=tmp_path / f"{name}_off", device="cpu",
                  chunk_size=2)
        path = tmp_path / f"{name}.jsonl"
        _streamed("port", path, lambda: run_sweep(
            spec, store_dir=tmp_path / f"{name}_on", device="cpu",
            chunk_size=2))
        off = SweepStore(tmp_path / f"{name}_off")
        on = SweepStore(tmp_path / f"{name}_on")
        n_items = len(spec.expand())
        assert off.keys() == on.keys() and len(off) == n_items
        for key in off.keys():
            assert np.float64(off.value(key)).tobytes() == \
                np.float64(on.value(key)).tobytes()
            ma, mb = off.metrics(key), on.metrics(key)
            assert ma.keys() == mb.keys()
            for m in ma:
                assert np.float64(ma[m]).tobytes() == \
                    np.float64(mb[m]).tobytes()
        assert [c["keys"] for c in off.chunks()] == \
            [c["keys"] for c in on.chunks()]
        for c, d in zip(off.chunks(), on.chunks()):
            va, vb = off.chunk_data(c["shard"]), on.chunk_data(d["shard"])
            assert va["values"].tobytes() == vb["values"].tobytes()
        frames = list(TS.read_stream(str(path)))
        chunks = [f["payload"] for f in frames if f["type"] == "chunk"]
        assert len(chunks) == len(off.chunks())
        assert sum(c["items"] for c in chunks) == n_items
        if name == "serving":
            assert {"tick", "horizon"} <= {f["type"] for f in frames}


def test_note_chunk_publishes_the_reference_frame(tmp_path):
    payloads = {}
    for name, stream, shard in (("port", TS, TSH), ("ref", RS, RSH)):
        path = tmp_path / f"{name}.jsonl"
        obs = PKG[name][0]
        obs.enable_stream(str(path), source="chunks")
        try:
            shard._note_chunk("accel", 6, 0.125)
            shard._note_chunk("host", 2, 0.0)
        finally:
            obs.disable_stream()
        payloads[name] = [f["payload"] for f in stream.read_stream(str(path))
                          if f["type"] == "chunk"]
    assert payloads["port"] == payloads["ref"] == [
        {"executor": "accel", "items": 6, "wall_s": 0.125,
         "items_per_s": 48.0},
        {"executor": "host", "items": 2, "wall_s": 0.0,
         "items_per_s": None}]


def test_sweep_cli_stream_flag_and_env(tmp_path, monkeypatch):
    from repro_torch.sweeps.cli import main

    argv = ["--scenario", "steady", "--seeds", "0:2", "--ticks", "1",
            "--override", "n_user_slots=24", "--algos", "egp",
            "--device", "cpu", "--no-store", "-q", "--chunk-size", "1"]
    flag = tmp_path / "flag.jsonl"
    try:
        assert main(argv + ["--stream", str(flag)]) == 0
        assert tobs.stream_active()
    finally:
        tobs.disable_stream()
    monkeypatch.setenv("REPRO_OBS_STREAM", str(tmp_path / "env.jsonl"))
    try:
        assert main(argv) == 0
    finally:
        tobs.disable_stream()
    for path in (flag, tmp_path / "env.jsonl"):
        frames = list(RS.read_stream(str(path)))
        assert frames[0]["payload"]["source"] == "sweeps"
        assert [f["payload"]["items"] for f in frames
                if f["type"] == "chunk"] == [1, 1]
        assert frames[-1]["type"] == "bye"


def test_enable_stream_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS_STREAM", raising=False)
    assert tobs.enable_stream_from_env() is None
    monkeypatch.setenv("REPRO_OBS_STREAM", "off")
    assert tobs.enable_stream_from_env() is None
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv("REPRO_OBS_STREAM", "1")
    pub = tobs.enable_stream_from_env(default_path=str(path), source="env")
    assert pub is not None and tobs.stream_active()
    assert tobs.publish("tick", tick=0)
    tobs.disable_stream()
    assert not tobs.stream_active() and not tobs.publish("tick", tick=1)
    assert [f["type"] for f in RS.read_stream(str(path))] == \
        ["hello", "tick", "bye"]


# ===========================================================================
# readers, validators and sinks
# ===========================================================================

def test_read_stream_survives_truncation(tmp_path):
    path = tmp_path / "s.jsonl"
    pub = TS.StreamPublisher(TS.FileSink(path), source="gen1")
    for i in range(20):
        pub.emit("tick", {"tick": i})
    gen = TS.read_stream(str(path), follow=True, timeout_s=5.0, poll_s=0.01)
    got = [next(gen) for _ in range(21)]
    assert [f["type"] for f in got] == ["hello"] + ["tick"] * 20
    # the writer truncates and starts a fresh, shorter stream in place
    path.write_text("")
    pub2 = RS.StreamPublisher(RS.FileSink(path), source="gen2")
    pub2.emit("tick", {"tick": 100})
    pub2.emit("bye", {})
    rest = list(gen)
    assert [f["type"] for f in rest] == ["hello", "tick", "bye"]
    assert rest[0]["payload"]["source"] == "gen2"
    assert rest[1]["payload"]["tick"] == 100
    pub.close()
    pub2.close()


def test_partial_tail_is_buffered_not_parsed(tmp_path):
    path = tmp_path / "s.jsonl"
    pub = TS.StreamPublisher(TS.FileSink(path), source="rt")
    pub.emit("tick", {"tick": 0})
    with open(path, "a") as f:
        f.write('{"stream_schema": 1, "seq": 2, "t": 1.0, "type": "ti')
    for stream in (TS, RS):
        assert [f["type"] for f in stream.read_stream(str(path))] == \
            ["hello", "tick"]
    pub._sink.close()


def test_frame_validator_rejects_alike_and_resets():
    hello = {"seq": 0, "type": "hello", "payload": {"stream_schema": 1}}
    cases = [
        [{"seq": 0, "type": "tick", "payload": {}}],
        [{"seq": 0, "type": "hello", "payload": {"stream_schema": 99}}],
        [hello, {"seq": 1, "type": "tick"}, {"seq": 1, "type": "tick"}],
        [hello, {"seq": 5, "type": "tick"}],
        [hello, {"seq": "1", "type": "tick"}],
    ]
    for frames in cases:
        errors = []
        for stream in (TS, RS):
            v = stream.FrameValidator(contiguous=True)
            with pytest.raises(stream.StreamError) as e:
                for f in frames:
                    v.feed(dict(f))
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    for bad in ("not json", "[1, 2]", '{"seq": 3, "type": "tick", x}'):
        with pytest.raises(TS.StreamError) as te:
            TS.FrameValidator().feed_line(bad)
        with pytest.raises(RS.StreamError) as re_:
            RS.FrameValidator().feed_line(bad)
        assert str(te.value) == str(re_.value)
    gaps = TS.FrameValidator(contiguous=False)
    gaps.feed(dict(hello))
    assert gaps.feed({"seq": 5, "type": "tick"})["seq"] == 5
    v = TS.FrameValidator()
    v.feed(dict(hello))
    v.feed({"seq": 1, "type": "tick", "payload": {}})
    v.reset()
    assert v.last_seq is None and v.hello is None
    v.feed(dict(hello))     # a replayed seq 0 is valid again after reset
    v.feed({"seq": 1, "type": "tick", "payload": {}})


def test_publisher_survives_sink_failure(tmp_path):
    pub = TS.StreamPublisher(TS.FileSink(tmp_path / "s.jsonl"),
                             source="fail")
    pub._sink._f.close()    # the disk goes away mid-run
    assert pub.emit("tick", {"tick": 0}) is False
    assert pub.failed and pub.emit("tick", {"tick": 1}) is False


@pytest.mark.parametrize("kind", ["unix", "tcp"])
def test_socket_sink_replays_hello_and_close_joins_its_thread(tmp_path,
                                                              kind):
    if kind == "unix":
        sink = TS.SocketSink("unix", str(tmp_path / "s.sock"))
    else:
        sink = TS.SocketSink("tcp", ("127.0.0.1", 0))
    pub = TS.StreamPublisher(sink, source="sock")
    spec = sink.describe()
    frames = []

    def reader():
        frames.extend(RS.read_stream(spec, timeout_s=5.0))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    deadline = time.monotonic() + 5.0
    while not sink._clients and time.monotonic() < deadline:
        time.sleep(0.01)    # the late joiner is registered
    assert sink._clients, "reader never connected"
    pub.emit("tick", {"tick": 7})
    pub.close()
    th.join(timeout=5.0)
    assert not th.is_alive()
    assert not sink._thread.is_alive()
    types = [f["type"] for f in frames]
    assert types[0] == "hello" and "tick" in types and types[-1] == "bye"
    if kind == "unix":
        assert not Path(sink.address).exists()
    else:
        assert spec.startswith("tcp:127.0.0.1:") and sink.address[1] > 0


def test_stream_frames_hold_json_types_only(tmp_path):
    """Every payload the tick writes is plain JSON: the file re-encodes
    to itself line for line."""
    path = tmp_path / "s.jsonl"
    _streamed("port", path, lambda: _replay(TG, _cfg(TH, n_ticks=2)))
    for line in path.read_text().splitlines():
        assert json.dumps(json.loads(line), separators=(",", ":"),
                          sort_keys=True) == line
