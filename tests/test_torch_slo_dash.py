"""The port's SLOs, dashboard, trace stitching and obs CLI against the JAX
package's: evaluate_slos, load_slos and compare_bench give the same
reports; the dashboard renders the same screen from the same frames;
stitch_traces, the rollups and stitch_fleet agree on the same artifacts
(a fleet root laid out as the reference's fleet writes it); and every
``obs`` CLI subcommand prints the same stdout with the same exit code as
``repro.obs.cli.main`` on the same files."""
import asyncio
import io
import json
import os
import time
from pathlib import Path

import pytest

import repro.gateway as RG
import repro.obs.aggregate as RA
import repro.obs.cli as RCLI
import repro.obs.dash as RD
import repro.obs.slo as RSLO
import repro.serving.horizon as RH
import repro_torch.gateway as TG
import repro_torch.obs.aggregate as TA
import repro_torch.obs.cli as TCLI
import repro_torch.obs.dash as TD
import repro_torch.obs.slo as TSLO
import repro_torch.serving.horizon as TH
from repro import obs as robs
from repro_torch import obs as tobs
from torch_recorders import recorders_off  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
LOAD = dict(prompt_tokens=768, new_tokens=64, max_batch=4)
#: The frames of the reference's gateway SLO test (tests/test_gateway.py).
GATEWAY_FRAMES = [
    {"type": "gateway", "t": 10.0,
     "payload": {"tick": 0, "ingress_depth": 12, "loop_lag_ms": 1.0}},
    {"type": "gateway", "t": 11.0,
     "payload": {"tick": 1, "ingress_depth": 40, "loop_lag_ms": 2.0}},
    {"type": "metrics", "t": 11.5, "payload": {"metrics": [
        {"kind": "histogram", "name": "gateway.loop_lag_ms",
         "labels": {}, "growth": 2.0, "min_value": 1e-9,
         "buckets": {"30": 3}, "count": 3, "sum": 4.0,
         "min": 1.0, "max": 2.0},
        {"kind": "histogram", "name": "gateway.admission_ms",
         "labels": {}, "growth": 2.0, "min_value": 1e-9,
         "buckets": {"34": 5}, "count": 5, "sum": 60.0,
         "min": 10.0, "max": 14.0}], "counters": {}}},
]


def _cfg(horizon, **kw):
    base = dict(scenario="flash_crowd", overrides=tuple(SMALL.items()),
                policy="feedback", seed=1, n_ticks=4, **LOAD)
    base.update(kw)
    return horizon.HorizonConfig(**base)


def _replay_stream(path):
    """A port gateway replay with the port's stream, request tracer and
    ledger on; the stream at ``path``, the reqtrace and ledger beside."""
    hconfig = _cfg(TH)
    gw = TG.Gateway(TG.GatewayConfig(horizon=hconfig, mode="virtual",
                                     metrics_every=2))

    async def _run():
        async def send(line):
            gw.submit_line(line)

        task = asyncio.ensure_future(gw.run())
        await TG.run_loadgen(send, hconfig, wall=False)
        return await task

    tobs.enable_stream(str(path), source="gateway")
    rt = tobs.enable_request_tracing(sample_every=2)
    led = tobs.enable_ledger()
    try:
        asyncio.run(_run())
    finally:
        tobs.disable_request_tracing()
        tobs.disable_ledger()
        tobs.disable_stream()
    rt.save(str(path.with_name("reqtrace.json")))
    led.save(str(path.with_name("ledger.jsonl")))
    return path


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    return _replay_stream(tmp_path_factory.mktemp("stream") / "s.jsonl")


def _reports(slo_mod, slos, **kw):
    return [(r.line(), r.n_samples, r.ok)
            for r in slo_mod.evaluate_slos(slos, **kw)]


# ===========================================================================
# SLOs
# ===========================================================================

def test_default_slos_are_the_references():
    assert [s.to_json() for s in TSLO.DEFAULT_SLOS] == \
        [s.to_json() for s in RSLO.DEFAULT_SLOS]
    assert TSLO.SLO_SCHEMA_VERSION == RSLO.SLO_SCHEMA_VERSION
    names = {s.name for s in TSLO.DEFAULT_SLOS}
    assert {"gateway-loop-lag-p99", "gateway-admission-p99",
            "gateway-ingress-depth"} <= names


def test_evaluate_slos_on_the_reference_gateway_frames():
    t = _reports(TSLO, TSLO.DEFAULT_SLOS, frames=GATEWAY_FRAMES)
    r = _reports(RSLO, RSLO.DEFAULT_SLOS, frames=GATEWAY_FRAMES)
    assert t == r
    by_name = {rep.slo.name: rep for rep in TSLO.evaluate_slos(
        TSLO.DEFAULT_SLOS, frames=GATEWAY_FRAMES)}
    assert by_name["gateway-ingress-depth"].value == 40.0
    assert by_name["gateway-loop-lag-p99"].n_samples == 3
    assert _reports(TSLO, TSLO.DEFAULT_SLOS, frames=[]) == \
        _reports(RSLO, RSLO.DEFAULT_SLOS, frames=[])


def test_evaluate_slos_on_a_replay_stream(stream_file):
    frames = list(tobs.read_stream(str(stream_file)))
    slos = list(TSLO.DEFAULT_SLOS) + [
        TSLO.SLO("tight-miss", "tick.miss_rate", max_value=0.0),
        TSLO.SLO("qos-floor", "tick.window_qos", min_value=0.99,
                 agg="min"),
        TSLO.SLO("depth-last", "gateway.queue_depth", max_value=1,
                 agg="last")]
    rslos = [RSLO.SLO(**s.to_json()) for s in slos]
    assert _reports(TSLO, slos, frames=frames) == \
        _reports(RSLO, rslos, frames=frames)
    bench = json.loads((ROOT / "BENCH_baseline.json").read_text())
    assert _reports(TSLO, slos, frames=frames, bench=bench) == \
        _reports(RSLO, rslos, frames=frames, bench=bench)


def test_load_slos_agrees(tmp_path):
    good = tmp_path / "slos.json"
    good.write_text(json.dumps({"slo_schema": 1, "slos": [
        {"name": "m", "metric": "tick.miss_rate", "max_value": 0.5},
        {"name": "q", "metric": "hist.serving.latency_s.p95",
         "max_value": 9.0, "window_s": 5.0, "agg": "max"}]}))
    assert [s.to_json() for s in TSLO.load_slos(good)] == \
        [s.to_json() for s in RSLO.load_slos(good)]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"slo_schema": 7, "slos": []}))
    for doc in (bad,):
        with pytest.raises(ValueError) as te:
            TSLO.load_slos(doc)
        with pytest.raises(ValueError) as re_:
            RSLO.load_slos(doc)
        assert str(te.value) == str(re_.value)
    for kw in ({"name": "x", "metric": "tick.q"},
               {"name": "x", "metric": "tick.q", "max_value": 1,
                "min_value": 0},
               {"name": "x", "metric": "tick.q", "max_value": 1,
                "agg": "p50"}):
        with pytest.raises(ValueError) as te:
            TSLO.SLO(**kw)
        with pytest.raises(ValueError) as re_:
            RSLO.SLO(**kw)
        assert str(te.value) == str(re_.value)


def test_compare_bench_agrees():
    base = json.loads((ROOT / "BENCH_baseline.json").read_text())
    new = json.loads(json.dumps(base))
    for i, row in enumerate(new["rows"]):
        row["us_per_call"] = float(row["us_per_call"]) * (1 + 2 * (i % 4))
        for k, v in list(row.get("fields", {}).items()):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                row["fields"][k] = v * (1.0 + 0.07 * (i % 3))
    names = [r["name"] for r in base["rows"]][:3] + ["no_such_row"]
    for kw in ({}, {"max_slowdown": 2.0, "rtol": 0.01, "atol": 0.0},
               {"rows": names}):
        assert TSLO.compare_bench(new, base, **kw) == \
            RSLO.compare_bench(new, base, **kw)
    assert TSLO.compare_bench(base, base)["violations"] == []


# ===========================================================================
# the dashboard
# ===========================================================================

def _extra_frames():
    """worker, chunk and reqtrace frames beside a replay's (the fleet's
    and the sweep engine's panes)."""
    return [
        {"type": "worker", "t": 5.0, "seq": 0, "payload": {
            "owner": "host-1", "tasks_done": 3, "items_done": 12,
            "items_per_s": 2.5, "queue_pending_items": 20}},
        {"type": "worker", "t": 6.0, "seq": 1, "payload": {
            "owner": "host-2", "tasks_done": 1, "items_done": 4,
            "items_per_s": 0.0, "queue_pending_items": None}},
        {"type": "chunk", "t": 7.0, "seq": 2, "payload": {
            "executor": "accel", "items": 4, "wall_s": 0.5,
            "items_per_s": 8.0}}]


def test_render_gives_the_same_screen(stream_file):
    frames = list(tobs.read_stream(str(stream_file))) + _extra_frames()
    screens = []
    for dash in (TD, RD):
        state = dash.DashState()
        for f in frames:
            state.update(f)
        screens.append(dash.render(state))
    assert screens[0] == screens[1]
    for pane in ("tick/s", "gateway", "requests (", "worker",
                 "sweep chunks: 1", "SLO"):
        assert pane in screens[0], pane
    empty = [dash.render(dash.DashState()) for dash in (TD, RD)]
    assert empty[0] == empty[1] and "(no tick frames yet)" in empty[0]


def test_run_dash_once_agrees(stream_file, tmp_path):
    outs = []
    for dash in (TD, RD):
        buf = io.StringIO()
        rc = dash.run_dash([str(stream_file)], once=True, out=buf,
                           clear=False)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == 0
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    torn = tmp_path / "torn.jsonl"
    torn.write_text('{"seq": 0, "type": "tick"}\n')
    for path, want in ((empty, 2), (torn, 1)):
        outs = []
        for dash in (TD, RD):
            buf = io.StringIO()
            outs.append((dash.run_dash([str(path)], once=True, out=buf,
                                       clear=False), buf.getvalue()))
        assert outs[0] == outs[1] and outs[0][0] == want


# ===========================================================================
# stitching and rollups
# ===========================================================================

def _clock(step_ns, start):
    state = {"t": start - step_ns}

    def clock():
        state["t"] += step_ns
        return state["t"]

    return clock


def _artifact(mod, pid, start, anchor=True):
    """A saved-artifact document from ``mod``'s Tracer on a fake clock."""
    tr = mod.Tracer(capacity=64, clock=_clock(1000, start))
    with tr.span("sweep.chunk", {"items": 2}):
        with tr.span("kernel.qos_matrix", {"U": 8, "P": 4}):
            tr.sample("serving.queue_depth", 3.0)
    tr.count("served", 2)
    h = tr.metrics.histogram("serving.latency_s", policy="edf")
    h.observe_many([0.01, 0.02 * pid])
    tr.metrics.counter("sweep.items", executor="accel").inc(pid)
    tr.metrics.gauge("placement.candidate_k").set(float(pid))
    doc = tr.snapshot()
    doc["pid"] = pid
    if anchor:
        doc["anchor"] = {"wall_ns": 5_000 * pid, "mono_ns": 0}
    else:
        doc.pop("anchor", None)
    return doc


def test_stitch_traces_and_rollups_agree():
    for anchors in ((True, True), (True, False), (False, False)):
        tdocs = [_artifact(tobs, p, 1000 * p, a)
                 for p, a in zip((3, 3), anchors)]
        rdocs = [_artifact(robs, p, 1000 * p, a)
                 for p, a in zip((3, 3), anchors)]
        assert TA.stitch_traces(tdocs, ["wa", "wb"]) == \
            RA.stitch_traces(rdocs, ["wa", "wb"])
        assert TA.stitch_traces(tdocs) == RA.stitch_traces(tdocs)
        assert TA.rollup_counters(tdocs) == RA.rollup_counters(rdocs)
        assert TA.rollup_metrics(tdocs).snapshot() == \
            RA.rollup_metrics(rdocs).snapshot()
    for bad in (([], None), ([_artifact(tobs, 1, 0)], ["a", "b"])):
        with pytest.raises(ValueError) as te:
            TA.stitch_traces(*bad)
        with pytest.raises(ValueError) as re_:
            RA.stitch_traces(*bad)
        assert str(te.value) == str(re_.value)


def _fleet_root(root: Path) -> Path:
    """A fleet root as the reference's fleet lays it out: the lease queue
    (one pending, one leased, one done task), worker telemetry and the
    workers' obs artifacts."""
    task = {"scenario": "steady", "overrides": [], "algo": "egp",
            "seeds": [0, 1], "n_ticks": 2}
    for state, name, keys in (("tasks", "000000_a", ["k0", "k1", "k2"]),
                              ("leases", "000001_b", ["k3"]),
                              ("done", "000002_c", ["k4", "k5"])):
        d = root / "queue" / state
        d.mkdir(parents=True, exist_ok=True)
        doc = dict(task, name=name, keys=keys)
        if state == "leases":
            doc["lease"] = {"owner": "w1", "claimed_at": time.time(),
                            "expires_at": time.time() + 3600}
        (d / f"{name}.json").write_text(json.dumps(doc))
    tele = root / "telemetry"
    tele.mkdir()
    now = time.time()
    for i, (owner, state) in enumerate((("w0", "running"),
                                        ("w1", "running"),
                                        ("w2", "drained"))):
        (tele / f"{owner}.json").write_text(json.dumps({
            "telemetry_schema": 1, "owner": owner, "state": state,
            "started_at": now - 60, "updated_at": now - i,
            "tasks_done": 2 + i, "items_done": 8 + i,
            "items_per_s": 1.5 + i, "last_task": "000002_c",
            "last_task_wall_s": 0.25 * (i + 1), "pid": 4000 + i,
            "anchor_mono_ns": 10_000 * (i + 1)}))
    (tele / "junk.json").write_text("{torn")
    art = root / "obs"
    art.mkdir()
    for i, pid in enumerate((4000, 4001, 4002)):
        doc = _artifact(tobs, pid, 1000 * (i + 1), anchor=(i != 1))
        (art / f"obs_{pid}.json").write_text(json.dumps(doc))
    (art / "obs_torn.json").write_text("{not json")
    return root


def test_stitch_fleet_agrees(tmp_path):
    root = _fleet_root(tmp_path / "fleet")
    out_t, out_r = tmp_path / "t.json", tmp_path / "r.json"
    t = TA.stitch_fleet(root, out=out_t)
    r = RA.stitch_fleet(root, out=out_r)
    assert t == r
    assert out_t.read_bytes() == out_r.read_bytes()
    assert t["n_artifacts"] == 3
    assert TA.telemetry_anchors(root) == RA.telemetry_anchors(root)
    assert TA.load_fleet_artifacts(root) == RA.load_fleet_artifacts(root)
    with pytest.raises(ValueError) as te:
        TA.stitch_fleet(tmp_path / "nowhere")
    with pytest.raises(ValueError) as re_:
        RA.stitch_fleet(tmp_path / "nowhere")
    assert str(te.value) == str(re_.value)


# ===========================================================================
# the CLI
# ===========================================================================

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory, stream_file):
    d = tmp_path_factory.mktemp("cli")
    tr = tobs.enable()
    try:
        TH.run_horizon(_cfg(TH, n_ticks=2, policy="edf"))
    finally:
        tobs.disable()
    tr.save(str(d / "trace.json"))
    spec = d / "slos.json"
    spec.write_text(json.dumps({"slo_schema": 1, "slos": [
        {"name": "tight", "metric": "tick.miss_rate", "max_value": 0.0},
        {"name": "lat", "metric": "hist.serving.latency_s.p99",
         "max_value": 1e9}]}))
    uids = json.loads(stream_file.with_name("reqtrace.json").read_text())
    return {"dir": d, "stream": stream_file,
            "reqtrace": stream_file.with_name("reqtrace.json"),
            "ledger": stream_file.with_name("ledger.jsonl"),
            "artifact": d / "trace.json", "spec": spec,
            "fleet": _fleet_root(d / "fleet"),
            "uid": uids["records"][-1]["uid"]}


def _argvs(f):
    out = f["dir"]
    return {
        "report": [["report", str(f["artifact"])]],
        "export": [["export", str(f["artifact"]), "--out",
                    str(out / "{pkg}_chrome.json")],
                   ["export", str(f["artifact"]), "--format", "jsonl",
                    "--out", str(out / "{pkg}_metrics.jsonl")]],
        "tail": [["tail", "--root", str(f["fleet"]), "--once"],
                 ["tail", "--root", str(out / "missing"), "--once"]],
        "dash": [["dash", "--stream", str(f["stream"]), "--once"],
                 ["dash", "--root", str(f["fleet"]), "--once"],
                 ["dash", "--stream", str(f["stream"]), "--once", "--spec",
                  str(f["spec"])]],
        "stitch": [["stitch", "--root", str(f["fleet"]), "--out",
                    str(out / "{pkg}_stitched.json"), "--json",
                    str(out / "{pkg}_summary.json")],
                   ["stitch", "--root", str(out / "missing")]],
        "explain": [["explain", "--uid", str(f["uid"]), "--trace",
                     str(f["reqtrace"])],
                    ["explain", "--uid", str(f["uid"]), "--trace",
                     str(f["stream"])],
                    ["explain", "--uid", "999999", "--trace",
                     str(f["reqtrace"])]],
        "why": [["why", "--ledger", str(f["ledger"])],
                ["why", "--tick", "1", "--edge", "0", "--ledger",
                 str(f["ledger"])],
                ["why", "--tick", "77", "--ledger", str(f["ledger"])]],
        "slo": [["slo", "--stream", str(f["stream"])],
                ["slo", "--stream", str(f["stream"]), "--spec",
                 str(f["spec"])],
                ["slo", "--artifact", str(f["artifact"]), "--bench",
                 str(ROOT / "BENCH_baseline.json")],
                ["slo", "--spec", str(out / "missing.json")]],
    }


@pytest.mark.parametrize("cmd", ["report", "export", "tail", "dash",
                                 "stitch", "explain", "why", "slo"])
def test_cli_subcommand_prints_the_references_output(cmd, cli_files,
                                                     capsys):
    for i, argv in enumerate(_argvs(cli_files)[cmd]):
        outs = {}
        for pkg, cli in (("port", TCLI), ("ref", RCLI)):
            args = [a.format(pkg=pkg) for a in argv]
            try:
                rc = cli.main(args)
            finally:
                for mod in (tobs, robs):
                    mod.disable()
                    mod.disable_stream()
            got = capsys.readouterr()
            outs[pkg] = (rc, got.out.replace(f"{pkg}_", "PKG_"),
                         got.err.replace(f"{pkg}_", "PKG_"))
        assert outs["port"] == outs["ref"], argv
        if i == 0:      # each subcommand's first case is a clean run
            assert outs["port"][0] == 0 and outs["port"][1], argv
        # the files it wrote are the reference's too (a Chrome export
        # names its exporter in its process-name record)
        for name in (a for a in argv if "{pkg}" in a):
            t, r = (Path(name.format(pkg=pkg)) for pkg in ("port", "ref"))
            if t.exists() or r.exists():
                assert t.read_text().replace("repro_torch.obs", "repro.obs") \
                    == r.read_text(), name


def test_python_dash_m_entry_point(cli_files):
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs", "slo",
                           "--stream", str(cli_files["stream"])], env=env,
                          capture_output=True, text=True, timeout=120)
    ref = subprocess.run([sys.executable, "-m", "repro.obs", "slo",
                          "--stream", str(cli_files["stream"])],
                         env=dict(env, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert (proc.returncode, proc.stdout) == (ref.returncode, ref.stdout)
    assert "gateway-ingress-depth" in proc.stdout


def test_gateway_frames_render_in_the_references_dash(stream_file):
    """The reference's dashboard reads the port gateway's stream as its
    own (and the other way round is the render test above)."""
    state = RD.DashState()
    for f in robs.read_stream(str(stream_file)):
        state.update(f)
    screen = RD.render(state)
    assert "flash_crowd/s1" in screen and "virtu" in screen
    assert RG.GATEWAY_PROTOCOL_VERSION == TG.GATEWAY_PROTOCOL_VERSION
    assert RH.HorizonConfig is not TH.HorizonConfig
