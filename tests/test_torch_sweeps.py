"""The port's sweep engine against the JAX package's: spec keys,
fingerprints and store keys string for string, each package's store read
(and resumed) by the other, the store's crash guarantees, host values
byte-identical and accelerator values within the host-parity tolerance,
bit-identity under chunking, bucketing, resume and a per-device split,
the aggregate tables byte for byte, and the CLI."""
import json

import numpy as np
import pytest

import repro.sweeps as RSW
import repro.sweeps.store as RSTORE
import repro_torch.sweeps as TSW
import repro_torch.sweeps.store as TSTORE
from repro.sweeps.cli import _parse_override
from repro_torch.workloads import evaluate_host

#: The reference's float32-batched vs float64-host tolerance
#: (repro/sweeps/shard.py HOST_PARITY_ATOL).
ATOL = 1e-4
SMALL = (("max_impls", 3), ("n_services", 8), ("n_user_slots", 40))
SYNTH = {"n_users": 30, "n_edges": 4, "n_services": 12, "max_impls": 3}

SPECS = {
    "two_scenarios": dict(scenarios=("steady", "flash_crowd"), seeds=(3, 1),
                          n_ticks=2, algos=("egp", "sck")),
    "synthetic": dict(scenarios=("synthetic",), seeds=(0, 1),
                      algos=("egp", "opt", "rnd"),
                      override_grid=(SYNTH,)),
    "cli_overrides": dict(
        scenarios=("steady",), seeds=(0,), force_host=("egp",),
        max_iters=64, algos=("egp", "agp"),
        override_grid=(tuple(_parse_override(s) for s in
                             ("n_user_slots=32", "mobility_p_move=0.5",
                              "description=from the CLI")),
                       {"n_user_slots": np.int64(48),
                        "mobility_p_move": np.float32(0.25)})),
    "default_ticks": dict(scenarios=("edge_failure", "trace_replay_azure"),
                          seeds=range(2), algos=("agp", "agp_literal"),
                          override_grid=({}, {"n_user_slots": 48})),
}


@pytest.fixture(scope="module")
def host_parity_runs(tmp_path_factory):
    """One spec with every host algorithm and both accel algorithms, run
    by each package (the port on the CPU), each into its own store."""
    algos = ("egp", "agp", "sck", "opt", "rnd", "agp_literal")
    specs = {"scen": dict(scenarios=("mobility_churn",), seeds=(4, 5),
                          n_ticks=2, algos=algos, override_grid=(SMALL,)),
             "synth": dict(scenarios=("synthetic",), seeds=(4, 5),
                           algos=algos, override_grid=(SYNTH,))}
    base = tmp_path_factory.mktemp("stores")
    out = {}
    for tag, kw in specs.items():
        rspec, tspec = RSW.SweepSpec(**kw), TSW.SweepSpec(**kw)
        out[tag] = dict(
            rspec=rspec, tspec=tspec,
            ref=RSW.run_sweep(rspec, store_dir=base / f"ref_{tag}"),
            port=TSW.run_sweep(tspec, store_dir=base / f"port_{tag}",
                               device="cpu"),
            ref_dir=base / f"ref_{tag}", port_dir=base / f"port_{tag}")
    return out


# ===========================================================================
# spec: keys, fingerprints, store keys, envelopes, JSON
# ===========================================================================

@pytest.mark.parametrize("name", list(SPECS))
def test_spec_strings_equal_the_reference(name):
    kw = SPECS[name]
    rspec, tspec = RSW.SweepSpec(**kw), TSW.SweepSpec(**kw)
    assert tspec.override_grid == rspec.override_grid
    ri, ti = rspec.expand(), tspec.expand()
    assert [i.key() for i in ti] == [i.key() for i in ri]
    assert [(i.scenario, i.overrides, i.algo, i.executor, i.seed, i.tick,
             i.max_iters, i.variant) for i in ti] == \
        [(i.scenario, i.overrides, i.algo, i.executor, i.seed, i.tick,
          i.max_iters, i.variant) for i in ri]
    assert [g for g, _ in tspec.groups()] == [g for g, _ in rspec.groups()]
    assert tspec.fingerprint() == rspec.fingerprint()
    assert tspec.store_key() == rspec.store_key()
    assert tspec.to_json() == rspec.to_json()
    for doc in (rspec.to_json(), json.loads(json.dumps(tspec.to_json()))):
        back = TSW.SweepSpec.from_json(doc)
        assert back == tspec
        assert [i.key() for i in back.expand()] == [i.key() for i in ri]
    for scenario, overrides in {(i.scenario, i.overrides) for i in ri}:
        if ("description", "from the CLI") in overrides:
            continue
        assert TSW.envelope_for(scenario, overrides) == \
            RSW.envelope_for(scenario, overrides)
    assert TSW.variant_key("steady", (("a", 1), ("b", 0.5))) == \
        RSW.variant_key("steady", (("a", 1), ("b", 0.5)))


def test_spec_guards():
    for mod in (RSW, TSW):
        with pytest.raises(ValueError):
            mod.SweepSpec(algos=("newton",))
        with pytest.raises(ValueError):
            mod.materialize("synthetic", (("n_quarks", 3),), [(0, 0)])
        doc = mod.SweepSpec().to_json()
        doc["schema_version"] -= 1
        with pytest.raises(ValueError, match="schema"):
            TSW.SweepSpec.from_json(doc)
    from repro.sweeps.spec import SCHEMA_VERSION as R_SCHEMA
    from repro_torch.sweeps.spec import SCHEMA_VERSION as T_SCHEMA
    assert T_SCHEMA == R_SCHEMA
    assert (TSW.ACCEL_ALGOS, TSW.HOST_ALGOS, TSW.KINDS, TSW.SYNTHETIC) == \
        (RSW.ACCEL_ALGOS, RSW.HOST_ALGOS, RSW.KINDS, RSW.SYNTHETIC)


def test_serving_kind_raises_and_never_runs_as_sigma():
    with pytest.raises(NotImplementedError, match="item"):
        TSW.SweepSpec(scenarios=("flash_crowd",), algos=("edf",),
                      kind="serving")
    doc = TSW.SweepSpec(scenarios=("flash_crowd",)).to_json()
    doc.update(kind="serving", algos=["edf"])
    with pytest.raises(NotImplementedError):
        TSW.SweepSpec.from_json(doc)


@pytest.mark.parametrize("scenario,overrides", [
    ("synthetic", tuple(sorted(SYNTH.items()))),
    ("mobility_churn", SMALL),
    ("edge_failure", SMALL),
])
def test_materialize_byte_identical(scenario, overrides):
    pairs = [(0, 0), (2, 5), (0, 3), (1, 6)]
    for a, b in zip(TSW.materialize(scenario, overrides, pairs),
                    RSW.materialize(scenario, overrides, pairs)):
        for f in ("K", "W", "R", "sm_service", "sm_acc", "sm_k", "sm_w",
                  "sm_r", "u_edge", "u_service", "u_alpha", "u_delta"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_chunk_sizing_equal():
    for env in ((96, 96, 8), (1000, 1000, 11), (10000, 1000, 11)):
        assert TSW.bytes_per_item(env) == RSW.bytes_per_item(env)
        for n_dev, mb, n in ((1, 512, None), (4, 64, None), (4, 64, 3),
                             (1, 1e-6, None)):
            assert TSW.auto_chunk_size(env, n_dev, mb, n) == \
                RSW.auto_chunk_size(env, n_dev, mb, n)
    # a 10^4-user synthetic item is ~600 MB: one-item chunks at 512 MB
    assert TSW.bytes_per_item((10000, 1000, 11)) > 512 * 2**20


# ===========================================================================
# store: the reference's durability tests, on the port
# ===========================================================================

def test_store_roundtrip_and_crash_tolerance(tmp_path):
    store = TSW.SweepStore(tmp_path)
    store.add_chunk(["k1", "k2"], np.array([1.5, 2.5]),
                    np.array([0.1, 0.2]), {"algo": "egp"})
    store.add_chunk(["k3"], np.array([3.5]), np.array([0.3]))
    again = TSW.SweepStore(tmp_path)
    assert "k1" in again and again.value("k2") == 2.5
    assert again.time("k3") == 0.3 and again.meta("k1") == {"algo": "egp"}
    with open(tmp_path / "manifest.jsonl", "a") as f:
        f.write('{"shard": "zzz.npz", "keys": ["k4"')
    assert "k4" not in TSW.SweepStore(tmp_path)
    (shard, _) = again._index["k3"]
    (tmp_path / "shards" / shard).unlink()
    survivor = TSW.SweepStore(tmp_path)
    assert "k3" not in survivor and "k1" in survivor


def test_store_append_after_torn_line_does_not_glue(tmp_path):
    store = TSW.SweepStore(tmp_path)
    store.add_chunk(["k1"], np.array([1.0]), np.array([0.1]))
    with open(tmp_path / "manifest.jsonl", "ab") as f:
        f.write(b'{"shard": "zzz.npz", "keys": ["kX"')
    resumed = TSW.SweepStore(tmp_path)
    assert "k1" in resumed and "kX" not in resumed
    resumed.add_chunk(["k2"], np.array([2.0]), np.array([0.2]))
    final = TSW.SweepStore(tmp_path)
    assert "k1" in final and "k2" in final and final.value("k2") == 2.0


def test_store_concurrent_handles_never_clobber(tmp_path):
    a = TSW.SweepStore(tmp_path)
    b = TSW.SweepStore(tmp_path)          # opened before a writes
    a.add_chunk(["k1"], np.array([1.0]), np.array([0.1]))
    assert "k1" not in b
    b.add_chunk(["k2"], np.array([2.0]), np.array([0.2]))
    assert "k1" in b and b.value("k1") == 1.0
    fresh = TSW.SweepStore(tmp_path)
    assert fresh.value("k1") == 1.0 and fresh.value("k2") == 2.0
    assert len((tmp_path / "manifest.jsonl").read_text().splitlines()) == 2


def test_store_crash_between_shard_and_manifest(tmp_path, monkeypatch):
    """The shard lands before its manifest line: a writer killed between
    the two leaves an orphan shard that readers ignore and the next append
    steps over."""
    store = TSW.SweepStore(tmp_path)
    store.add_chunk(["k1"], np.array([1.0]), np.array([0.1]))
    real, calls = TSTORE.atomic_write, []

    def dies_on_manifest(path, payload):
        calls.append(path)
        if path.name == "manifest.jsonl":
            raise KeyboardInterrupt("killed")
        real(path, payload)

    monkeypatch.setattr(TSTORE, "atomic_write", dies_on_manifest)
    with pytest.raises(KeyboardInterrupt):
        store.add_chunk(["k2"], np.array([2.0]), np.array([0.2]))
    monkeypatch.setattr(TSTORE, "atomic_write", real)
    assert [p.parent.name for p in calls] == ["shards", tmp_path.name]
    assert len(list((tmp_path / "shards").glob("*.npz"))) == 2
    for mod in (TSW, RSW):
        after = mod.SweepStore(tmp_path)
        assert "k1" in after and "k2" not in after
    again = TSW.SweepStore(tmp_path)
    again.add_chunk(["k2"], np.array([2.5]), np.array([0.2]))
    final = TSW.SweepStore(tmp_path)
    assert final.value("k2") == 2.5 and final.value("k1") == 1.0
    assert len(list((tmp_path / "shards").glob("*.npz"))) == 3


def test_store_metrics_roundtrip_and_chunk_hooks(tmp_path):
    store = TSW.SweepStore(tmp_path)
    store.add_chunk(["k1", "k2"], np.array([1.0, 2.0]),
                    np.array([0.1, 0.2]), {"algo": "edf"},
                    metrics={"served": [5.0, 6.0],
                             "latency": [0.25, float("nan")]})
    store.add_chunk(["k3"], np.array([3.0]), np.array([0.3]))
    for mod in (TSW, RSW):
        again = mod.SweepStore(tmp_path)
        assert again.metrics("k1") == {"served": 5.0, "latency": 0.25}
        assert np.isnan(again.metrics("k2")["latency"])
        assert again.metrics("k3") == {}
        recs = again.chunks()
        assert [r["keys"] for r in recs] == [["k1", "k2"], ["k3"]]
        assert recs[0]["metrics"] == ["latency", "served"]
        np.testing.assert_array_equal(
            again.chunk_data(recs[0]["shard"])["metric_served"], [5.0, 6.0])
    with pytest.raises(AssertionError):
        store.add_chunk(["k4"], np.array([1.0]), np.array([0.1]),
                        metrics={"served": [1.0, 2.0]})


# ===========================================================================
# cross-package stores and engine parity
# ===========================================================================

@pytest.mark.parametrize("tag", ["scen", "synth"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_store_reads_and_resumes_the_other(host_parity_runs, tag,
                                                writer):
    run = host_parity_runs[tag]
    d = run[f"{writer}_dir"]
    a, b = RSTORE.SweepStore(d), TSTORE.SweepStore(d)
    assert b.keys() == a.keys() and len(a) > 0
    assert b.chunks() == a.chunks()
    for k in a.keys():
        assert np.float64(b.value(k)).tobytes() == \
            np.float64(a.value(k)).tobytes()
        assert b.time(k) == a.time(k) and b.meta(k) == a.meta(k)
    # the other package's engine resumes the store without computing
    other = RSW if writer == "port" else TSW
    kw = {} if writer == "port" else dict(device="cpu")
    spec = run["rspec"] if writer == "port" else run["tspec"]
    again = other.run_sweep(spec, store_dir=d, **kw)
    assert again.execution["chunks_computed"] == 0
    assert again.execution["items_skipped"] == len(spec.expand())
    for key, vals in run[writer].values.items():
        np.testing.assert_array_equal(again.values[key], vals)


@pytest.mark.parametrize("tag", ["scen", "synth"])
def test_engine_values_against_reference_and_host(host_parity_runs, tag):
    run = host_parity_runs[tag]
    ref, port, spec = run["ref"], run["port"], run["tspec"]
    assert port.complete and port.values.keys() == ref.values.keys()
    assert port.execution["backend"] == "cpu"
    assert port.execution["path"] == "batched"
    assert port.execution["paths"] == ["batched", "host"]
    for (scenario, overrides, algo), items in spec.groups():
        vk = TSW.variant_key(scenario, overrides)
        got, want = port.values[(vk, algo)], ref.values[(vk, algo)]
        if spec.executor_of(algo) == "host":
            assert got.tobytes() == want.tobytes(), algo
            continue
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        insts = TSW.materialize(scenario, overrides,
                                [(it.seed, it.tick) for it in items])
        host = evaluate_host(insts, algo=algo).reshape(got.shape)
        np.testing.assert_allclose(got, host, atol=ATOL, rtol=0)


SPLIT = TSW.SweepSpec(scenarios=("steady", "flash_crowd"), seeds=(0, 1),
                      n_ticks=3, algos=("egp", "agp"),
                      override_grid=(SMALL, (("n_user_slots", 24),)))


def _values(result):
    return {k: v.tobytes() for k, v in result.values.items()}


def test_bit_identical_under_chunking_bucketing_devices_and_resume(tmp_path):
    one = TSW.run_sweep(SPLIT, device="cpu")
    want = _values(one)
    for kw in (dict(chunk_size=1), dict(chunk_size=5), dict(bucketed=False),
               dict(devices=["cpu", "cpu"]),
               dict(devices=["cpu", "cpu", "cpu"], chunk_size=4,
                    bucketed=False)):
        res = TSW.run_sweep(SPLIT, device="cpu", **kw)
        assert _values(res) == want, kw
        if "devices" in kw:
            assert res.execution["path"] == "per_device"
            assert res.execution["n_devices"] == len(kw["devices"])
    d = tmp_path / "store"
    part = TSW.run_sweep(SPLIT, store_dir=d, device="cpu", chunk_size=4,
                         max_chunks=3)
    assert not part.complete and part.execution["chunks_computed"] == 3
    done = TSW.run_sweep(SPLIT, store_dir=d, devices=["cpu", "cpu"],
                         chunk_size=5)
    assert done.complete and done.execution["items_skipped"] == 10
    assert _values(done) == want
    reload_ = TSW.run_sweep(SPLIT, store_dir=d, device="cpu")
    assert reload_.execution["chunks_computed"] == 0
    assert reload_.execution["items_skipped"] == len(SPLIT.expand())
    assert _values(reload_) == want


def test_host_only_sweep_needs_no_device():
    spec = TSW.SweepSpec(scenarios=("steady",), seeds=(0,), n_ticks=1,
                         algos=("sck",), override_grid=(SMALL,))
    res = TSW.run_sweep(spec, device="no-such-device")
    assert res.execution["backend"] == "host" and res.complete


# ===========================================================================
# aggregate tables
# ===========================================================================

def _twin(port_result, values=None):
    """The reference's SweepResult over the same spec and values."""
    values = port_result.values if values is None else values
    rspec = RSW.SweepSpec.from_json(port_result.spec.to_json())
    return RSW.SweepResult(spec=rspec, values=values,
                           times=port_result.times,
                           execution=port_result.execution)


def test_aggregate_tables_byte_identical(host_parity_runs):
    port = host_parity_runs["synth"]["port"]
    partial = {k: v.copy() for k, v in port.values.items()}
    next(iter(partial.values()))[0, 0] = np.nan
    for values in (port.values, partial):
        tres = TSW.SweepResult(spec=port.spec, values=values,
                               times=port.times, execution=port.execution)
        rres = _twin(port, values)
        for ref in ("auto", "sck"):
            assert TSW.table(tres, ref) == RSW.table(rres, ref)
            assert TSW.fig3_table(tres, ref) == RSW.fig3_table(rres, ref)
            assert TSW.summarize(tres, ref) == RSW.summarize(rres, ref)
            rf, tf = RSW.ratio_frame(rres, ref), TSW.ratio_frame(tres, ref)
            assert tf.keys() == rf.keys()
            for k in rf:
                assert tf[k].tobytes() == rf[k].tobytes()
        assert TSW.fig4_table([("U=30", tres), ("again", tres)]) == \
            RSW.fig4_table([("U=30", rres), ("again", rres)])
        assert json.dumps(tres.rows()) == json.dumps(rres.rows())
    with pytest.raises(ValueError):
        TSW.ratio_frame(tres, ref="agp_missing")
    rows = {"steady": [dict(switching_cost=0.0, stickiness=1.0, policy="edf",
                            mean_qos=0.8, miss_rate=0.1, mean_accuracy=0.7,
                            mean_latency_s=float("nan"), qos_frontier=True,
                            acc_lat_frontier=False),
                       dict(switching_cost=2.0, stickiness=3.0, policy="fcfs",
                            mean_qos=0.6, miss_rate=0.2, mean_accuracy=0.75,
                            mean_latency_s=0.03, qos_frontier=False,
                            acc_lat_frontier=True)]}
    assert TSW.frontier_table(rows) == RSW.frontier_table(rows)
    for a in (np.array([1.0, 2.5, np.nan, 4.0]), np.array([]),
              np.array([3.0])):
        assert json.dumps(TSW.basic_stats(a)) == \
            json.dumps(RSW.aggregate.basic_stats(a))


# ===========================================================================
# the CLI
# ===========================================================================

def test_cli_end_to_end_on_the_cpu(tmp_path, capsys):
    from repro_torch.sweeps.cli import main, parse_seeds

    assert parse_seeds("0:4") == (0, 1, 2, 3)
    assert parse_seeds("2,5, 9") == (2, 5, 9)
    args = ["--scenario", "steady", "--seeds", "0:2", "--ticks", "1",
            "--algos", "egp,sck", "--override", "n_user_slots=32",
            "--device", "cpu", "--out", str(tmp_path / "store"), "-q"]
    rc = main(args + ["--validate", "--json", str(tmp_path / "s.json"),
                      "--obs", str(tmp_path / "obs.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "steady[n_user_slots=32]" in out and "validated" in out
    summary = json.loads((tmp_path / "s.json").read_text())
    assert summary["cells"]["steady[n_user_slots=32]/egp"]["sigma"]["n"] == 2
    assert summary["validate_max_abs_diff"] <= ATOL
    assert summary["execution"]["backend"] == "cpu"
    from repro.obs import load_artifact
    doc = load_artifact(tmp_path / "obs.json")
    names = {doc["names"][i] for i in doc["spans"]["name"]}
    assert {"sweep.materialize", "sweep.chunk", "store.add_chunk"} <= names
    # resume through the CLI is a no-op: the same table, nothing added
    lines = (tmp_path / "store" / "manifest.jsonl").read_text()
    assert main(args) == 0
    assert capsys.readouterr().out.splitlines() == \
        [s for s in out.splitlines() if not s.startswith("validated")]
    assert (tmp_path / "store" / "manifest.jsonl").read_text() == lines
    # --max-chunks 0 computes nothing: validation fails, not vacuously
    assert main(["--scenario", "steady", "--seeds", "0:2", "--ticks", "1",
                 "--device", "cpu", "--no-store", "--max-chunks", "0",
                 "--validate", "-q"]) == 1
    with pytest.raises(SystemExit) as exc:
        main(["--scenario", "flash_crowd", "--kind", "serving", "-q",
              "--no-store"])
    assert exc.value.code == 2
    capsys.readouterr()
