"""repro_torch.fleet against tests/test_fleet.py's cases and against the
reference: lease-queue mechanics (atomic claims, heartbeat, expiry requeue,
quarantine), worker drain, crash-safe merge with bit-for-bit duplicate
verification, 1-vs-4-worker subprocess parity with a SIGKILLed worker, the
SIGTERM drain, ``--wait``, and the ``python -m repro_torch.fleet`` /
``--fleet N`` CLIs; then the cross-package checks: the port's ``plan``
writes the reference's ``spec.json`` and task files byte for byte, each
package's ``status`` reads the other's root, a port fleet's merged
serving-kind store holds the reference's single-process value bytes, and a
sigma-kind fleet (EGP and AGP on the CPU) merges to the port's
single-process bytes. Every comparison is exact."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.fleet import (FleetMergeConflict, LeaseQueue, Task, merge,
                               plan, reap, run_worker, status, task_spec,
                               worker_store_dir)
from repro_torch.sweeps import SweepSpec, SweepStore, run_sweep
from torch_recorders import recorders_off  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"

#: Shrunk scenario (as tests/test_fleet.py) — keeps horizons fast.
SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
#: A small synthetic sigma-kind grid row.
SYNTH = (("max_impls", 3), ("n_edges", 4), ("n_services", 12),
         ("n_users", 30))


def _grid(knobs=((0.0, 0.0),)):
    return tuple(
        tuple(sorted({**SMALL, "switching_cost": sc,
                      "stickiness": st}.items()))
        for sc, st in knobs)


def _spec(scenarios=("steady",), seeds=(0, 1), algos=("edf",),
          n_ticks=2, knobs=((0.0, 0.0),), package=None):
    cls = SweepSpec if package is None else package.SweepSpec
    return cls(kind="serving", scenarios=scenarios, seeds=seeds,
               n_ticks=n_ticks, algos=algos, override_grid=_grid(knobs))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _worker_cmd(root, owner, ttl=60.0, device=None):
    cmd = [sys.executable, "-m", "repro_torch.fleet", "worker",
           "--root", str(root), "--owner", owner, "--ttl", str(ttl)]
    return cmd + (["--device", device] if device else [])


def _same_values(a, b):
    assert a.values.keys() == b.values.keys()
    for k in a.values:
        assert a.values[k].tobytes() == b.values[k].tobytes(), k


@pytest.fixture(scope="module")
def ref():
    """The reference's sweeps and fleet packages (JAX on the CPU)."""
    pytest.importorskip("jax")
    from repro import fleet, sweeps
    return {"fleet": fleet, "sweeps": sweeps}


# ===========================================================================
# Queue mechanics
# ===========================================================================

def _task(name="000000_abcd1234", seeds=(0,)):
    return Task(name=name, scenario="steady", overrides=(("a", 1),),
                algo="edf", seeds=tuple(seeds), n_ticks=2,
                keys=(f"k{name}",))


def test_queue_put_claim_complete_roundtrip(tmp_path):
    q = LeaseQueue(tmp_path / "q", owner="w0", ttl=60.0)
    assert q.put(_task()) and not q.put(_task())  # idempotent
    assert q.pending() == ["000000_abcd1234"]
    lease = q.claim()
    assert lease is not None and lease.owner == "w0"
    assert q.pending() == [] and q.leased() == ["000000_abcd1234"]
    doc = json.loads(lease.path.read_text())
    assert doc["lease"]["owner"] == "w0"
    assert Task.from_json(doc) == lease.task
    q2 = LeaseQueue(tmp_path / "q", owner="w1", ttl=60.0)
    assert q2.claim() is None
    assert lease.renew()
    assert lease.complete()
    assert q.done() == ["000000_abcd1234"] and q.leased() == []
    st = q.status()
    assert (st["pending"], st["leased"], st["done"]) == (0, 0, 1)


def test_queue_release_returns_task(tmp_path):
    q = LeaseQueue(tmp_path / "q", owner="w0", ttl=60.0)
    q.put(_task())
    lease = q.claim()
    assert lease.release()
    assert q.pending() == ["000000_abcd1234"] and q.leased() == []
    doc = json.loads((q.task_dir / "000000_abcd1234.json").read_text())
    assert "lease" not in doc


def test_lease_expiry_reap_and_reclaim(tmp_path):
    q = LeaseQueue(tmp_path / "q", owner="dead-worker", ttl=0.15)
    q.put(_task())
    lease = q.claim()
    assert lease is not None
    assert q.reap(now=lease.expires_at - 0.05) == []
    assert q.status(now=lease.expires_at + 0.05)["expired"] == 1
    assert q.reap(now=lease.expires_at + 0.05) == ["000000_abcd1234"]
    q2 = LeaseQueue(tmp_path / "q", owner="w1", ttl=60.0)
    lease2 = q2.claim()
    assert lease2 is not None and lease2.owner == "w1"
    # the dead worker's stale handle cannot renew, complete, or release
    assert not lease.renew() and lease.lost
    assert not lease.complete() and not lease.release()
    assert lease2.path.exists()
    doc = json.loads(lease2.path.read_text())
    assert doc["lease"]["owner"] == "w1"
    assert lease2.complete()


def test_unreadable_task_is_quarantined_not_parked(tmp_path):
    q = LeaseQueue(tmp_path / "q", owner="w0", ttl=60.0)
    (q.task_dir / "000000_aaaaaaaa.json").write_text("{corrupt")
    q.put(_task())
    lease = q.claim()
    assert lease is not None and lease.task.name == "000000_abcd1234"
    st = q.status()
    assert st["leased"] == 1 and st["poisoned"] == \
        ["000000_aaaaaaaa.json.poison"]
    assert q.reap() == []


def test_heartbeat_keeps_lease_alive(tmp_path):
    q = LeaseQueue(tmp_path / "q", owner="w0", ttl=0.5)
    q.put(_task())
    lease = q.claim()
    for _ in range(3):
        time.sleep(0.1)
        assert lease.renew()
    assert q.reap() == []
    assert lease.complete()


def test_telemetry_records_and_live_rate(tmp_path):
    from repro_torch.fleet.telemetry import (DEFAULT_STALE_S,
                                             WorkerTelemetry,
                                             read_telemetry)

    now = {"t": 1000.0}
    tele = WorkerTelemetry(tmp_path, "w0", clock=lambda: now["t"])
    tele.start()
    tele.task_done("t0", 4, 0.5)
    fresh = read_telemetry(tmp_path, now=now["t"])
    rec = fresh["workers"]["w0"]
    assert rec["live"] and rec["items_done"] == 4 and rec["tasks_done"] == 1
    assert fresh["rate_items_per_s"] == rec["items_per_s"] > 0
    stale = read_telemetry(tmp_path, now=now["t"] + DEFAULT_STALE_S + 1)
    assert stale["rate_items_per_s"] == 0.0
    tele.stop("drained")
    assert read_telemetry(tmp_path, now=now["t"])["workers"]["w0"][
        "state"] == "drained"
    assert DEFAULT_STALE_S == 30.0


# ===========================================================================
# Plan / worker / merge — in-process
# ===========================================================================

def test_plan_worker_merge_single_worker_byte_identical(tmp_path):
    spec = _spec(seeds=(0, 1, 2))
    ref = run_sweep(spec, store_dir=tmp_path / "ref")

    root = tmp_path / "fleet"
    pl = plan(spec, root, target_store=tmp_path / "merged")
    assert pl["n_tasks"] == 3 and pl["n_items"] == 6
    summary = run_worker(root, owner="w0")
    assert summary["stop"] == "drained" and summary["n_tasks"] == 3
    mg = merge(root, tmp_path / "merged")
    assert mg["merged_items"] == 6 and mg["missing_items"] == 0

    got = run_sweep(spec, store_dir=tmp_path / "merged")
    assert got.execution["chunks_computed"] == 0
    _same_values(ref, got)
    merged = SweepStore(tmp_path / "merged")
    refs = SweepStore(tmp_path / "ref")
    for key in refs.keys():
        assert merged.metrics(key) == refs.metrics(key)
        assert merged.meta(key)["fleet_worker"] == "w0"


def test_plan_skips_completed_seeds_and_rejects_foreign_spec(tmp_path):
    spec = _spec(seeds=(0, 1))
    run_sweep(spec, store_dir=tmp_path / "store")
    pl = plan(spec, tmp_path / "fleet", target_store=tmp_path / "store")
    assert pl["n_tasks"] == 0 and pl["skipped_items"] == 4
    with pytest.raises(ValueError, match="one fleet root"):
        plan(_spec(seeds=(0, 1, 2)), tmp_path / "fleet")


def test_replan_after_partial_completion_enqueues_nothing_new(tmp_path):
    spec = _spec(seeds=(0, 1, 2, 3))
    root, store = tmp_path / "fleet", tmp_path / "store"
    plan(spec, root, target_store=store)
    run_worker(root, owner="w0", max_tasks=2)
    merge(root, store)
    q = LeaseQueue(root / "queue")
    names_before = set(q.pending()) | set(q.done())
    pl = plan(spec, root, target_store=store)
    assert pl["n_tasks"] == 0
    assert pl["skipped_items"] == 4
    assert set(q.pending()) | set(q.done()) == names_before
    run_worker(root, owner="w1")
    assert len(q.done()) == 4
    mg = merge(root, store)
    assert mg["missing_items"] == 0 and mg["target_items"] == 8


def test_read_side_entry_points_reject_missing_queue(tmp_path):
    from repro_torch.fleet.cli import main

    with pytest.raises(ValueError, match="no fleet queue"):
        status(tmp_path / "typo")
    with pytest.raises(ValueError, match="no fleet queue"):
        reap(tmp_path / "typo")
    with pytest.raises(ValueError, match="nothing to merge"):
        merge(tmp_path / "typo", tmp_path / "store")
    assert main(["status", "--root", str(tmp_path / "typo")]) == 1
    assert not (tmp_path / "typo").exists()


def test_run_worker_restores_signal_handlers(tmp_path):
    import signal

    root = tmp_path / "fleet"
    plan(_spec(seeds=(0,)), root)
    before_term = signal.getsignal(signal.SIGTERM)
    before_int = signal.getsignal(signal.SIGINT)
    run_worker(root, owner="w0")
    assert signal.getsignal(signal.SIGTERM) is before_term
    assert signal.getsignal(signal.SIGINT) is before_int


def test_worker_detects_plan_schema_skew(tmp_path):
    root = tmp_path / "fleet"
    plan(_spec(seeds=(0,)), root)
    q = LeaseQueue(root / "queue")
    name = q.pending()[0]
    doc = json.loads((q.task_dir / f"{name}.json").read_text())
    doc["keys"] = ["not-a-real-item-hash"] * len(doc["keys"])
    (q.task_dir / f"{name}.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="skew"):
        run_worker(root, owner="w0")
    # the skewed task went back to the queue, not into a dead lease
    assert q.pending() == [name] and q.leased() == []


def test_merge_verifies_duplicates_bit_for_bit(tmp_path):
    root = tmp_path / "fleet"
    a = SweepStore(worker_store_dir(root, "a"))
    b = SweepStore(worker_store_dir(root, "b"))
    a.add_chunk(["k1", "k2"], np.array([1.5, 2.5]), np.array([0.1, 0.2]),
                metrics={"served": [3.0, 4.0]})
    b.add_chunk(["k2"], np.array([2.5]), np.array([9.9]),
                metrics={"served": [4.0]})
    out = merge(root, tmp_path / "merged")
    assert out["merged_items"] == 2 and out["duplicate_items"] == 1
    c = SweepStore(worker_store_dir(root, "c"))
    c.add_chunk(["k1"], np.array([1.5000001]), np.array([0.1]))
    with pytest.raises(FleetMergeConflict, match="bit-for-bit"):
        merge(root, tmp_path / "merged")
    d = SweepStore(worker_store_dir(tmp_path / "fleet2", "d"))
    d.add_chunk(["k9"], np.array([1.0]), np.array([0.1]),
                metrics={"served": [3.0]})
    e = SweepStore(worker_store_dir(tmp_path / "fleet2", "e"))
    e.add_chunk(["k9"], np.array([1.0]), np.array([0.1]),
                metrics={"served": [4.0]})
    with pytest.raises(FleetMergeConflict, match="metric"):
        merge(tmp_path / "fleet2", tmp_path / "merged2")


def test_task_spec_expands_to_exact_parent_keys(tmp_path):
    spec = _spec(scenarios=("steady", "flash_crowd"),
                 algos=("edf", "fcfs"), seeds=(0, 1, 2))
    root = tmp_path / "fleet"
    plan(spec, root, seeds_per_task=2)
    q = LeaseQueue(root / "queue")
    all_keys = set()
    for name in q.pending():
        task = q.read_task(name)
        sub = task_spec(spec, task)
        assert {it.key() for it in sub.expand()} == set(task.keys)
        all_keys |= set(task.keys)
    assert all_keys == {it.key() for it in spec.expand()}


# ===========================================================================
# The acceptance run: 4 subprocess workers, one SIGKILLed mid-run
# ===========================================================================

def _wait_for_lease(root, timeout=120.0):
    q = LeaseQueue(Path(root) / "queue")
    deadline = time.time() + timeout
    while time.time() < deadline:
        leased = q.leased()
        if leased:
            return leased
        time.sleep(0.05)
    raise AssertionError("no worker claimed a task in time")


def test_fleet_4_workers_one_killed_matches_single_process(
        tmp_path, monkeypatch):
    """A 4-worker fleet run of a (2 scenario × 2 policy × 4 seed) serving
    grid — one worker SIGKILLed mid-run, its lease reaped — merges into a
    store whose values are byte-identical to the single-process run, and
    pareto on that store does zero replays."""
    spec = _spec(scenarios=("steady", "flash_crowd"),
                 algos=("edf", "fcfs"), seeds=(0, 1, 2, 3))
    ref = run_sweep(spec, store_dir=tmp_path / "ref")

    root = tmp_path / "fleet"
    ttl = 2.0
    pl = plan(spec, root)
    assert pl["n_tasks"] == 16 and pl["n_items"] == 32

    procs = [subprocess.Popen(_worker_cmd(root, f"local-{i}", ttl=ttl),
                              env=_env(), stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
             for i in range(4)]
    try:
        leased = _wait_for_lease(root)
        q = LeaseQueue(root / "queue")
        doc = json.loads((q.lease_dir / f"{leased[0]}.json").read_text())
        owner = doc.get("lease", {}).get("owner", "")
        victim = next((procs[i] for i in range(4)
                       if owner == f"local-{i}"), procs[0])
        victim.kill()
        victim.wait()
        for p in procs:
            if p is not victim:
                assert p.wait(timeout=300) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    deadline = time.time() + 4 * ttl
    while time.time() < deadline and LeaseQueue(root / "queue").leased():
        time.sleep(0.1)
        reap(root)
    run_worker(root, owner="mopup")
    st = status(root)
    assert st["queue"]["pending"] == 0 and st["queue"]["leased"] == 0
    assert st["queue"]["done"] == 16

    mg = merge(root, tmp_path / "merged")
    assert mg["missing_items"] == 0
    assert mg["target_items"] == 32

    got = run_sweep(spec, store_dir=tmp_path / "merged")
    assert got.execution["chunks_computed"] == 0
    _same_values(ref, got)

    import repro_torch.tuning.pareto as pareto_mod

    def boom(*a, **kw):
        raise AssertionError("pareto replayed a horizon on a v3 store")
    monkeypatch.setattr(pareto_mod, "_replay_metrics", boom)
    frontiers = pareto_mod.frontier_points(tmp_path / "merged")
    assert set(frontiers) == {"steady", "flash_crowd"}
    assert all(len(pts) == 2 for pts in frontiers.values())


def test_worker_sigterm_is_a_clean_drain(tmp_path):
    root = tmp_path / "fleet"
    plan(_spec(seeds=(0, 1, 2, 3)), root)
    proc = subprocess.Popen(_worker_cmd(root, "term-w"), env=_env(),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        _wait_for_lease(root)
        proc.terminate()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    q = LeaseQueue(root / "queue")
    assert q.leased() == []
    assert len(q.done()) >= 1
    store = SweepStore(worker_store_dir(root, "term-w"))
    for name in q.done():
        task = q.read_task(name)
        assert all(k in store for k in task.keys)


def test_worker_wait_survives_empty_queue_and_drains_on_sigterm(tmp_path):
    root = tmp_path / "fleet"
    plan(_spec(seeds=(0, 1)), root)
    q = LeaseQueue(root / "queue")
    tasks_dir = root / "queue" / "tasks"
    stash = tmp_path / "stash"
    stash.mkdir()
    staged = list(tasks_dir.iterdir())
    assert len(staged) == 2
    for p in staged:
        p.rename(stash / p.name)
    proc = subprocess.Popen(
        _worker_cmd(root, "wait-w") + ["--wait", "--poll-interval", "0.1"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        # long enough for the interpreter to start and poll several times
        time.sleep(3.0)
        assert proc.poll() is None
        for p in list(stash.iterdir()):
            p.rename(tasks_dir / p.name)
        deadline = time.time() + 120
        while len(q.done()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(q.done()) == 2
        assert proc.poll() is None
        proc.terminate()
        assert proc.wait(timeout=30) == 0
        out = proc.stdout.read()
        assert "stop=SIGTERM" in out
        assert "2 task(s)" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert q.leased() == []
    store = SweepStore(worker_store_dir(root, "wait-w"))
    for name in q.done():
        assert all(k in store for k in q.read_task(name).keys)


# ===========================================================================
# CLI
# ===========================================================================

def _cli_spec_args():
    args = ["--kind", "serving", "--scenario", "steady", "--seeds", "0:2",
            "--ticks", "2", "--algos", "edf"]
    for k, v in {**SMALL, "switching_cost": 0, "stickiness": 0}.items():
        args += ["--override", f"{k}={v}"]
    return args


def test_fleet_cli_plan_worker_status_merge(tmp_path, capsys):
    from repro_torch.fleet.cli import main

    root, store = tmp_path / "fleet", tmp_path / "store"
    spec_args = _cli_spec_args()
    assert main(["plan", *spec_args, "--root", str(root),
                 "--store", str(store)]) == 0
    assert "planned 2 task(s)" in capsys.readouterr().out

    assert main(["status", "--root", str(root)]) == 0
    assert "2 pending" in capsys.readouterr().out

    assert main(["worker", "--root", str(root), "--owner", "cli-w",
                 "--max-tasks", "1", "--device", "cpu"]) == 0
    assert "1 task(s)" in capsys.readouterr().out
    assert main(["merge", "--root", str(root), "--store", str(store)]) == 2
    assert "still missing" in capsys.readouterr().out

    assert main(["worker", "--root", str(root), "--owner", "cli-w"]) == 0
    capsys.readouterr()
    assert main(["reap", "--root", str(root)]) == 0
    assert main(["merge", "--root", str(root), "--store", str(store)]) == 0
    capsys.readouterr()
    assert len(SweepStore(store)) == 4

    assert main(["status", "--root", str(root), "--watch", "--interval",
                 "0.05", "--json", str(tmp_path / "st.json")]) == 0
    assert "0 pending" in capsys.readouterr().out
    assert json.loads((tmp_path / "st.json").read_text())["queue"][
        "done"] == 2

    from repro_torch.sweeps.cli import main as sweeps_main
    rc = sweeps_main([*spec_args, "--out", str(store), "-q"])
    assert rc == 0
    capsys.readouterr()


def test_sweeps_cli_fleet_flag_end_to_end(tmp_path, capsys):
    from repro_torch.sweeps.cli import main as sweeps_main

    args = _cli_spec_args()
    ref_store = tmp_path / "ref"
    assert sweeps_main([*args, "--out", str(ref_store), "-q"]) == 0
    fleet_store = tmp_path / "fleet_store"
    assert sweeps_main([*args, "--out", str(fleet_store),
                        "--fleet", "2"]) == 0
    out = capsys.readouterr().out
    assert "merged" in out

    ref, got = SweepStore(ref_store), SweepStore(fleet_store)
    assert set(ref.keys()) == set(got.keys())
    for key in ref.keys():
        a = np.float64(ref.value(key))
        assert a.tobytes() == np.float64(got.value(key)).tobytes()
    with pytest.raises(SystemExit):
        sweeps_main([*args, "--no-store", "--fleet", "2"])
    capsys.readouterr()


def test_sweeps_cli_fleet_resumes_extended_seed_range(tmp_path, capsys):
    from repro_torch.sweeps.cli import main as sweeps_main

    def args(seeds):
        out = [a if a != "0:2" else seeds for a in _cli_spec_args()]
        return out + ["--out", str(tmp_path / "store"), "-q"]

    assert sweeps_main([*args("0:2"), "--fleet", "1"]) == 0
    assert len(SweepStore(tmp_path / "store")) == 4
    assert sweeps_main([*args("0:3"), "--fleet", "1"]) == 0
    assert len(SweepStore(tmp_path / "store")) == 6
    fleet_dir = tmp_path / "store" / "fleet"
    assert not fleet_dir.exists() or not list(fleet_dir.iterdir())
    capsys.readouterr()


# ===========================================================================
# Against the reference
# ===========================================================================

def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.json"))}


@pytest.mark.parametrize("seeds_per_task", [1, 2])
def test_plan_writes_the_references_files(ref, tmp_path, seeds_per_task):
    kw = dict(scenarios=("steady", "flash_crowd"), algos=("edf", "fcfs"),
              seeds=(0, 1, 2), knobs=((0.0, 0.0), (2.0, 3.0)))
    out_t = plan(_spec(**kw), tmp_path / "port",
                 seeds_per_task=seeds_per_task)
    out_r = ref["fleet"].plan(_spec(**kw, package=ref["sweeps"]),
                              tmp_path / "ref",
                              seeds_per_task=seeds_per_task)
    for d in (out_t, out_r):
        d.pop("fleet_root")
    assert out_t == out_r
    port, theirs = (_tree_bytes(tmp_path / d) for d in ("port", "ref"))
    assert port == theirs and "spec.json" in port
    assert len([k for k in port if k.startswith("queue/tasks/")]) == \
        out_t["n_tasks"]


def test_status_reads_across_packages(ref, tmp_path):
    root = tmp_path / "fleet"
    plan(_spec(seeds=(0, 1, 2)), root)
    run_worker(root, owner="w0", max_tasks=1)

    def strip(out):
        for rec in out["telemetry"].values():
            rec.pop("live")
        return out

    assert strip(status(root)) == strip(ref["fleet"].status(root))
    # and the reference's root reads the same in the port
    rroot = tmp_path / "rfleet"
    ref["fleet"].plan(_spec(seeds=(0, 1), package=ref["sweeps"]), rroot)
    assert strip(status(rroot)) == strip(ref["fleet"].status(rroot))


def test_port_fleet_merges_to_the_references_serving_bytes(ref, tmp_path):
    spec_r = _spec(scenarios=("steady", "flash_crowd"), algos=("edf",),
                   seeds=(0, 1), package=ref["sweeps"])
    want = ref["sweeps"].run_sweep(spec_r, store_dir=tmp_path / "ref")
    spec = _spec(scenarios=("steady", "flash_crowd"), algos=("edf",),
                 seeds=(0, 1))
    root = tmp_path / "fleet"
    plan(spec, root)
    run_worker(root, owner="a", max_tasks=2)
    run_worker(root, owner="b")
    assert merge(root, tmp_path / "merged")["missing_items"] == 0
    got = run_sweep(spec, store_dir=tmp_path / "merged")
    assert got.execution["chunks_computed"] == 0
    _same_values(want, got)
    theirs, mine = SweepStore(tmp_path / "ref"), SweepStore(
        tmp_path / "merged")
    for key in theirs.keys():
        assert mine.metrics(key) == theirs.metrics(key)


def test_sigma_fleet_on_the_cpu_merges_to_one_process(tmp_path):
    spec = SweepSpec(scenarios=("synthetic",), seeds=(0, 1, 2),
                     algos=("egp", "agp"), override_grid=(SYNTH,))
    one = run_sweep(spec, store_dir=tmp_path / "one", device="cpu")
    root = tmp_path / "fleet"
    assert plan(spec, root)["n_tasks"] == 6
    run_worker(root, owner="a", max_tasks=3, device="cpu")
    run_worker(root, owner="b", device="cpu")
    assert merge(root, tmp_path / "merged")["missing_items"] == 0
    got = run_sweep(spec, store_dir=tmp_path / "merged", device="cpu")
    assert got.execution["chunks_computed"] == 0
    _same_values(one, got)


def test_sweeps_cli_fleet_on_the_cpu_with_validation(tmp_path, capsys):
    from repro_torch.sweeps.cli import main as sweeps_main

    args = ["--scenario", "synthetic", "--seeds", "0:2", "--algos",
            "egp,agp", "--device", "cpu", "--validate",
            "--out", str(tmp_path / "store")]
    for k, v in SYNTH:
        args += ["--override", f"{k}={v}"]
    assert sweeps_main([*args, "--fleet", "2"]) == 0
    out = capsys.readouterr().out
    assert "planned 4 task(s)" in out and "0 chunk(s) computed" in out
    assert "validated against host path" in out
    assert sweeps_main([*args, "--fleet", "2"]) == 0
    assert "planned 0 task(s)" in capsys.readouterr().out
