"""The port's Pareto frontiers (repro_torch.tuning.pareto) and tuning CLI
against the JAX package's: pareto_mask_torch on the CPU equals the
reference's NumPy mask over its random-grid parametrisation, in float32
and float64 and below float32 resolution; frontier_points and
frontier_rows over a serving store the port wrote equal the reference's
NumPy path, through the NumPy and the device mask; and the ``fit``,
``pareto`` and ``show`` subcommands print what the reference's print."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.tuning.cli as RCLI
import repro.tuning.pareto as RP
import repro_torch.tuning.cli as TCLI
import repro_torch.tuning.pareto as TP
from repro.sweeps import frontier_table as r_frontier_table
from repro_torch.sweeps import SweepSpec, frontier_table, run_sweep
from torch_recorders import recorders_off  # noqa: F401  (autouse)

SMALL = {"n_user_slots": 32, "n_services": 8, "max_impls": 3, "n_edges": 4}
LOAD = {"prompt_tokens": 768, "new_tokens": 64, "max_batch": 4}
#: The reference's open-loop (switching_cost, stickiness) grid
#: (tests/test_tuning.py).
KNOBS = ((0.0, 0.0), (0.0, 3.0), (2.0, 0.0), (2.0, 3.0))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A kind='serving' store written by the port (two scenarios, the
    reference's knob grid, EDF and FCFS, two seeds of two ticks)."""
    grid = tuple(tuple(sorted({**SMALL, **LOAD, "switching_cost": sc,
                               "stickiness": st}.items()))
                 for sc, st in KNOBS)
    spec = SweepSpec(kind="serving", scenarios=("steady", "flash_crowd"),
                     seeds=(0, 1), n_ticks=2, algos=("edf", "fcfs"),
                     override_grid=grid)
    d = tmp_path_factory.mktemp("pareto") / "store"
    run_sweep(spec, store_dir=d)
    return d


# ===========================================================================
# the dominance mask
# ===========================================================================

def test_pareto_mask_np_is_the_references():
    cases = [(np.array([[1.0, 1.0], [2.0, 2.0], [2.0, 2.0], [0.5, 3.0]]),
              (True, True)),
             (np.array([[1.0, 0.4], [2.0, 2.0], [2.0, 0.5]]), (True, False)),
             (np.array([[1.0, 5.0], [1.0, 7.0]]), (True, True)),
             (np.zeros((0, 2)), (True, True)),
             (np.array([[1, 2], [2, 1], [0, 0]]), (True, True))]
    for pts, maximize in cases:
        want = RP.pareto_mask_np(pts, maximize)
        assert TP.pareto_mask_np(pts, maximize).tolist() == want.tolist()
        got = TP.pareto_mask_torch(pts, maximize, device="cpu")
        assert got.dtype == np.bool_ and got.tolist() == want.tolist()
    for fn in (TP.pareto_mask_np, lambda p, m: TP.pareto_mask_torch(
            p, m, device="cpu")):
        with pytest.raises(ValueError):
            fn(np.zeros((3, 2)), (True,))
        with pytest.raises(ValueError):
            fn(np.zeros(3), (True,))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 2), (17, 2), (64, 3), (128, 4)])
def test_pareto_mask_torch_matches_numpy_on_random_grids(seed, dtype, shape):
    """The reference's parametrisation (tests/test_tuning.py), quantized
    for plenty of exact ties and duplicates."""
    rng = np.random.default_rng(seed)
    pts = np.round(rng.normal(size=shape).astype(dtype), 1)
    maximize = [bool(b) for b in rng.integers(0, 2, size=shape[1])]
    want = RP.pareto_mask_np(pts, maximize)
    np.testing.assert_array_equal(
        TP.pareto_mask_torch(pts, maximize, device="cpu"), want)
    # a tensor goes through as it is, in its own dtype
    np.testing.assert_array_equal(
        TP.pareto_mask_torch(torch.from_numpy(pts), maximize,
                             device="cpu"), want)


def test_pareto_mask_torch_keeps_sub_f32_resolution():
    pts = np.array([[0.5, 1.0], [0.5 + 1e-12, 1.0]])
    np.testing.assert_array_equal(
        TP.pareto_mask_torch(pts, (True, False), device="cpu"),
        [False, True])
    np.testing.assert_array_equal(RP.pareto_mask_np(pts, (True, False)),
                                  [False, True])
    # the control: the same points cast to float32 merge, and both stay
    np.testing.assert_array_equal(
        TP.pareto_mask_torch(pts.astype(np.float32), (True, False),
                             device="cpu"), [True, True])


def test_pareto_mask_torch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.pareto_mask_torch(np.zeros((2, 2)), (True, True))


# ===========================================================================
# frontiers from a store the port wrote
# ===========================================================================

def _points(frontiers):
    return {sc: [repr(p) for p in pts] for sc, pts in frontiers.items()}


@pytest.mark.parametrize("scenarios", [None, ("flash_crowd",)])
def test_frontier_points_are_the_references(store, scenarios):
    want = RP.frontier_points(store, scenarios=scenarios)
    host = TP.frontier_points(store, scenarios=scenarios)
    dev = TP.frontier_points(str(store), scenarios=scenarios,
                             use_device=True, device="cpu")
    assert _points(host) == _points(want) == _points(dev)
    assert set(host) == ({"steady", "flash_crowd"} if scenarios is None
                         else {"flash_crowd"})
    for pts in host.values():
        assert len(pts) == len(KNOBS) * 2
        assert any(p.qos_frontier for p in pts)
        assert any(p.acc_lat_frontier for p in pts)
    rows = TP.frontier_rows(host)
    assert json.dumps(rows, sort_keys=True) == \
        json.dumps(RP.frontier_rows(want), sort_keys=True)
    assert frontier_table(rows) == r_frontier_table(RP.frontier_rows(want))


def test_frontier_replay_path_is_the_references(store, monkeypatch):
    """The legacy path (a store without per-item metrics) replays each
    grid point's horizon in both packages, to the same points."""
    monkeypatch.setattr(TP, "_store_metrics", lambda *a, **kw: None)
    monkeypatch.setattr(RP, "_store_metrics", lambda *a, **kw: None)
    assert _points(TP.frontier_points(store, scenarios=("steady",))) == \
        _points(RP.frontier_points(store, scenarios=("steady",)))


# ===========================================================================
# the CLI
# ===========================================================================

def test_tuning_cli_prints_the_references(store, tmp_path, capsys):
    runs = [
        (["fit", "--store", str(store), "--out", str(tmp_path / "{p}.json")],
         ["fit", "--store", str(store), "--out", str(tmp_path / "{p}.json")]),
        (["fit", "--store", str(store), "--policy", "fcfs", "--out",
          str(tmp_path / "{p}_fcfs.json")],) * 2,
        (["pareto", "--store", str(store), "--json",
          str(tmp_path / "{p}_rows.json")],) * 2,
        # the reference's --jax compares float64 through a JAX call that
        # JAX removed (ROADMAP §C), so the device mask is held to its
        # NumPy path
        (["pareto", "--store", str(store), "--scenario", "steady",
          "--device", "cpu"], ["pareto", "--store", str(store),
                               "--scenario", "steady"]),
        (["show", "--table", str(tmp_path / "{p}.json")],) * 2,
        (["show"],) * 2,
        (["show", "--table", str(tmp_path / "nope.json")],) * 2,
    ]
    for t_argv, r_argv in runs:
        outs = []
        for p, cli, argv in (("t", TCLI, t_argv), ("r", RCLI, r_argv)):
            rc = cli.main([a.format(p=p) for a in argv])
            got = capsys.readouterr()
            outs.append((rc, got.out.replace(str(tmp_path / f"{p}"), "X"),
                         got.err))
        assert outs[0] == outs[1], t_argv
    for name in ("{p}.json", "{p}_fcfs.json", "{p}_rows.json"):
        t = json.loads(Path(tmp_path / name.format(p="t")).read_text())
        r = json.loads(Path(tmp_path / name.format(p="r")).read_text())
        t.pop("source", None)
        r.pop("source", None)
        assert t == r, name


def test_tuning_cli_device_flag_defaults_to_cuda(store, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TCLI.main(["pareto", "--store", str(store), "--device"])
