"""The harness on the CPU at tiny sizes (a temporary checkout,
``tiny.checkout``): the result line's keys, cells, configurations and
metrics found as added files, the refusal without a card, and the
imports a run may not make."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
CELLS = [c["name"] for c in
         json.loads((BENCH.parent / "BENCHMARK.json").read_text())
         ["workloads"]]
SEED = 2 ** 31 + 101


def _run(root, cell, trace, seconds=0.3, seed=SEED):
    return harness.run(["--workload", cell, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       0.0, root=root, require_card=False)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_gives_the_contracts_line(tmp_path, cell):
    root = tiny.checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for trace in (0, 1):
        res = _run(root, cell, trace)
        assert list(res)[:5] == ["correct", "attempted", "failed",
                                 "metrics", "device"]
        assert list(res)[-1] == "checks"
        assert res["correct"] is True and res["failed"] == 0
        assert res["attempted"] > 0
        want = {m["name"] for m in harness.metrics_of(
            bench, cell, "per_layer" if trace else "end_to_end")}
        if trace:
            # on the CPU the readers of device time find nothing to read
            assert set(res["metrics"]) <= want and res["metrics"]
            assert {"busy_s", "window_s"} <= set(res["device"])
            assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(res["metrics"]) == want
        for c in res["checks"].values():
            assert c["value"] <= c["limit"]


def test_cells_configs_traffic_and_metrics_are_found_as_added_files(
        tmp_path):
    root = tiny.checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    b = root / "bench"
    cfg = json.loads((b / "configs" / "mamba2-2p7b.json").read_text())
    cfg.update(name="mamba2-deeper", n_layers=3)
    (b / "configs" / "mamba2-deeper.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "train-4k.json").read_text())
    tr.update(batch=4, seq_len=8)
    (b / "traffic" / "train-short.json").write_text(json.dumps(tr))
    (b / "limits" / "mamba2-deeper.train-short.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.5, "grad_norm_gap": 0.5,
                               "change_norm_gap": 0.5}}))
    (b / "metrics" / "steps_traced.py").write_text(
        "def read(view):\n    return view.record['traced']['steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mamba2-deeper", "source": "x",
                             "file": "bench/configs/mamba2-deeper.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mamba2-deeper.train-short",
                               "config": "mamba2-deeper",
                               "traffic": "train-short", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("mamba2-deeper.train-short")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "training step",
                               "moves": "train_tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run(root, "mamba2-deeper.train-short", 0)
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    res = _run(root, "mamba2-deeper.train-short", 1)
    assert res["metrics"]["steps_traced"]["value"] == 2
    # a metric without a workloads list reaches every cell of its moves
    assert "steps_traced" in _run(root, "mamba2-2p7b.train-4k", 1)[
        "metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _subprocess_run(root, cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(root / "bench" / "run.py"), "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)


def test_run_py_refuses_without_a_card(tmp_path):
    root = tiny.checkout(tmp_path)
    proc = _subprocess_run(root, CELLS[0])
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_a_checkout_without_the_program_is_refused(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "src").unlink()
    with pytest.raises(harness.Refused, match="repro_torch|program"):
        _run(root, CELLS[0], 0)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.BARRED), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax"}, path
        assert "bench.port" not in set(_imports(path))


def test_a_run_loads_no_barred_module(tmp_path):
    root = tiny.checkout(tmp_path)
    code = (f"import sys; sys.path.insert(0, {str(root)!r});"
            "from bench import harness;"
            f"harness.run(['--workload', {CELLS[0]!r}, '--seed', '5', "
            "'--seconds', '0.2'], 0.0, "
            f"root=__import__('pathlib').Path({str(root)!r}), "
            "require_card=False);"
            "print('BARRED', harness.barred_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert "BARRED []" in proc.stdout, proc.stderr[-2000:]


def test_barred_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.barred_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.barred_modules()
