"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
imports JAX or the JAX package, and the entry points default to CUDA and
refuse to run on the CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_without_loading_jax():
    code = ("import sys; import repro_torch.workloads, repro_torch.serving, "
            "repro_torch.convert, repro_torch.kernels._build; "
            "from repro_torch.core import synthetic_instance; "
            "from repro_torch.workloads import evaluate_sparse; "
            "evaluate_sparse([synthetic_instance(60, n_edges=2)], "
            "device='cpu'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_serving_path_runs_without_loading_jax():
    code = ("import sys, numpy as np; "
            "from repro_torch.configs import get_smoke_config; "
            "from repro_torch.serving import ModelServer; "
            "s = ModelServer(get_smoke_config('gemma2_27b'), bucket_batch=2, "
            "bucket_seq=16, device='cpu'); "
            "out, _, _ = s.generate(np.ones((2, 6), np.int64), n_steps=3); "
            "assert out.shape == (2, 3); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_training_path_runs_without_loading_jax(tmp_path):
    code = ("import sys; from repro_torch.launch.train import run_training; "
            f"out = run_training(steps=2, seq_len=16, global_batch=2, "
            f"checkpoint_dir={str(tmp_path)!r}, ckpt_every=1, "
            "verbose=False, device='cpu'); "
            "assert len(out['losses']) == 2; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sweep_path_runs_without_loading_jax(tmp_path):
    code = ("import sys; "
            "from repro_torch.sweeps import SweepSpec, run_sweep; "
            "from repro_torch.workloads import sweep; "
            "spec = SweepSpec(scenarios=('steady',), seeds=(0,), n_ticks=1, "
            "algos=('egp', 'sck'), override_grid=({'n_user_slots': 24},)); "
            "r = run_sweep(spec, device='cpu'); assert r.complete; "
            "s = sweep(['steady'], [0], n_ticks=1, device='cpu', "
            "n_user_slots=24); assert s['values']['steady'].shape == (1, 1); "
            "from repro_torch.sweeps.cli import main; "
            "assert main(['--scenario', 'steady', '--seeds', '0', '--ticks', "
            "'1', '--override', 'n_user_slots=24', '--device', 'cpu', "
            f"'--out', {str(tmp_path / 'store')!r}, '-q', '--validate']) "
            "== 0; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run([sys.executable, "-m", "repro_torch.sweeps",
                           "--scenario", "synthetic", "--override",
                           "n_users=30", "--algos", "egp,opt", "--device",
                           "cpu", "--no-store", "-q"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "synthetic[n_users=30]" in proc.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import synthetic_instance
    from repro_torch.serving import Router
    from repro_torch.sweeps import SweepSpec, run_sweep
    from repro_torch.workloads import evaluate_sparse, sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inst = synthetic_instance(30, n_edges=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_sparse([inst])
    with pytest.raises(RuntimeError, match="CUDA"):
        Router()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    small = {"n_user_slots": 16}
    accel = SweepSpec(scenarios=("steady",), n_ticks=1, algos=("egp", "sck"),
                      override_grid=(small,))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep(accel)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep(["steady"], [0], n_ticks=1, **small)
    host = SweepSpec(scenarios=("steady",), n_ticks=1, algos=("sck", "opt"),
                     override_grid=(small,))
    assert run_sweep(host).execution["backend"] == "host"


def test_chip_smoke_fails_without_a_card(tmp_path, monkeypatch):
    """No result without CUDA, and none from a directory that holds only
    the script."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
