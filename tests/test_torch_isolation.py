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


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import synthetic_instance
    from repro_torch.serving import Router
    from repro_torch.workloads import evaluate_sparse

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inst = synthetic_instance(30, n_edges=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_sparse([inst])
    with pytest.raises(RuntimeError, match="CUDA"):
        Router()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


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
