"""The control of every cell, on the card at the cell's own size: the
plain reference computed with float8 products in the program's place
fails the cell's limits where the program passes them, and so does a
training cell's fault read against the reference (half of each batch left
out). Runs on the card only (``-m cuda``); each cell takes about a
minute::

    python -m pytest -q -m cuda bench/tests/test_bench_control.py
"""
import json
import time
from pathlib import Path

import pytest

from bench import checks, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "own size")
    harness.cache_env(ROOT)
    _, c, config, traffic = harness.cell_parts(cell, ROOT)
    harness._program_in_checkout(ROOT)
    driver = harness.load_module(ROOT / "bench" / "drivers" /
                                 f"{traffic['driver']}.py", "bench_driver")
    limits = json.loads((ROOT / "bench" / "limits" / f"{cell}.json")
                        .read_text())["limits"]
    out = driver.run(harness.Ctx(cell, config, traffic, 2 ** 31 + 977, 8.0,
                                 False, torch.device("cuda", 0),
                                 time.perf_counter(), control=True))
    assert checks.verdict(out["numbers"], limits)[0]
    for name, numbers in out["control"].items():
        assert not checks.verdict(numbers, limits)[0], name
