"""The benchmark's yardstick arithmetic, frozen here so that a change to
the program cannot change what a metric reads: the kernels' work
(:mod:`.kernels`, copied from the port's ``kernels/*/ops.py``), the model's
FLOPs (:mod:`.model`) and the card's peaks (``peaks.json``)."""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
