"""Run one cell of the benchmark once (see ``bench/harness.py``)::

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench.harness import main

    sys.exit(main(t_start=T_START))
