"""Hold the benchmark's ``optimizer_ms.train`` rule against the exact
reading, on the card, from one profile.

The benchmark's traced window keeps no correlation ids, so its reader
(``bench/metrics/optimizer_ms.train.py``) pairs launch calls with device
operations by their order. This script builds the cell's training state
as the benchmark's training cell does, warms it up, and runs one step then
``--steps`` steps in a ``bench.window`` range under
``repro_torch.obs.torchprof.profile_trace``. From that one Chrome trace it
reads the optimizer's device time a step twice: exactly, each device
operation's launch call found by its correlation id
(``torchprof.scope_device_ms``, the pairing ``kernel_launches`` uses), and
by the reader's rule, on the trace reduced to what the benchmark's
``Trace`` keeps (names and times). It prints both, their ratio and the
counts the rule pairs, as one JSON line::

    python3 tools/optimizer_ms_check.py --seed 7 --steps 1
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
CELL = "mamba2-2p7b.train-4k"
OPTIMIZER = "train.optimizer"


#: Chrome-trace categories of the events the benchmark's ``Trace`` keeps
#: as the device's: those the profiler records on the card, but for the
#: ranges' device copies (the profiler's own overhead records are
#: neither the device's nor the host process's)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "cuda_sync")


def bench_trace(doc: dict):
    """The benchmark's ``Trace`` of a Chrome trace: device and host events
    as ``(name, start_us, end_us)``, and the window's range."""
    from bench.tracing import WINDOW, Trace

    trace = Trace()
    host_pid = os.getpid()
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        ev = (e["name"], float(e["ts"]), float(e["ts"]) + e.get("dur", 0))
        if e.get("cat") in DEVICE_CATS:
            trace.device.append(ev)
        elif e.get("pid") == host_pid:
            if ev[0] == WINDOW:
                trace.window = (ev[1], ev[2])
            trace.host.append(ev)
    return trace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import feed, harness, port, weights as W
    from bench.tracing import window_range

    harness.cache_env(ROOT)
    import torch

    from repro_torch.obs.torchprof import profile_trace, scope_device_ms
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.trainer import (TrainState, make_train_step,
                                              param_tree)

    _, _, cfg, tr = harness.cell_parts(CELL, ROOT)
    dev = torch.device("cuda")
    B, S, V = tr["batch"], tr["seq_len"], cfg["vocab_size"]
    mc = port.model_config(cfg)
    model = port.build_model(mc, W.Weights(cfg, args.seed, dev).make())
    opt = AdamWConfig(**tr["optimizer"], state_dtype=cfg["opt_state_dtype"])
    state = TrainState(model, adamw_init(param_tree(model), opt))
    step = make_train_step(mc, opt)
    k = 0
    for k in range(1, tr["check_steps"] + 1):
        state, _ = step(state, feed.train_batch(args.seed, k, B, S, V, dev))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profile_trace(tmp) as path:
            k += 1
            state, _ = step(state, feed.train_batch(args.seed, k, B, S, V,
                                                    dev))
            torch.cuda.synchronize()
            with window_range():
                for _ in range(args.steps):
                    k += 1
                    state, _ = step(state, feed.train_batch(
                        args.seed, k, B, S, V, dev))
                torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
        doc = json.loads(Path(path).read_text())
    trace = bench_trace(doc)
    a, b = trace.window
    # the exact reading: the ranges inside the window, each operation by
    # its launch call's correlation id
    exact = scope_device_ms(doc, OPTIMIZER)
    inside = [i for i, (s, e) in enumerate(exact["ranges"])
              if a <= s and e <= b]
    exact_ms = sum(exact["device_ms"][i] for i in inside) / args.steps
    reader = harness.load_module(
        ROOT / "bench" / "metrics" / "optimizer_ms.train.py", "optimizer_ms")
    rule_ms = reader.read(SimpleNamespace(
        trace=trace, record={"traced": {"steps": args.steps}}))
    ops = [d for d in trace.device if a <= d[1] < b]
    cats = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and isinstance(e.get("pid"), int) \
                and e.get("pid") != os.getpid():
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "seed": args.seed,
        "steps": args.steps, "exact_ms": exact_ms, "rule_ms": rule_ms,
        "rule_over_exact": rule_ms / exact_ms if exact_ms else None,
        "exact_ops": sum(exact["ops"][i] for i in inside),
        "unpaired_device_ops": exact["unpaired"],
        "window_launch_calls": len(reader.launch_times(trace.host, a, b)),
        "window_device_ops": len(ops),
        "window_sync_records": sum(bool(reader.NOT_OP.search(d[0]))
                                   for d in ops),
        "device_events_by_cat": cats, "profiled_s": profiled_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
