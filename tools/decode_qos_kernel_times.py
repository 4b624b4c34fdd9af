#!/usr/bin/env python3
"""Time the GQA decode (B7) and dense QoS matrix (B1) kernels of one
checkout on a CUDA card.

    python3 tools/decode_qos_kernel_times.py [--root DIR] [--reps N]

Builds the kernel library of the checkout at ``--root`` (default: the one
this script sits in; its ``src/`` is imported, and the library is built
into its ``build/``), then times at the main-path shapes:

* B7 ``gqa_decode_cuda`` in bf16 where the serving paths decode, 8 rows at
  kv_len 1040 of a 2,048-slot cache: smollm-360m's q [8, 15, 64] against
  [8, 2048, 5, 64], and zamba2-2.7b's q [8, 32, 80] against [8, 2048, 32,
  80]; beside torch's scaled_dot_product_attention on the same inputs
  with the validity mask. Each as the median of ``--reps`` calls between
  two CUDA events, and as device time from ``torch.profiler`` (the
  kernel's own, median per call; SDPA's kernels summed per call);
* B1 ``qos_matrix_cuda`` at [10⁶, 537] float32 (the 10⁶-user route's),
  events and device time, beside a store-only stream of the same 2.15 GB
  (``fill_`` of a tensor of that shape) as a yardstick for its stores.

Prints one JSON line with the card's name and power limit. To compare two
versions, run it for each checkout in turn on one card within one run
(parent, change, change, parent): each run is its own process, so each
imports its own package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

#: (label, B, Sc, Hkv, G, hd, kv_len)
DECODE_SHAPES = (("smollm", 8, 2048, 5, 3, 64, 1040),
                 ("zamba2", 8, 2048, 32, 1, 80, 1040))
QOS_SHAPE = (1_000_000, 537)


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, name_part: str | None = None):
    """Device milliseconds per call over ``reps`` calls from
    ``torch.profiler``: the median of the kernels whose name holds
    ``name_part`` (one a call), or, without it, every kernel's time summed
    and divided by ``reps``. None if the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation
          and (name_part is None or name_part in e.name)]
    if not us:
        return None
    return (statistics.median(us) if name_part else sum(us) / reps) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_qos_kernel_times: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.qos_matrix import ops

    _, info = load_library()
    dev = torch.device("cuda")
    ms = {}

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, B, Sc, Hkv, G, hd, n in DECODE_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).bfloat16()

        q, kc, vc = randn(B, Hkv * G, hd), randn(B, Sc, Hkv, hd), \
            randn(B, Sc, Hkv, hd)
        kv_len = torch.full((B,), n, dtype=torch.int32, device=dev)
        mask = (torch.arange(Sc, device=dev)[None, :]
                < kv_len[:, None])[:, None, None, :]

        def kernel():
            return gd.gqa_decode_cuda(q, kc, vc, kv_len)

        def sdpa():
            return F.scaled_dot_product_attention(
                q[:, None].transpose(1, 2), kc.transpose(1, 2),
                vc.transpose(1, 2), attn_mask=mask, enable_gqa=True)

        ms[f"gqa_decode_{label}"] = time_ms(kernel, args.reps)
        ms[f"gqa_decode_{label}_device"] = device_ms(
            kernel, args.reps, "gqa_decode_kernel")
        ms[f"sdpa_{label}"] = time_ms(sdpa, args.reps)
        ms[f"sdpa_{label}_device"] = device_ms(sdpa, args.reps)
        del q, kc, vc

    U, P = QOS_SHAPE
    rng = np.random.default_rng(4)
    f32 = np.float32
    host = [rng.uniform(0, 1, U).astype(f32), rng.uniform(0, 10, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.integers(0, 100, U).astype(np.int32),
            rng.uniform(0, 1, P).astype(f32), rng.uniform(1, 30, P).astype(f32),
            rng.uniform(1, 30, P).astype(f32),
            rng.integers(0, 100, P).astype(np.int32)]
    qos_args = [torch.from_numpy(a).to(dev) for a in host]

    def qos():
        return ops.qos_matrix_cuda(*qos_args, delta_max=10.0)

    ms["qos_matrix"] = time_ms(qos, args.reps)
    ms["qos_matrix_device"] = device_ms(qos, args.reps, "qos_matrix_kernel")
    # a yardstick for B1's stores: PyTorch's fill of a tensor of the same
    # [U, P] float32, a store-only stream of the same bytes
    sink = torch.empty((U, P), dtype=torch.float32, device=dev)
    ms["store_only"] = time_ms(lambda: sink.fill_(0.5), args.reps)
    ms["store_only_device"] = device_ms(lambda: sink.fill_(0.5), args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "card": card,
                      "decode_shapes": DECODE_SHAPES,
                      "qos_shape": QOS_SHAPE,
                      "build_s": info["build_s"], "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
