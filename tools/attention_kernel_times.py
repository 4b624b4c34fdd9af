#!/usr/bin/env python3
"""Time the flash-attention kernels of one checkout on a CUDA card.

    python3 tools/attention_kernel_times.py [--root DIR] [--reps N]

Builds the kernel library of the checkout at ``--root`` (default: the one
this script sits in; its ``src/`` is imported, and the library is built
into its ``build/``), then times B4 (``flash_attention_cuda``), B5
(``flash_attention_dq_cuda``) and B6 (``flash_attention_dkv_cuda``) in bf16
at the main-path shapes (q/dO [8, 1024, 15, 64], k/v [8, 1024, 5, 64],
causal), beside torch's ``scaled_dot_product_attention`` and its backward
on the same inputs. Each time is the median of ``--reps`` calls between
two CUDA events, after two warm-up calls. Prints one JSON line with the
card's name and power limit. To compare two versions, run it for each
checkout in turn on one card within one run (parent, change, change,
parent): each run is its own process, so each imports its own package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPE = dict(B=8, S=1024, Hq=15, Hkv=5, hd=64)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("attention_kernel_times: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import load_library

    _, info = load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, Hq, Hkv, hd = (SHAPE[k] for k in ("B", "S", "Hq", "Hkv", "hd"))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, do = (randn(B, S, Hq, hd), randn(B, S, Hkv, hd),
                   randn(B, S, Hkv, hd), randn(B, S, Hq, hd))
    o, lse = fa.flash_attention_cuda(q, k, v)
    dsum = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)
    calls = {
        "flash_attention": lambda: fa.flash_attention_cuda(q, k, v),
        "flash_attention_dq": lambda: fa.flash_attention_dq_cuda(
            q, k, v, do, lse, dsum),
        "flash_attention_dkv": lambda: fa.flash_attention_dkv_cuda(
            q, k, v, do, lse, dsum),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True),
        "sdpa_backward": lambda: torch.autograd.grad(
            sdpa, (qs, ks, vs), dos, retain_graph=True),
    }
    with torch.no_grad():
        ms = {name: time_ms(fn, args.reps) for name, fn in calls.items()
              if name != "sdpa_backward"}
    ms["sdpa_backward"] = time_ms(calls["sdpa_backward"], args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "card": card, "shape": SHAPE,
                      "build_s": info["build_s"], "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
