#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits nonzero, no result):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of the kernel library from src/repro_torch/csrc, with ptxas's
   registers and spills and each attention and SSD kernel's tensor-core
   instructions in the library's SASS (the bf16 B4, B5 and B6 must have
   some, their float32 versions none; B8's three product kernels some at
   N = 64 and 128);
2. every CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged small shapes, with its time, the plain
   version's time, its bound and, where one exists, a PyTorch call's time;
   B1 also bit-equal to its plain version (U * P not a multiple of 4, P
   below 4, one user); B2's fused candidate build (topk_candidates_kernel)
   with cand_idx equal and cand_q bit-equal to topk_candidates_ref and two
   calls bit-equal at one user, k < M, k = M, -1 padding with a service
   that has no implementation, QoS ties, a table larger than a block's
   shared memory and the main path's [10^6, 10],
   and its device time; the pre-gathered qos_candidates_kernel held too;
   for B3 also its device time alone and torch.max's (torch.profiler);
3. the main path at full size: a 1,000,000-user, 1,000-edge instance
   through evaluate_sparse (kernels) and Router.route (dense QoS kernel +
   OMS), with launch counts; then the same tick with the plain versions
   (same x), a second kernel tick (bit-identical), σ against a float64
   host evaluation, the candidate build's host and device time (one
   launch, no other device kernel), and the greedy loop's device time by
   kernel (B3's share);
4. the routed value against the sparse σ;
5. paper-scale instances against the host oracle: the sparse tick and
   Router.place with EGP, AGP and OPT (within 1e-4 of egp_np, agp_np,
   opt_np; EGP's ratio to OPT logged); then the dense batched path: the
   reference benchmark's mixed-size batch at 10,000 users through
   evaluate_batch, bucketed and padded, EGP and AGP, within 1e-4 of the
   host, x identical with the plain versions and on a rerun, B1 and B3
   launched;
6. the attention kernels (flash-attention forward B4, GQA decode B7)
   against their plain versions in float32 and bfloat16: at the serving
   path's shapes, at gemma2's head width with a window and a softcap, with
   ragged lengths, and in ring mode, with their times, bounds, achieved
   TFLOP/s and the time of torch's scaled_dot_product_attention on the
   same inputs; B7 also at the edges of its split-KV plan (empty and
   one-slot splits, a narrow window, ring past an Sc that is no multiple
   of 64, G = 5 and 8), two calls bit-equal, and its device time and
   SDPA's (torch.profiler) at the smollm and zamba2 serving shapes;
7. serving at full width: smollm-360m (32 layers, d=960, 15/5 heads,
   49,152-token vocabulary, random weights from a seed) generates 32
   tokens for 8 prompts of 1,024 tokens through ModelServer, with launch
   counts (B4 once per layer per prefill, B7 once per layer per step);
   then, teacher-forced on those tokens, every attention call of the
   bf16 model is held against its plain version on its own inputs
   (within 2 bf16 ulps), the bf16 logits against the plain model's
   (within max abs and rms limits that controls with one coarsened layer
   exceed), and
   the same weights in float32 compute must give the plain attention's
   logits within 1e-4;
8. the SSD scan kernel (B8) against both plain versions (the sequential
   recurrence and the chunked scan) in float32 at the mamba2 and zamba2
   serving shapes and at a ragged shape with an initial state, within
   3e-4 of the reference's largest value, each launch's scratch (C·Bᵀ,
   chunk states, entering states) against the plain chunked scan's
   intermediates, two calls bit-equal, with its time, the plain versions'
   times, its float32 bound and the bound of the work its tensor-core
   plan runs;
9. serving mamba2-2.7b at its published widths and full depth (64 Mamba2
   layers, d=2560, 80 heads x 64, N=128, 50,280-token vocabulary) as
   phase 7 does: B8 once per layer per prefill and never in a decode step,
   every B8 call of the teacher-forced run held against the plain scan
   on its own inputs, the bf16 logits within limits that controls (layer
   0's SSD output at 2 and 6 mantissa bits) exceed, float32 logits within
   1e-4;
10. serving zamba2-2.7b at its published widths and full depth (54 Mamba2
   layers, N=64, two shared attention blocks applied 9 times at hd=80) the
   same way, with B8 54, B4 9 and B7 9 x 32 launches per generate and
   every B4/B7/B8 call held against its plain version;
11. the flash-attention backward kernels (B5 dQ, B6 dK/dV) against their
   plain version in float32 and bfloat16 at the training shape, at hd=80
   with G=1, with a sliding window, at a ragged length and non-causal,
   and in float32 also against torch's autograd through the plain
   attention, with their times, bounds, achieved TFLOP/s, the plain
   version's time and the backward of torch's
   scaled_dot_product_attention;
12. training smollm-360m at full width and depth (32 layers, random
   weights from a seed) through run_training: 6 AdamW steps on
   TokenPipeline batches of 8 x 1,024 tokens, bf16 compute, f32 master
   weights and Adam state, remat: finite and falling loss, launch counts
   (B4 64, B5 32, B6 32, B7 and B8 0 per step), no parameter without a
   gradient, every B5/B6 call of a step within 2 bf16 ulps of its plain
   version as it comes and again with dO scaled by a power of two that
   brings the largest gradient into [0.5, 1) (a control with one call's
   dq at 4 mantissa bits must exceed that), float32 gradients of a 2 x
   512-token step within 1e-4 of the plain versions' (a control with
   layer 0's dQ at 6 mantissa bits must exceed that), and at 4 layers 4
   straight steps bitwise equal to 2 steps + checkpoint save + restore +
   2 steps; step time, tokens/s, peak memory and the device time of one
   step by kernel (B4, B5 and B6 each);
13. the sweep engine (repro_torch.sweeps.run_sweep, tracing on, each part
   into its own store): Fig. 3 at the §VI-B widths (synthetic, 2,000
   users, seeds 0-7; EGP and AGP on the card through evaluate_batch, SCK,
   RND and OPT on the host) with the accelerator values within 1e-4 of
   egp_np/agp_np and the host columns bit-identical to a run on the CPU,
   its table and the mean EGP/OPT ratio logged; the same generator at
   10,000 users (seeds 0-3, one-item chunks) within 1e-4 of the host, one
   item's launches (B1 once, B3 once a greedy iteration), its device time
   by kernel, each executor's items/s and the obs span totals; every
   registered scenario at its own configuration (seeds 0-3) within 1e-4
   of the host, with edge_failure's dead edges placing nothing from their
   failure tick on; flash_crowd and edge_failure killed after two one-item
   chunks and resumed (a third call computes nothing), bit-identical to a
   one-shot run, to a globally padded run and to a run with tracing off;
   and Fig. 3's accelerator values bit-identical with B1's and B3's plain
   versions.

It prints a JSON line of per-kernel numbers and, last, the device line
``{"ok": true, "device": {...}}``. It needs the repository around it and
exits nonzero where torch sees no CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Main-path scale (the §VI-B catalog: 100 services, ≤ 10 implementations).
U_MAIN, E_MAIN, SEED = 1_000_000, 1000, 0
#: Serving path: batch, prompt length, new tokens, cache slots.
SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_SEQ = 8, 1024, 32, 2048
#: H100 SXM peaks (data sheet): HBM bytes/s, non-tensor-core f32 op/s and
#: bf16 tensor-core op/s.
HBM_BYTES_S, F32_OPS_S, BF16_OPS_S = 3.35e12, 67e12, 989e12
REPS = 25
QOS_TOL = 1e-6
#: The batched path: the reference benchmark's mixed-size batch at U0 =
#: 10,000 users (benchmarks/placement_scale.py, under its dense_max_u of
#: 20,000), values within the reference's batched-vs-host tolerance
#: (tests/test_workloads.py).
BATCH_U0, BATCH_ATOL = 10_000, 1e-4
#: A paper-scale case whose host opt_np takes longer is left out of the
#: OPT check (and says so).
OPT_HOST_LIMIT_S = 60.0
#: max abs error of an attention kernel against its plain version, by
#: dtype (the JAX package's own kernel tolerances, tests/test_kernels.py).
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16 outputs of a kernel and its plain version, which compute the same
#: float32 values in different orders, round to the same or neighbouring
#: bf16 values: |kernel - plain| <= 2 bf16 ulps of |plain| + 1e-5 (the
#: float32 readings stay below 1.2e-6).
BF16_ULPS, BF16_ATOL = 2, 1e-5
#: max abs difference of float32 logits, the port's model tolerance against
#: the JAX package (tests/test_torch_models.py).
F32_LOGITS_TOL = 1e-4
#: Controls of a served model's bf16 logits limit (SERVED): the plain model
#: with layer 0's attention or SSD output rounded to b mantissa bits (bf16
#: keeps 7), for each b of CONTROL_SWEEP; the one at CONTROL_BITS must land
#: above the limit, so the limit tells a layer degraded that far from
#: rounding drift.
CONTROL_BITS, CONTROL_SWEEP = 2, (6, 5, 4, 3, 2)
#: max abs error of the SSD scan kernel against a plain version, after
#: dividing both by the plain version's largest |value| (the reference's
#: 3e-4 kernel tolerance, tests/test_kernels.py).
SSD_TOL = 3e-4
#: Each served model: the model-layer functions whose layer-0 output the
#: control rounds; the bf16 teacher-forced logits limit (kernels vs plain,
#: max abs), which the control at CONTROL_BITS must exceed; and a limit on
#: the root-mean-square difference with the number of mantissa bits of
#: the control that must exceed it. Set from H100 readings (kernels vs
#: plain; control): max abs smollm 0.0527 (about 6 bf16 ulps at its
#: largest logit, 3.25) and 0.1426 at b = 2, mamba2 0.2004 and 0.2998,
#: zamba2 0.1719 and 0.2891; rms smollm 0.00916 and 0.0164 at b = 3,
#: mamba2 0.0336 and 0.0513 at b = 6, zamba2 0.0333 and 0.0471 at b = 6.
#: In the Mamba stacks the max abs limit tells only a gross fault from
#: rounding (a control at b = 6 already reads 0.27-0.28 there); the rms
#: limit resolves one layer at 6 mantissa bits, and the per-call checks
#: are the fine gate.
SERVED = {
    "smollm_360m": dict(control=("attention", "decode_attention"),
                        bf16_tol=0.1, bf16_rms=(0.013, 3)),
    "mamba2_2p7b": dict(control=("ssd", "ssd_decode_step"), bf16_tol=0.25,
                        bf16_rms=(0.042, 6)),
    "zamba2_2p7b": dict(control=("ssd", "ssd_decode_step"), bf16_tol=0.25,
                        bf16_rms=(0.042, 6)),
}
#: The model-layer dispatchers that launch a kernel on the serving path.
KERNEL_DISPATCHERS = ("attention", "decode_attention", "ssd")
#: Training path: steps of the full-size run, batch, sequence length and
#: peak learning rate (3e-4: GPT-3's for its 350M model, Brown et al. 2020,
#: Table 2.1; run_training's default 1e-3 made the full model's loss spike
#: within 6 steps on an H100); the float32 gradient check's batch and
#: length; the resume check's depth.
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = 6, 8, 1024, 3e-4
GRAD_B, GRAD_S, RESUME_LAYERS = 2, 512, 4
#: float32 gradients, kernels vs plain, each leaf's max abs difference over
#: its largest |value| (the port's float32 gradient tolerance against the
#: JAX package, tests/test_torch_training.py); the control rounds layer
#: 0's dQ to GRAD_CONTROL_BITS mantissa bits and must exceed it.
GRAD_TOL, GRAD_CONTROL_BITS = 1e-4, 6
#: The control of phase 12's per-call B5/B6 reading at scaled dO rounds one
#: call's dq to this many mantissa bits. bf16 keeps 7, so rounding to 6
#: moves a value by at most one bf16 ulp (a tie rounds away), which a
#: 2-ulp gate passes by design; at 4 bits a tie moves it by 4 ulps.
CALL_CONTROL_BITS = 4
#: B5/B6 in float32 against the plain version: max abs difference over the
#: plain output's largest |value|, or over 1 where that is smaller (the
#: reference's absolute 3e-4, tests/test_kernels.py).
BWD_TOL = 3e-4
#: Phase 13, the sweep engine: Fig. 3 at the §VI-B widths (the reference
#: sweep spec's _SYNTH_DEFAULTS: 10 edges, 100 services, U{1..10}
#: implementations) with 2,000 users and 8 seeds; the same generator at
#: 10,000 users (600 MB an item by bytes_per_item, so one-item chunks at
#: the default 512 MB budget) for 4 seeds; every registered scenario at its
#: own configuration for 4 seeds. Accelerator values are held within the
#: reference's host-parity tolerance of the host path
#: (repro/sweeps/shard.py HOST_PARITY_ATOL).
SWEEP_FIG3_USERS, SWEEP_FIG3_SEEDS = 2000, 8
SWEEP_FULL_USERS, SWEEP_FULL_SEEDS = 10_000, 4
SWEEP_SCENARIO_SEEDS, SWEEP_ATOL = 4, 1e-4
SWEEP_SCENARIOS = ("diurnal", "edge_failure", "flash_crowd",
                   "mobility_churn", "steady", "trace_replay",
                   "trace_replay_azure", "trace_replay_bursty")
SOURCE = {
    "qos_matrix": "src/repro_torch/csrc/qos_kernels.cu",
    "qos_candidates": "src/repro_torch/csrc/qos_kernels.cu",
    "greedy_argmax": "src/repro_torch/csrc/qos_kernels.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "gqa_decode": "src/repro_torch/csrc/gqa_decode.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
    "flash_attention_dq": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_dkv": "src/repro_torch/csrc/flash_attention_bwd.cu",
}
REPLACES = {
    "qos_matrix": "src/repro/kernels/qos_matrix/qos_matrix.py:120",
    "qos_candidates": "src/repro/kernels/qos_matrix/qos_matrix.py:190",
    "greedy_argmax": "src/repro/kernels/qos_matrix/qos_matrix.py:244",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:119",
    "gqa_decode": "src/repro/kernels/gqa_decode/gqa_decode.py:100",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:86",
    "flash_attention_dq":
        "src/repro/kernels/flash_attention/backward.py:145",
    "flash_attention_dkv":
        "src/repro/kernels/flash_attention/backward.py:164",
}


#: Keys a kernel's row of the JSON line carries where its phase gives them:
#: B3's device times, B8's bound of the work its plan runs, notes, and B1's
#: and B3's launches on phase 13's sweep.
EXTRA_KEYS = ("device_ms", "library_device_ms", "plan_bound_ms",
              "plan_bound_by", "note", "sweep_launches")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each between two
    CUDA events on the current stream, after two warm-up calls."""
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


def device_ms_by_kernel(fn) -> dict:
    """Device milliseconds per kernel name over one ``fn()`` call, from
    ``torch.profiler`` (empty if the profiler records no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
    return out


def device_events(fn) -> list:
    """``[(name, device ms)]`` of every device activity (kernels, copies)
    of one ``fn()`` call after one warm-up call, in order, from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms_per_call(fn, name_part: str, reps: int = REPS):
    """Median device milliseconds of the kernels whose name holds
    ``name_part``, one per ``fn()`` call over ``reps`` calls after two
    warm-up calls, from ``torch.profiler``; None if the profiler records
    no such kernel."""
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
          and name_part in e.name]
    return statistics.median(us) / 1e3 if us else None


def device_ms_total(fn, reps: int = REPS):
    """Device milliseconds of every kernel ``fn()`` launches, per call, over
    ``reps`` calls (``torch.profiler``; None if it records none)."""
    by_kernel = device_ms_by_kernel(lambda: [fn() for _ in range(reps)])
    return sum(by_kernel.values()) / reps if by_kernel else None


def _sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (0 where ``x`` is 0)."""
    import torch

    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return torch.where(x != 0, ulp, 0.0)


def bf16_ulp_err(out, ref) -> tuple[float, float]:
    """``(max_abs, ulps)`` of ``out`` against ``ref``: the max abs
    difference, and the max over elements of ``(|out - ref| - BF16_ATOL)``
    in bf16 ulps of ``ref``, which the ulp bound holds at BF16_ULPS."""
    d = (out.float() - ref.float()).abs()
    excess = (d - BF16_ATOL) / bf16_ulp(ref)       # inf: beyond at ref 0
    return float(d.max()), float(excess.nan_to_num(nan=0.0).max()
                                 .clamp(min=0))


def bound_ms(n_bytes: float, n_ops: float, ops_s: float = F32_OPS_S
             ) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ===========================================================================
# phase 1: the build, and the tensor-core instructions of the attention
# kernels
# ===========================================================================

#: Attention kernels in the library, by function name (the bf16 B4, B5 and
#: B6 are the ``_mma`` ones).
ATTN_KERNELS = re.compile(r"(flash_attention_(?:fwd|dq|dkv)(?:_mma)?_kernel"
                          r"|gqa_decode_kernel)")
#: Kernels whose bf16 instantiation must run its products on the tensor
#: cores, and whose float32 one must not.
TENSOR_CORE_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                       "flash_attention_dkv")
#: B8's launches that run products, each compiled for N = 64 and 128: every
#: instantiation must run them on the tensor cores.
SSD_PRODUCT_KERNELS = ("ssd_cb_kernel", "ssd_states_kernel",
                       "ssd_output_kernel")


def hmma_by_function(lib_path: str) -> dict:
    """``{mangled function name: n}``: tensor-core instructions (``HMMA``,
    ``HGMMA``) in the SASS of each kernel of the library, from the
    toolkit's ``cuobjdump -sass``."""
    from repro_torch.kernels._build import find_nvcc

    cuobjdump = str(Path(find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = 0
        elif current is not None and re.search(r"\bH(?:G)?MMA\b", line):
            counts[current] += 1
    return counts


def tensor_core_counts(by_function: dict) -> dict:
    """``{(kernel, dtype, hd): n}`` for each attention kernel instantiation
    of :func:`hmma_by_function`'s counts."""
    counts = {}
    for name, n in by_function.items():
        m = ATTN_KERNELS.search(name)
        hd = re.search(r"Li(\d+)E", name)
        if m and hd:
            base = m.group(1)
            dtype = ("bf16" if "_mma_" in base or "bfloat16" in name
                     else "f32")
            counts[(base.replace("_mma", ""), dtype, int(hd.group(1)))] = n
    return counts


def phase_build() -> None:
    """Build the library; print ptxas's register, shared-memory and spill
    lines and each attention and SSD kernel's tensor-core instruction
    count; check that the bf16 B4, B5 and B6 have some and their float32
    versions none, and that B8's product kernels have some at N = 64 and
    128."""
    from repro_torch.kernels._build import load_library

    _, info = load_library()
    log(f"  library {info['path']} built={info['built']} in "
        f"{info['build_s']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())
    by_function = hmma_by_function(info["path"])
    counts = tensor_core_counts(by_function)
    for (base, dtype, hd), n in sorted(counts.items()):
        log(f"  SASS {base} {dtype} hd={hd}: {n} HMMA/HGMMA")
    for base in TENSOR_CORE_KERNELS:
        for dtype in ("bf16", "f32"):
            got = {hd: n for (b, d, hd), n in counts.items()
                   if b == base + "_kernel" and d == dtype}
            want_some = dtype == "bf16"
            check(sorted(got) == [32, 64, 80, 128]
                  and all((n > 0) == want_some for n in got.values()),
                  f"{base} {dtype} tensor-core instructions {got}")
    for base in SSD_PRODUCT_KERNELS:
        got = {int(m.group(1)): n for name, n in by_function.items()
               if base in name and (m := re.search(r"Li(\d+)E", name))}
        log(f"  SASS {base} N={sorted(got)}: {list(got.values())} "
            "HMMA/HGMMA")
        check(sorted(got) == [64, 128] and all(got.values()),
              f"{base} tensor-core instructions {got}")


# ===========================================================================
# phase 2: kernels vs plain versions
# ===========================================================================

def _qos_inputs(U, P, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    host = [rng.uniform(0, 1, U).astype(f32), rng.uniform(0, 10, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.integers(0, 100, U).astype(np.int32),
            rng.uniform(0, 1, P).astype(f32), rng.uniform(1, 30, P).astype(f32),
            rng.uniform(1, 30, P).astype(f32),
            rng.integers(0, 100, P).astype(np.int32)]
    return [torch.from_numpy(a).to(dev) for a in host]


def _cand_inputs(U, K, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    host = [rng.uniform(0, 1, U).astype(f32), rng.uniform(0, 10, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0, 1, (U, K)).astype(f32),
            rng.uniform(1, 30, (U, K)).astype(f32),
            rng.uniform(1, 30, (U, K)).astype(f32),
            (rng.random((U, K)) < 0.8).astype(f32)]
    return [torch.from_numpy(a).to(dev) for a in host]


def _argmax_inputs(E, P, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    v = rng.normal(size=(E, P)).astype(np.float32)   # negative benefits too
    v[:, ::3] = np.round(v[:, ::3])                  # exact ties
    m = rng.random((E, P)) < 0.5
    m[::7] = False                                   # empty rows
    return torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev)


def _argmax_edge_case(dev):
    import torch

    v = torch.tensor([[1.0, 3.0, 3.0, -2.0], [-5.0, -1.0, -9.0, -1.0],
                      [7.0, 8.0, 9.0, 10.0], [0.0, 0.0, 0.0, 0.0]],
                     device=dev)
    m = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0], [0, 1, 0, 1]],
                     dtype=torch.bool, device=dev)
    return v, m


def _topk_inputs(U, M, seed, dev, S=100, ties=False, empty_service=False):
    """Users, an impl table [S, M] (each service 1..M implementations, -1
    padded; with ``empty_service`` the last service has none) and the
    models' attributes, in topk_candidates' argument order. With ``ties``
    the model records repeat three values, so a user's QoS ties across
    implementations."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    counts = rng.integers(1, M + 1, S)
    counts[0] = M
    if empty_service:
        counts[-1] = 0
    P = int(counts.sum())
    table = np.full((S, M), -1, np.int32)
    perm = rng.permutation(P).astype(np.int32)
    start = 0
    for s, c in enumerate(counts):
        table[s, :c] = np.sort(perm[start:start + c])
        start += c
    if ties:
        base = rng.integers(0, 3, P)
        models = [np.array(v, f32)[base] for v in
                  ((0.3, 0.6, 0.9), (5.0, 15.0, 25.0), (5.0, 15.0, 25.0))]
    else:
        models = [rng.uniform(0, 1, P).astype(f32),
                  rng.uniform(1, 30, P).astype(f32),
                  rng.uniform(1, 30, P).astype(f32)]
    host = [rng.integers(0, S, U).astype(np.int32),
            rng.uniform(0, 1, U).astype(f32), rng.uniform(0, 10, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32),
            rng.uniform(0.01, 1, U).astype(f32), table] + models
    return [torch.from_numpy(a).to(dev) for a in host]


def _topk_main_inputs(inst, dev):
    """The main path's candidate-build inputs for ``inst``."""
    import numpy as np
    import torch

    from repro_torch.core import TorchInstance, impl_table_np

    ti = TorchInstance.from_pies(inst, dev)
    table = torch.from_numpy(
        impl_table_np(inst.sm_service, inst.S).astype(np.int32)).to(dev)
    return [ti.u_service, ti.u_alpha, ti.u_delta, ti.u_share_k, ti.u_share_w,
            table, ti.sm_acc, ti.sm_k, ti.sm_w]


def phase_kernels(dev, main) -> dict:
    """Each kernel vs its plain version; returns per-kernel numbers at the
    main path's shapes (``main``: the main path's instance)."""
    import torch

    from repro_torch.core import max_impls_of
    from repro_torch.kernels.qos_matrix import ops, ref

    dm = 10.0
    main_P, main_K = main.P, max_impls_of(main)
    out = {}

    # --- B1 qos_matrix -----------------------------------------------------
    # ragged shapes: U * P not a multiple of the kernel's 4-element groups,
    # P below 4, one user; the route's OMS argmax needs equal bits
    err = 0.0
    for U, P, seed in ((1, 1, 0), (37, 5, 1), (513, 257, 3), (1, 3, 5),
                       (7, 1, 6), (5, 3, 7), (1, main_P, 8),
                       (1001, main_P, 9), (U_MAIN, main_P, 4)):
        args = _qos_inputs(U, P, seed, dev)
        k = ops.qos_matrix_cuda(*args, delta_max=dm)
        p = ref.qos_matrix_ref(*args, delta_max=dm)
        torch.cuda.synchronize()
        e = float((k - p).abs().max())
        same = torch.equal(k, p)
        log(f"  qos_matrix [{U}, {P}]: max_abs_err={e:.3g}, "
            f"{'equal bits' if same else 'bits differ'}")
        check(e <= QOS_TOL, f"qos_matrix [{U}, {P}] err {e}")
        check(same, f"qos_matrix [{U}, {P}] not bit-equal to the plain "
              "version")
        err = max(err, e)
        del k, p
    ms = time_ms(lambda: ops.qos_matrix_cuda(*args, delta_max=dm))
    plain = time_ms(lambda: ref.qos_matrix_ref(*args, delta_max=dm))
    n_bytes = U * P * 4 + U * 5 * 4 + P * 4 * 4
    b, by = bound_ms(n_bytes, 18 * U * P)
    out["qos_matrix"] = dict(shape=[U, P], max_abs_err=err, ms=ms,
                             plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=None,
                             note="persistent grid, 16-byte streaming "
                                  "stores; bit-equal to the plain version")
    del args
    torch.cuda.empty_cache()

    # --- B2, the pre-gathered kernel (held, off the main path) -------------
    err = 0.0
    for U, K, seed in ((1, 1, 0), (300, 7, 1), (257, 10, 2),
                       (U_MAIN, main_K, 4)):
        args = _cand_inputs(U, K, seed, dev)
        k = ops.qos_candidates_cuda(*args, delta_max=dm)
        p = ref.qos_candidates_ref(*args, delta_max=dm)
        torch.cuda.synchronize()
        e = float((k - p).abs().max())
        log(f"  qos_candidates (pre-gathered) [{U}, {K}]: max_abs_err={e:.3g}")
        check(e <= QOS_TOL, f"qos_candidates [{U}, {K}] err {e}")
        check(not bool(k[args[7] == 0].any()), "invalid pairs must be 0")
        err = max(err, e)
    gathered_ms = time_ms(lambda: ops.qos_candidates_cuda(*args, delta_max=dm))
    log(f"  qos_candidates (pre-gathered) [{U}, {K}]: kernel "
        f"{gathered_ms:.4f} ms")
    del args

    # --- B2 on the main path: the fused candidate build ---------------------
    # cand_idx equal and cand_q bit-equal to the plain version, and two
    # calls bit-equal, at: one user and one slot, k < M, k = M, -1 padding
    # with a service that has no implementation, QoS ties at k < M, and the
    # main path's instance
    err = 0.0
    cases = [(f"[{U}, {M}] k={k}{' ' + tag if tag else ''}", k,
              _topk_inputs(U, M, seed, dev, **opts), dm)
             for U, M, k, seed, opts, tag in (
                 (1, 1, None, 0, {}, ""), (300, 7, 3, 1, {}, ""),
                 (257, 10, 10, 2, {}, ""),
                 (200, 10, 4, 3, dict(empty_service=True),
                  "(a service without implementations)"),
                 (300, 10, 4, 4, dict(ties=True), "(QoS ties)"),
                 (5003, 16, 5, 5, dict(S=4000),
                  "(table and models over shared memory: read through L2)"))]
    cases.append((f"[{main.U}, {main_K}] k={main_K} (main path)", None,
                  _topk_main_inputs(main, dev), float(main.delta_max)))
    for name, kk, args, dmax in cases:
        before = ops.LAUNCHES["qos_candidates"]
        ki, kq = ops.topk_candidates_cuda(*args, kk, delta_max=dmax)
        check(ops.LAUNCHES["qos_candidates"] == before + 1,
              f"topk_candidates {name}: one launch a build")
        pi, pq = ref.topk_candidates_ref(*args, kk, delta_max=dmax)
        ki2, kq2 = ops.topk_candidates_cuda(*args, kk, delta_max=dmax)
        torch.cuda.synchronize()
        e = float((kq - pq).abs().max()) if kq.numel() else 0.0
        same = torch.equal(ki, pi) and torch.equal(kq, pq)
        log(f"  topk_candidates {name}: cand_idx "
            f"{'equal' if torch.equal(ki, pi) else 'differs'}, cand_q "
            f"{'equal bits' if torch.equal(kq, pq) else 'bits differ'} "
            f"(max_abs_err={e:.3g}), rerun "
            f"{'bit-equal' if torch.equal(ki2, ki) and torch.equal(kq2, kq) else 'differs'}")
        check(same, f"topk_candidates {name} not equal to the plain version")
        check(torch.equal(ki2, ki) and torch.equal(kq2, kq),
              f"topk_candidates {name}: two calls differ")
        err = max(err, e)
        del ki, kq, pi, pq, ki2, kq2
    U, kk = main.U, main_K
    ms = time_ms(lambda: ops.topk_candidates_cuda(*args, delta_max=dmax))
    plain = time_ms(lambda: ref.topk_candidates_ref(*args, delta_max=dmax))
    dev_ms = device_ms_per_call(
        lambda: ops.topk_candidates_cuda(*args, delta_max=dmax),
        "topk_candidates_kernel")
    # each user's service and four attributes read once, each kept slot's
    # (index, QoS) written once; qos_pair is about 17 operations a pair
    b, by = bound_ms(20 * U + 8 * U * kk, 17 * U * kk)
    out["qos_candidates"] = dict(
        shape=[U, kk], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None, device_ms=dev_ms,
        note=f"fused candidate build (topk_candidates_kernel), one launch; "
             f"the pre-gathered qos_candidates_kernel {gathered_ms:.4f} ms "
             f"at [{U_MAIN}, {main_K}] on gathered inputs")
    log(f"  topk_candidates device time (torch.profiler, median per call): "
        f"{dev_ms} ms")
    del args

    # --- B3 greedy_argmax ---------------------------------------------------
    err = 0.0
    cases = [_argmax_edge_case(dev)] + [
        _argmax_inputs(E, P, seed, dev)
        for E, P, seed in ((1, 1, 0), (3, 33, 1), (40, 400, 3),
                           (E_MAIN, main_P, 4))]
    for v, m in cases:
        bk, ik = ops.greedy_argmax_cuda(v, m)
        bp, ip = ref.greedy_argmax_ref(v, m)
        torch.cuda.synchronize()
        check(torch.equal(ik, ip), f"greedy_argmax idx {tuple(v.shape)}")
        e = float((bk - bp).abs().max())
        log(f"  greedy_argmax {list(v.shape)}: idx exact, "
            f"max_abs_err={e:.3g}")
        check(e == 0.0, f"greedy_argmax best {tuple(v.shape)} err {e}")
        err = max(err, e)
    check(ops.greedy_argmax_cuda(*cases[0])[1].tolist() == [1, 1, -1, 1],
          "greedy_argmax ties, negatives and empty rows")
    v, m = cases[-1]
    E, P = v.shape
    ms = time_ms(lambda: ops.greedy_argmax_cuda(v, m))
    plain = time_ms(lambda: ref.greedy_argmax_ref(v, m))
    premasked = torch.where(m, v, -1e30)
    lib = time_ms(lambda: torch.max(premasked, dim=1))
    # the event times above hold the host's dispatch as much as the kernel:
    # the kernels' own device time, median per call
    dev_ms = device_ms_per_call(lambda: ops.greedy_argmax_cuda(v, m),
                                "greedy_argmax_kernel")
    lib_dev_ms = device_ms_per_call(lambda: torch.max(premasked, dim=1),
                                    "reduce")
    b, by = bound_ms(E * P * 4 + E * P + E * 8, 2 * E * P)
    out["greedy_argmax"] = dict(shape=[E, P], max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=b, bound_by=by,
                                library_ms=lib, device_ms=dev_ms,
                                library_device_ms=lib_dev_ms)
    for name, r in out.items():
        log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']}")
    log(f"  greedy_argmax device time (torch.profiler, median per call): "
        f"kernel {dev_ms} ms, torch.max's reduction {lib_dev_ms} ms")
    return out


# ===========================================================================
# phases 3–5: the main path
# ===========================================================================

def phase_main_path(dev, inst) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import (CandidateSet, TorchInstance,
                                  egp_place_sparse_torch, impl_table_np,
                                  sigma_sparse_np)
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.serving import Router
    from repro_torch.workloads import evaluate_sparse

    # the main path: one sparse tick and one dense route, counted
    router = Router(device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vals, xs = evaluate_sparse([inst], device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decision = router.route(inst, placement=xs[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    log(f"  main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    sigma, x = float(vals[0]), xs[0]
    log(f"  tick (cold) {1e3 * (t1 - t0):.1f} ms, route (cold) "
        f"{1e3 * (t2 - t1):.1f} ms, sigma={sigma!r}, "
        f"placed={int(x.sum())}")

    # the same tick with the plain versions: the same decisions
    t0 = time.perf_counter()
    pvals, pxs = evaluate_sparse([inst], device=dev, use_kernel=False)
    torch.cuda.synchronize()
    plain_tick = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(pxs[0], x), "plain tick x differs from kernel tick x")
    rel = abs(float(pvals[0]) - sigma) / sigma
    check(rel <= 1e-6, f"plain tick sigma rel diff {rel}")

    # a second kernel tick: bit-identical (fixed-order scatter sums)
    t0 = time.perf_counter()
    vals2, xs2 = evaluate_sparse([inst], device=dev)
    torch.cuda.synchronize()
    warm_tick = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(xs2[0], x), "second kernel tick x differs")
    check(float(vals2[0]) == sigma, "second kernel tick sigma differs")
    log(f"  tick warm {warm_tick:.1f} ms (plain versions {plain_tick:.1f} "
        f"ms); x identical, sigma plain rel diff {rel:.3g}, rerun bit-equal")

    # loop iterations == greedy_argmax launches; σ vs float64 host
    t0 = time.perf_counter()
    ti = TorchInstance.from_pies(inst, dev)
    table = torch.from_numpy(
        impl_table_np(inst.sm_service, inst.S).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    ops.reset_launch_counts()
    cand_idx, cand_q = ops.qos_candidates_from_instance(ti, table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x3, iters = egp_place_sparse_torch(cand_idx, cand_q, ti.u_edge,
                                       ti.sm_service, ti.sm_r, ti.R,
                                       max_iters=inst.P + 1)
    torch.cuda.synchronize()
    egp_ms = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(x3, x), "direct egp x differs")
    check(launches["greedy_argmax"] == iters == ops.LAUNCHES["greedy_argmax"],
          f"greedy_argmax launches {launches['greedy_argmax']} vs "
          f"{iters} iterations")
    cs = CandidateSet(cand_idx=cand_idx.cpu().numpy().astype(np.int64),
                      cand_q=cand_q.cpu().numpy().astype(np.float64),
                      k=int(cand_idx.shape[1]), exact=True)
    x_np = x.cpu().numpy()
    host_sigma = sigma_sparse_np(inst, x_np, cs)
    rel64 = abs(sigma - host_sigma) / host_sigma
    check(rel64 <= 1e-5, f"sigma vs float64 host rel {rel64}")
    t0 = time.perf_counter()
    cand_idx, cand_q = ops.qos_candidates_from_instance(ti, table)
    torch.cuda.synchronize()
    cand_ms = 1e3 * (time.perf_counter() - t0)
    log(f"  greedy iterations {iters} (= greedy_argmax launches); egp loop "
        f"{egp_ms:.1f} ms = {egp_ms / max(iters, 1):.3f} ms/iteration; "
        f"instance upload + impl table {upload_ms:.1f} ms; candidate build "
        f"{cand_ms:.2f} ms; sigma vs float64 host rel {rel64:.3g}")
    # the build's device work (torch.profiler): the one fused kernel and
    # nothing else, the impl table being on the card already
    before = ops.LAUNCHES["qos_candidates"]
    ops.qos_candidates_from_instance(ti, table)
    cand_launches = ops.LAUNCHES["qos_candidates"] - before
    events = device_events(
        lambda: ops.qos_candidates_from_instance(ti, table))
    cand_kernels = [n for n, _ in events
                    if not n.startswith(("Memcpy", "Memset"))]
    cand_dev_ms = sum(t for _, t in events)
    log(f"  candidate build: host {cand_ms:.3f} ms, device {cand_dev_ms:.4f} "
        f"ms, {cand_launches} launch(es); device kernels {cand_kernels}, "
        f"{len(events) - len(cand_kernels)} copies")
    check(cand_launches == 1, f"candidate build launches {cand_launches}")
    check(len(cand_kernels) == 1
          and "topk_candidates_kernel" in cand_kernels[0],
          f"candidate build device kernels {cand_kernels}")

    # where the greedy loop's device time goes (torch.profiler kernel times)
    by_kernel = device_ms_by_kernel(lambda: egp_place_sparse_torch(
        cand_idx, cand_q, ti.u_edge, ti.sm_service, ti.sm_r, ti.R,
        max_iters=inst.P + 1))
    busy = sum(by_kernel.values())
    b3_ms = sum(t for k, t in by_kernel.items() if "greedy_argmax" in k)
    log(f"  egp loop device busy {busy:.1f} ms of {egp_ms:.1f} ms wall "
        f"({100 * busy / egp_ms:.1f} %, {len(by_kernel)} kernel names); "
        f"B3 greedy_argmax {b3_ms:.3f} ms of it "
        f"({100 * b3_ms / max(busy, 1e-9):.2f} %, "
        f"{1e3 * b3_ms / max(iters, 1):.2f} us per iteration)")
    for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    del ti, cand_idx, cand_q, x3

    # phase 4: routing at full size
    route_rel = abs(decision.value - sigma) / sigma
    check(decision.assignment.shape == (inst.U,), "route assignment shape")
    check(np.isfinite(decision.expected_qos).all(), "route qos finite")
    check(route_rel <= 1e-5, f"route value vs sparse sigma rel {route_rel}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decision2 = router.route(inst, placement=x)
    torch.cuda.synchronize()
    route_warm = 1e3 * (time.perf_counter() - t0)
    check(np.array_equal(decision2.assignment, decision.assignment),
          "route is deterministic")
    log(f"  route warm {route_warm:.1f} ms; value={decision.value!r}, "
        f"rel vs sparse sigma {route_rel:.3g}, served "
        f"{int((decision.assignment >= 0).sum())}/{inst.U}")
    del decision, decision2
    torch.cuda.empty_cache()
    return dict(launches=launches, iterations=iters, sigma=sigma,
                warm_tick_ms=warm_tick, plain_tick_ms=plain_tick,
                egp_ms=egp_ms, cand_ms=cand_ms, cand_device_ms=cand_dev_ms,
                cand_launches=cand_launches, cand_kernels=cand_kernels,
                upload_ms=upload_ms,
                route_warm_ms=route_warm, loop_busy_ms=busy,
                loop_b3_ms=b3_ms)


def phase_paper_scale(dev) -> dict:
    """Paper-scale instances: the sparse tick and Router.place (EGP, AGP,
    OPT) against the host oracles; EGP's ratio to OPT is logged."""
    import numpy as np

    from repro_torch.core import (agp_np, egp_np, opt_np, qos_matrix_np,
                                  realworld_instance, sigma_np,
                                  synthetic_instance)
    from repro_torch.serving import Router
    from repro_torch.workloads import evaluate_host, evaluate_sparse

    cases = [(f"synthetic(2000, 10, seed={s})",
              synthetic_instance(2000, n_edges=10, seed=s)) for s in (0, 1, 2)]
    cases.append(("realworld(300)", realworld_instance(300)))
    ratios = {}
    for name, inst in cases:
        vals, _ = evaluate_sparse([inst], device=dev)
        host = float(evaluate_host([inst])[0])
        diff = abs(float(vals[0]) - host)
        check(diff <= 1e-4, f"{name}: sparse sigma vs host diff {diff}")
        Q = qos_matrix_np(inst)
        x_host = egp_np(inst, Q)
        x_card = Router(device=dev).place(inst)
        pdiff = abs(sigma_np(inst, x_card, Q) - sigma_np(inst, x_host, Q))
        check(pdiff <= 1e-4, f"{name}: Router.place sigma diff {pdiff}")
        log(f"  {name}: sigma card {float(vals[0])!r} host {host!r} "
            f"(diff {diff:.3g}); Router.place x "
            f"{'equal to' if np.array_equal(x_card, x_host) else 'differs from'}"
            f" host egp_np, sigma diff {pdiff:.3g}")
        s_agp = sigma_np(inst, agp_np(inst, Q), Q)
        x_card = Router(placement_algo="agp", device=dev).place(inst)
        adiff = abs(sigma_np(inst, x_card, Q) - s_agp)
        check(adiff <= 1e-4, f"{name}: Router(agp).place sigma diff {adiff}")
        t0 = time.perf_counter()
        s_opt = sigma_np(inst, opt_np(inst, Q), Q)
        opt_s = time.perf_counter() - t0
        if opt_s > OPT_HOST_LIMIT_S:
            log(f"  {name}: opt_np took {opt_s:.1f} s on the host, over "
                f"{OPT_HOST_LIMIT_S} s: dropped from the OPT check")
            continue
        x_card = Router(placement_algo="opt", device=dev).place(inst)
        odiff = abs(sigma_np(inst, x_card, Q) - s_opt)
        check(odiff <= 1e-4, f"{name}: Router(opt).place sigma diff {odiff}")
        ratios[name] = dict(egp=sigma_np(inst, x_host, Q) / s_opt,
                            agp=s_agp / s_opt)
        log(f"  {name}: Router agp sigma diff {adiff:.3g}, opt sigma diff "
            f"{odiff:.3g} (opt_np {opt_s:.2f} s on the host); EGP/OPT "
            f"{ratios[name]['egp']!r}, AGP/OPT {ratios[name]['agp']!r}")
    mean = float(np.mean([r["egp"] for r in ratios.values()]))
    log(f"  EGP/OPT over {len(ratios)} cases: mean {mean!r} (logged, not "
        "gated; the paper reports 0.904 on average)")
    return dict(opt_ratios=ratios, egp_opt_mean=mean)


def _same_x(a, b) -> bool:
    """Equal placements: tensors, or lists of them (a bucketed batch's)."""
    import torch

    if isinstance(a, list):
        return len(a) == len(b) and all(torch.equal(p, q)
                                        for p, q in zip(a, b))
    return torch.equal(a, b)


def phase_batched(dev) -> dict:
    """The dense batched path: the reference benchmark's mixed-size batch
    (benchmarks/placement_scale.py's bucket mix at U0 users) through
    evaluate_batch, bucketed and globally padded, for EGP and AGP."""
    import numpy as np
    import torch

    from repro_torch.core import synthetic_instance
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.workloads import (bucket_instances, evaluate_batch,
                                       evaluate_host, pad_instances)

    U0 = BATCH_U0
    mix = [synthetic_instance(n_users=max(8, U0 // (2 ** i)),
                              n_edges=max(4, (U0 // (2 ** i)) // 1000),
                              seed=i) for i in range(4)]
    mi = max(i.P for i in mix) + 1
    log(f"  mix (U, P, E): {[(i.U, i.P, i.E) for i in mix]}, "
        f"max_iters {mi}")
    out = {}
    for algo in ("egp", "agp"):
        t0 = time.perf_counter()
        host = evaluate_host(mix, algo)
        host_s = time.perf_counter() - t0
        for kind, make in (("bucketed", bucket_instances),
                           ("padded", pad_instances)):
            batch = make(mix, device=dev)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            vals, x = evaluate_batch(batch, algo, max_iters=mi)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = dict(ops.LAUNCHES)
            check(launches["qos_matrix"] > 0 and launches["greedy_argmax"] > 0,
                  f"batched {algo} {kind}: B1/B3 launches {launches}")
            diff = float(np.abs(vals - host).max())
            check(diff <= BATCH_ATOL,
                  f"batched {algo} {kind}: values vs host diff {diff}")
            t0 = time.perf_counter()
            pvals, px = evaluate_batch(batch, algo, max_iters=mi,
                                       use_kernel=False)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            check(_same_x(px, x), f"batched {algo} {kind}: plain x differs")
            vals2, x2 = evaluate_batch(batch, algo, max_iters=mi)
            torch.cuda.synchronize()
            check(_same_x(x2, x) and np.array_equal(vals2, vals),
                  f"batched {algo} {kind}: rerun differs")
            log(f"  evaluate_batch {algo} {kind}: {ms:.1f} ms (plain "
                f"versions {plain_ms:.1f} ms; host {1e3 * host_s:.1f} ms), "
                f"values {vals.tolist()}, max diff vs host {diff:.3g}; x "
                f"identical with the plain versions and on a rerun; "
                f"launches {launches}")
            out[f"{algo}_{kind}"] = dict(ms=ms, plain_ms=plain_ms,
                                         host_ms=1e3 * host_s, diff=diff,
                                         launches=launches)
            del batch, x, px, x2
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 13: the sweep engine
# ===========================================================================

def _span_totals(tracer) -> dict:
    """Seconds in each span name, and the items and seconds of the
    sweep.chunk spans by executor, from a tracer's snapshot."""
    doc = tracer.snapshot()
    totals, by_exec = {}, {}
    spans = doc["spans"]
    for row, (nid, t0, t1) in enumerate(zip(spans["name"], spans["t0_ns"],
                                            spans["t1_ns"])):
        name = doc["names"][nid]
        totals[name] = totals.get(name, 0.0) + (t1 - t0) / 1e9
        args = doc["span_args"].get(str(row), {})
        if name == "sweep.chunk":
            items, secs = by_exec.get(args["executor"], (0, 0.0))
            by_exec[args["executor"]] = (items + args["items"],
                                         secs + (t1 - t0) / 1e9)
    return dict(totals=totals, by_executor=by_exec)


def _sweep_check(spec, result, host_of: dict, what: str) -> float:
    """Every accelerator column of ``result`` within SWEEP_ATOL of the
    host path (``host_of[(variant, algo)]``); returns the largest
    difference."""
    import numpy as np

    worst = 0.0
    for (variant, algo), host in host_of.items():
        got = result.values[(variant, algo)].ravel()
        check(not np.isnan(got).any(), f"{what}: {variant}/{algo} incomplete")
        diff = float(np.abs(got - host).max())
        check(diff <= SWEEP_ATOL,
              f"{what}: {variant}/{algo} accel vs host diff {diff}")
        worst = max(worst, diff)
    return worst


def _host_columns(spec) -> dict:
    """egp_np/agp_np + sigma_np of every accelerator group's items."""
    from repro_torch.sweeps import materialize, variant_key
    from repro_torch.workloads import evaluate_host

    out = {}
    for (scenario, overrides, algo), items in spec.groups():
        if spec.executor_of(algo) != "accel":
            continue
        insts = materialize(scenario, overrides,
                            [(it.seed, it.tick) for it in items])
        out[(variant_key(scenario, overrides), algo)] = evaluate_host(
            insts, algo=algo)
    return out


def _same_values(a, b) -> bool:
    return a.values.keys() == b.values.keys() and all(
        a.values[k].tobytes() == b.values[k].tobytes() for k in a.values)


def phase_sweeps(dev) -> dict:
    """The port's run_sweep on the card: Fig. 3 at the paper's widths, the
    10^4-user generator, every registered scenario, resume and chunking,
    and the plain versions of B1 and B3."""
    import dataclasses

    import torch

    from repro_torch import obs
    from repro_torch.kernels.qos_matrix import ops
    from repro_torch.sweeps import (SweepSpec, envelope_for, fig3_table,
                                    materialize, run_sweep, table)
    from repro_torch.workloads import (bucket_instances, evaluate_batch,
                                       list_scenarios)

    out = {}
    accel = ("egp", "agp")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = Path(tmp)

        # --- 1. Fig. 3 at the §VI-B widths: the main path, counted --------
        fig3 = SweepSpec(scenarios=("synthetic",),
                         override_grid=({"n_users": SWEEP_FIG3_USERS},),
                         algos=("egp", "agp", "sck", "rnd", "opt"),
                         seeds=range(SWEEP_FIG3_SEEDS))
        tracer = obs.enable()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_sweep(fig3, store / "fig3", device=dev)
        torch.cuda.synchronize()
        fig3_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        log(f"  fig3 sweep: {fig3_s:.2f} s, execution {res.execution}, "
            f"launches {launches}")
        n_accel = 2 * SWEEP_FIG3_SEEDS
        check(launches["qos_matrix"] >= n_accel
              and launches["greedy_argmax"] >= n_accel,
              f"fig3 sweep: B1/B3 launches {launches} for {n_accel} items")
        check(res.complete and res.execution["backend"] == dev.type
              and res.execution["path"] == "batched",
              f"fig3 sweep execution {res.execution}")
        host = _host_columns(fig3)
        diff = _sweep_check(fig3, res, host, "fig3")
        cpu = run_sweep(fig3, device="cpu")
        for (variant, algo), vals in res.values.items():
            if fig3.executor_of(algo) == "host":
                check(vals.tobytes() == cpu.values[(variant,
                                                    algo)].tobytes(),
                      f"fig3: host column {algo} differs on a CPU run")
        variant = f"synthetic[n_users={SWEEP_FIG3_USERS}]"
        ratio = res.values[(variant, "egp")] / res.values[(variant, "opt")]
        log("  fig3_table:\n" + fig3_table(res))
        log(f"  accel vs host max diff {diff:.3g}; host columns "
            f"bit-identical to a CPU run; EGP/OPT per seed "
            f"{ratio.ravel().tolist()}, mean {float(ratio.mean())!r} "
            "(logged, not gated; the paper reports 0.904)")
        out["fig3"] = dict(s=fig3_s, launches=launches, diff=diff,
                           egp_opt_mean=float(ratio.mean()),
                           **_span_totals(tracer))

        # --- 5. the plain versions of B1 and B3: bit-identical ------------
        # the sweep's buckets (each instance's envelope, capped by the
        # row's), evaluated at once: an item's value does not depend on
        # its batch neighbours
        (overrides,) = fig3.override_grid
        insts = materialize("synthetic", overrides,
                            [(s, 0) for s in fig3.seeds])
        t0 = time.perf_counter()
        batch = bucket_instances(
            insts, cap=envelope_for("synthetic", overrides), device=dev)
        for algo in accel:
            plain, _ = evaluate_batch(batch, algo, max_iters=fig3.max_iters,
                                      use_kernel=False)
            check(plain.tobytes() == res.values[(variant, algo)].tobytes(),
                  f"fig3 {algo}: plain versions of B1/B3 differ")
        plain_s = time.perf_counter() - t0
        log(f"  fig3 accel rows with the plain versions of B1/B3: "
            f"bit-identical ({plain_s:.2f} s)")

        # --- 2. full width: 10^4 users, one-item chunks -------------------
        full = SweepSpec(scenarios=("synthetic",),
                         override_grid=({"n_users": SWEEP_FULL_USERS},),
                         algos=accel, seeds=range(SWEEP_FULL_SEEDS))
        tracer = obs.enable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_sweep(full, store / "full", device=dev)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        check(res.execution["chunks_computed"] == 2 * SWEEP_FULL_SEEDS,
              f"full width: chunks {res.execution}")
        t0 = time.perf_counter()
        host = _host_columns(full)
        host_s = time.perf_counter() - t0
        diff = _sweep_check(full, res, host, "full width")
        spans = _span_totals(tracer)
        rates = {ex: items / secs for ex, (items, secs)
                 in spans["by_executor"].items()}
        one = SweepSpec(scenarios=("synthetic",),
                        override_grid=({"n_users": SWEEP_FULL_USERS},),
                        algos=("egp",), seeds=(SWEEP_FULL_SEEDS,))
        run_sweep(one, device=dev)             # warm: its re-run is done
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        item = run_sweep(one, device=dev)
        torch.cuda.synchronize()
        one_launches = dict(ops.LAUNCHES)
        check(one_launches["qos_matrix"] == 1
              and 1 <= one_launches["greedy_argmax"] <= one.max_iters,
              f"one 10^4-user item: launches {one_launches}")
        # device time by kernel, per item, over three warm items
        reps = 3
        by_kernel = {k: v / reps for k, v in device_ms_by_kernel(
            lambda: [run_sweep(one, device=dev) for _ in range(reps)]
        ).items()}
        item_s = float(item.times[(f"synthetic[n_users="
                                   f"{SWEEP_FULL_USERS}]", "egp")][0, 0])
        b1 = sum(v for k, v in by_kernel.items() if "qos_matrix" in k)
        b3 = sum(v for k, v in by_kernel.items() if "greedy_argmax" in k)
        busy = sum(by_kernel.values())
        log(f"  full width (U={SWEEP_FULL_USERS}): {full_s:.2f} s for "
            f"{2 * SWEEP_FULL_SEEDS} items in one-item chunks, host path "
            f"{host_s:.2f} s; accel vs host max diff {diff:.3g}; items/s "
            f"by executor {rates}; span totals (s) {spans['totals']}")
        log(f"  one item: launches {one_launches} (B3 = greedy "
            f"iterations), {1e3 * item_s:.1f} ms; device busy "
            f"{busy:.2f} ms (idle {100 * (1 - busy / (1e3 * item_s)):.1f} "
            f"%; B1 {b1:.4f}, B3 {b3:.3f}); top kernels "
            f"{sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]}")
        out["full"] = dict(s=full_s, host_s=host_s, diff=diff, rates=rates,
                           one_launches=one_launches, item_ms=1e3 * item_s,
                           busy_ms=busy, b1_ms=b1, b3_ms=b3, **spans)

        # --- 3. every registered scenario at its own configuration --------
        names = tuple(list_scenarios())
        check(names == SWEEP_SCENARIOS, f"scenario registry {names}")
        scen = SweepSpec(scenarios=names, algos=accel,
                         seeds=range(SWEEP_SCENARIO_SEEDS))
        tracer = obs.enable()
        t0 = time.perf_counter()
        res = run_sweep(scen, store / "scenarios", device=dev)
        torch.cuda.synchronize()
        scen_s = time.perf_counter() - t0
        n_items = len(scen.expand())
        diff = _sweep_check(scen, res, _host_columns(scen), "scenarios")
        log(f"  every scenario ({n_items} items): {scen_s:.2f} s, accel "
            f"vs host max diff {diff:.3g}; span totals (s) "
            f"{_span_totals(tracer)['totals']}")
        log("  table:\n" + table(res))
        pairs = [(s, t) for s in range(SWEEP_SCENARIO_SEEDS)
                 for t in range(8)]
        insts = materialize("edge_failure", (), pairs)
        _, xs = evaluate_batch(bucket_instances(insts, device=dev), "egp")
        for (seed, tick), inst, x in zip(pairs, insts, xs):
            for when, edge in ((3, 1), (5, 4)):
                if tick >= when:
                    check(inst.R[edge] == 0.0
                          and not bool(x[edge].any()),
                          f"edge_failure seed {seed} tick {tick}: dead "
                          f"edge {edge} places something")
        log("  edge_failure: dead edges 1 (tick 3 on) and 4 (tick 5 on) "
            "place nothing")
        out["scenarios"] = dict(s=scen_s, items=n_items, diff=diff)

        # --- 4. resume and chunking ---------------------------------------
        rows = dataclasses.replace(scen, scenarios=("flash_crowd",
                                                    "edge_failure"))
        d = store / "resume"
        part = run_sweep(rows, d, device=dev, chunk_size=1, max_chunks=2)
        check(part.execution["chunks_computed"] == 2 and not part.complete,
              f"killed run {part.execution}")
        done = run_sweep(rows, d, device=dev)
        again = run_sweep(rows, d, device=dev)
        n_rows = len(rows.expand())
        check(done.execution["items_skipped"] == 2
              and again.execution["chunks_computed"] == 0
              and again.execution["items_skipped"] == n_rows,
              f"resume: {done.execution}, {again.execution}")
        one_shot = run_sweep(rows, store / "one_shot", device=dev)
        flat = run_sweep(rows, store / "flat", device=dev, bucketed=False)
        obs.disable()
        untraced = run_sweep(rows, store / "untraced", device=dev)
        for other, what in ((again, "the resumed store's reload"),
                            (one_shot, "a one-shot run"),
                            (flat, "a globally padded run"),
                            (untraced, "a run with tracing off")):
            check(_same_values(done, other),
                  f"resume: values differ from {what}")
        for variant_algo, vals in done.values.items():
            check(vals.tobytes() ==
                  res.values[variant_algo].tobytes(),
                  f"resume: {variant_algo} differs from part 3")
        log(f"  flash_crowd + edge_failure ({n_rows} items): killed after "
            "2 one-item chunks, resumed, a third call computed nothing; "
            "bit-identical to a one-shot run, a globally padded run, a run "
            "with tracing off and part 3")
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 6: attention kernels vs plain versions
# ===========================================================================

def _randn(shape, dtype, gen):
    import torch

    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _visible_pairs(Sq, Skv, causal, window) -> int:
    """(query, key) pairs a prefill attends: the work its data needs."""
    import numpy as np

    q = np.arange(Sq)
    hi = np.minimum(Skv, q + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def _sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention on [B, S, H, hd] tensors."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def _held_in_ulps(out, ref, what: str) -> str:
    """For bf16 outputs, check the ulp bound and return its reading for
    the log line; nothing for float32."""
    import torch

    if out.dtype != torch.bfloat16:
        return ""
    _, ulps = bf16_ulp_err(out, ref)
    check(ulps <= BF16_ULPS, f"{what} bf16 beyond {BF16_ULPS} ulps + "
          f"{BF16_ATOL} ({ulps:.3g} ulps)")
    return f" ({ulps:.3g} ulps beyond {BF16_ATOL})"


def _rates(n_ops: float, ms: float, bound: float, lib: float,
           lib_name: str = "sdpa") -> str:
    """A kernel's achieved TFLOP/s (the algorithm's operations over its
    time) and its time as a multiple of its bound and of a library call's."""
    return (f"{n_ops / ms / 1e9:.1f} TFLOP/s, {ms / bound:.2f}x its bound, "
            f"{ms / lib:.2f}x {lib_name}")


def phase_attention_kernels(dev) -> dict:
    """B4 and B7 against their plain versions; numbers at the serving
    path's shapes (bfloat16)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    # --- B4 flash attention (prefill) ----------------------------------
    # (label, B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap)
    main = ("serving", SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 15, 5, 64, True,
            0, 0.0)
    cases = [main,
             ("gemma2 width", 1, 4500, 4500, 4, 2, 128, True, 4096, 50.0),
             ("gemma2 width, global", 1, 4500, 4500, 4, 2, 128, True, 0,
              50.0),
             ("non-causal ragged", 2, 200, 333, 8, 2, 32, False, 0, 0.0),
             ("zamba2 width", SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 32, 32,
              80, True, 0, 0.0)]
    err = 0.0
    for dtype in ("float32", "bfloat16"):
        for label, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap in cases:
            dt = getattr(torch, dtype)
            q = _randn((B, Sq, Hq, hd), dt, gen)
            k = _randn((B, Skv, Hkv, hd), dt, gen)
            v = _randn((B, Skv, Hkv, hd), dt, gen)
            kw = dict(causal=causal, window=window, softcap=cap)
            o, lse = fa.flash_attention_cuda(q, k, v, **kw)
            ro, rlse = fa.attention_ref(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            e_o = float((o.float() - ro.float()).abs().max())
            e_l = float((lse - rlse).abs().max())
            ulps = _held_in_ulps(o, ro, f"flash_attention {label}")
            log(f"  flash_attention {label} {dtype} [{B},{Sq},{Skv},{Hq}/"
                f"{Hkv},{hd}] causal={causal} window={window} softcap={cap}:"
                f" max_abs_err out {e_o:.3g}{ulps}, lse {e_l:.3g}")
            check(max(e_o, e_l) <= ATTN_TOL[dtype],
                  f"flash_attention {label} {dtype} err {e_o}, {e_l}")
            err = max(err, e_o, e_l)
            del o, lse, ro, rlse
    _, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = main
    dt = torch.bfloat16
    q = _randn((B, Sq, Hq, hd), dt, gen)
    k = _randn((B, Skv, Hkv, hd), dt, gen)
    v = _randn((B, Skv, Hkv, hd), dt, gen)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain = time_ms(lambda: fa.attention_ref(q, k, v, causal=True,
                                             return_lse=True))
    lib = time_ms(lambda: _sdpa(q, k, v, is_causal=True))
    n_bytes = 2 * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd) \
        + 4 * B * Hq * Sq
    n_ops = 4 * hd * B * Hq * _visible_pairs(Sq, Skv, causal, window)
    b, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
    out["flash_attention"] = dict(
        shape=[B, Sq, Hq, Hkv, hd], max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=lib, ops=n_ops,
        note="bf16: tensor-core products (mma.sync), P split into two bf16 "
             "terms; float32: CUDA-core products")
    del q, k, v

    # --- B7 GQA decode ----------------------------------------------------
    # (label, B, Sc, Hkv, G, hd, kv_len, window, ring, softcap); besides the
    # serving shapes, the split plan's edges: rows of 1, 7, 64 and 65 slots
    # over 8 splits (empty and one-slot splits), a window narrower than 8
    # splits x 64 slots, ring past an Sc that is no multiple of 64, kv_len
    # 0 with G = 8 (two chunks of 4 heads), G = 5 at hd = 80
    main_len = (1, 7, 64, 129, 1000, 1024, 2047, 2048)[:SERVE_B]
    cases = [("serving", SERVE_B, SERVE_SEQ, 5, 3, 64, main_len, 0, False,
              0.0),
             ("ring Sc=40", 2, 40, 2, 2, 32, (50, 30), 0, True, 0.0),
             ("gemma2 width", 2, 4500, 2, 2, 128, (4500, 300), 4096, False,
              50.0),
             ("past Sc", 2, 48, 5, 3, 32, (200, 7), 0, False, 0.0),
             ("zamba2 width", SERVE_B, SERVE_SEQ, 32, 1, 80, main_len, 0,
              False, 0.0),
             ("short rows", 4, SERVE_SEQ, 5, 3, 64, (1, 7, 64, 65), 0, False,
              0.0),
             ("window 40 < splits x 64", 2, 1024, 2, 3, 64, (1000, 600), 40,
              False, 0.0),
             ("ring past Sc=300", 2, 300, 2, 3, 32, (1000, 299), 0, True,
              0.0),
             ("Sc=100, G=8", 3, 100, 1, 8, 128, (100, 37, 0), 0, False, 30.0),
             ("G=5 hd=80", 2, SERVE_SEQ, 2, 5, 80, (1040, 65), 0, False,
              0.0)]
    err = 0.0
    for dtype in ("float32", "bfloat16"):
        for label, B, Sc, Hkv, G, hd, lens, window, ring, cap in cases:
            dt = getattr(torch, dtype)
            q = _randn((B, Hkv * G, hd), dt, gen)
            kc = _randn((B, Sc, Hkv, hd), dt, gen)
            vc = _randn((B, Sc, Hkv, hd), dt, gen)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            kw = dict(window=window, ring=ring, softcap=cap)
            o = gd.gqa_decode_cuda(q, kc, vc, kv_len, **kw)
            ro = gd.gqa_decode_ref(q, kc, vc, kv_len, **kw)
            torch.cuda.synchronize()
            e = float((o.float() - ro.float()).abs().max())
            ulps = _held_in_ulps(o, ro, f"gqa_decode {label}")
            log(f"  gqa_decode {label} {dtype} [{B},{Sc},{Hkv}x{G},{hd}] "
                f"kv_len={list(lens)} window={window} ring={ring} "
                f"softcap={cap} splits="
                f"{gd.decode_splits(B, Hkv, Sc, _sm_count())}: max_abs_err "
                f"{e:.3g}{ulps}")
            check(e <= ATTN_TOL[dtype], f"gqa_decode {label} {dtype} err {e}")
            check(torch.equal(o, gd.gqa_decode_cuda(q, kc, vc, kv_len, **kw)),
                  f"gqa_decode {label} {dtype}: two calls differ")
            err = max(err, e)
    # timed where the serving paths decode: 8 rows at position 1040, at
    # smollm's and zamba2's shapes (bf16); events, and the kernel's device
    # time alone (torch.profiler), beside SDPA's
    timed = {}
    for label, Hkv, G, hd in (("smollm", 5, 3, 64), ("zamba2", 32, 1, 80)):
        B, Sc, dt = SERVE_B, SERVE_SEQ, torch.bfloat16
        lens = [SERVE_PROMPT + SERVE_STEPS // 2] * B
        q = _randn((B, Hkv * G, hd), dt, gen)
        kc = _randn((B, Sc, Hkv, hd), dt, gen)
        vc = _randn((B, Sc, Hkv, hd), dt, gen)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        idx = torch.arange(Sc, device=dev)
        mask = (idx[None, :] < kv_len[:, None])[:, None, None, :]

        def kernel():
            return gd.gqa_decode_cuda(q, kc, vc, kv_len)

        def sdpa():
            return _sdpa(q[:, None], kc, vc, attn_mask=mask)

        slots = sum(min(n, Sc) for n in lens)   # valid cache slots read
        n_bytes = 2 * (2 * B * Hkv * G * hd + 2 * slots * Hkv * hd) + 4 * B
        n_ops = 4 * hd * G * Hkv * slots
        b, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
        timed[label] = dict(
            shape=[B, Sc, Hkv, G, hd], ms=time_ms(kernel),
            device_ms=device_ms_per_call(kernel, "gqa_decode_kernel"),
            plain_ms=time_ms(lambda: gd.gqa_decode_ref(q, kc, vc, kv_len)),
            library_ms=time_ms(sdpa), library_device_ms=device_ms_total(sdpa),
            bound_ms=b, bound_by=by, ops=n_ops,
            splits=gd.decode_splits(B, Hkv, Sc, _sm_count()))
        r = timed[label]
        log(f"  gqa_decode {label} {r['shape']} bf16 kv_len {lens[0]}, "
            f"{r['splits']} splits: kernel {r['ms']:.4f} ms events, "
            f"{r['device_ms']} ms device; plain {r['plain_ms']:.4f} ms; "
            f"sdpa {r['library_ms']:.4f} ms events, "
            f"{r['library_device_ms']} ms device; bound {b:.4f} ms ({by})")
        del q, kc, vc
    main, z = timed["smollm"], timed["zamba2"]
    out["gqa_decode"] = dict(
        main, max_abs_err=err,
        note=f"{main['splits']} splits a cluster; zamba2 {z['shape']}: "
             f"{z['ms']:.4f} ms events, {z['device_ms']} ms device, bound "
             f"{z['bound_ms']:.4f}, sdpa {z['library_ms']:.4f} ms events, "
             f"{z['library_device_ms']} ms device")
    for name, r in out.items():
        log(f"  {name} {r['shape']} bf16: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), sdpa {r['library_ms']:.4f} ms; "
            f"{_rates(r['ops'], r['ms'], r['bound_ms'], r['library_ms'])}")
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 8: the SSD scan kernel vs its plain versions
# ===========================================================================

def _ssd_inputs(B, L, H, P, N, gen):
    """x, dtA, b, c drawn as tests/test_kernels.py draws them: normal x,
    b, c and dtA = -U(0.01, 0.4)."""
    import torch

    dev = gen.device
    x = torch.randn((B, L, H, P), generator=gen, device=dev)
    dtA = -(0.01 + 0.39 * torch.rand((B, L, H), generator=gen, device=dev))
    b = torch.randn((B, L, N), generator=gen, device=dev)
    c = torch.randn((B, L, N), generator=gen, device=dev)
    return x, dtA, b, c


def _ssd_err(out, ref) -> float:
    """Scale-free error of an SSD scan's ``(y, state)`` against a plain
    version's: the larger over the two of ``max |k - p| / max |p|``."""
    return max(float((k - p).abs().max() / p.abs().max().clamp_min(1e-30))
               for k, p in zip(out, ref))


def _ssd_work(B, L, H, P, N, chunk, with_init
              ) -> tuple[float, float, str]:
    """``(bytes, operations, algorithm)`` one scan needs: x, dtA, b, c (and
    the initial state) read once, y and the final state written once; and
    the operations of the cheaper of two algorithms, 2 per multiply-add:
    the chunked one, with the C.B^T scores over the visible (s <= q) pairs
    once per (row, chunk) (b and c are one group for every head), and per
    (row, head) scores.X, C.state^T and the state update; or the sequential
    recurrence, per (row, head, step) state * decay + x b^T and state.c,
    5 P N."""
    pairs = sum(q * (q + 1) // 2 for q in
                (min(chunk, L - c0) for c0 in range(0, L, chunk)))
    n_bytes = 4 * (2 * B * L * H * P + B * L * H + 2 * B * L * N
                   + (2 if with_init else 1) * B * H * P * N)
    ops = {"chunked": 2 * B * (pairs * N + H * (pairs * P + 2 * L * P * N)),
           "sequential": 5 * B * H * L * P * N}
    algo = min(ops, key=ops.get)
    return n_bytes, ops[algo], algo


def _ssd_plan_work(B, L, H, P, N, chunk, with_init
                   ) -> tuple[float, float]:
    """``(bytes, operations)`` of the work B8's four launches run: bf16
    tensor-core operations, 2 per multiply-add of every product over its
    64-row tiles (C·Bᵀ on and below the diagonal once per row and chunk;
    per head the chunk states, the scores times x and C times the entering
    state), times the 3 products of the hi/lo split; and the bytes moved,
    the scratch counted (x read twice, b and c twice, dtA twice, y and the
    final state written, C·Bᵀ, the chunk states and the entering states
    written once and read once, the initial state read)."""
    nc, n_sub = L // chunk, -(-chunk // 64)
    qp = 64 * n_sub
    tiles = n_sub * (n_sub + 1) // 2
    with_prev = nc - (0 if with_init else 1)
    macs = B * nc * (tiles * 64 * 64 * N
                     + H * (qp * P * N + tiles * 64 * 64 * P)) \
        + B * with_prev * H * qp * N * P
    n_bytes = 4 * (2 * B * L * H * P + 2 * 2 * B * L * N + 2 * B * L * H
                   + B * L * H * P + (2 if with_init else 1) * B * H * P * N
                   + 2 * B * nc * qp * qp + 2 * 2 * B * nc * H * P * N
                   + 2 * B * nc * H)
    return n_bytes, 3 * 2 * macs


def phase_ssd_kernel(dev) -> dict:
    """B8 against ssd_scan_ref and ssd_chunked; numbers at the mamba2
    serving shape."""
    import torch

    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # (label, B, L, H, P, N, chunk, initial state)
    cases = [("mamba2 serving", SERVE_B, SERVE_PROMPT, 80, 64, 128, 256,
              False),
             ("zamba2 serving", SERVE_B, SERVE_PROMPT, 80, 64, 64, 256,
              False),
             ("ragged, initial state", 1, 300, 1, 64, 128, 256, True)]
    rows, err = {}, 0.0
    for label, B, L, H, P, N, chunk, with_init in cases:
        x, dtA, b, c = _ssd_inputs(B, L, H, P, N, gen)
        s0 = torch.randn((B, H, P, N), generator=gen, device=dev) \
            if with_init else None
        kern = ss.ssd(x, dtA, b, c, chunk=chunk, initial_state=s0,
                      use_kernel=True)
        plain = {"ssd_scan_ref": ss.ssd_scan_ref(x, dtA, b, c,
                                                 initial_state=s0),
                 "ssd_chunked": ss.ssd(x, dtA, b, c, chunk=chunk,
                                       initial_state=s0, use_kernel=False)}
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kern[0]).all() and
                   torch.isfinite(kern[1]).all()), f"ssd {label} finite")
        parts = []
        for name, ref in plain.items():
            e = _ssd_err(kern, ref)
            a = max(float((k - p).abs().max()) for k, p in zip(kern, ref))
            parts.append(f"vs {name} {e:.3g} (max abs {a:.3g}, max|y| "
                         f"{float(ref[0].abs().max()):.4g}, max|state| "
                         f"{float(ref[1].abs().max()):.4g})")
            check(e <= SSD_TOL, f"ssd_scan {label} vs {name}: {e}")
            err = max(err, a)
        log(f"  ssd_scan {label} [{B},{L},{H},{P},{N}] chunk {chunk}: "
            "scale-free error " + "; ".join(parts))
        del kern, plain
        if L % chunk:
            continue
        # each launch's scratch against ssd_chunked's intermediates, and
        # two calls bit for bit (no atomics)
        got = ss.ssd_scan_cuda_steps(x, dtA, b, c, chunk=chunk,
                                     initial_state=s0)
        want = ss.ssd_chunked_steps(x, dtA, b, c, chunk, initial_state=s0)
        low = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril()
        steps = {"cb": _ssd_err(
            (got["cb"][:, :, :chunk, :chunk][:, :, low],),
            (want["cb"][:, :, low],))}
        steps.update({k: _ssd_err((got[k],), (want[k],)) for k in
                      ("chunk_states", "entering_states")})
        again = ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk, initial_state=s0)
        same = all(torch.equal(got[k], a) for k, a in
                   zip(("y", "final_state"), again))
        log("    launches' scratch vs ssd_chunked's intermediates, scale-"
            "free: " + ", ".join(f"{k} {e:.3g}" for k, e in steps.items())
            + f"; two calls bit-equal: {same}")
        check(all(e <= SSD_TOL for e in steps.values()),
              f"ssd_scan {label} intermediates {steps}")
        check(same, f"ssd_scan {label}: two calls differ")
        del got, want, again
        ms = time_ms(lambda: ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk,
                                              initial_state=s0))
        chunked = time_ms(lambda: ss.ssd_chunked(x, dtA, b, c, chunk, s0))
        seq = time_ms(lambda: ss.ssd_scan_ref(x, dtA, b, c, s0))
        n_bytes, n_ops, algo = _ssd_work(B, L, H, P, N, chunk, with_init)
        bnd, by = bound_ms(n_bytes, n_ops)
        p_bytes, p_ops = _ssd_plan_work(B, L, H, P, N, chunk, with_init)
        p_bnd, p_by = bound_ms(p_bytes, p_ops, BF16_OPS_S)
        log(f"    kernel {ms:.4f} ms, ssd_chunked {chunked:.4f} ms, "
            f"ssd_scan_ref {seq:.4f} ms, bound {bnd:.4f} ms ({by}: "
            f"{n_ops / 1e9:.2f} GFLOP {algo} at the float32 peak, "
            f"{n_bytes / 1e9:.3f} GB); the plan's bound {p_bnd:.4f} ms "
            f"({p_by}: {p_ops / 1e9:.2f} GFLOP of bf16 products at the "
            f"tensor-core peak, {p_bytes / 1e9:.3f} GB with the scratch); "
            f"kernel at {bnd / ms:.3f} of the float32 bound and "
            f"{p_bnd / ms:.3f} of the plan's")
        rows[label] = dict(shape=[B, L, H, P, N], ms=ms, plain_ms=chunked,
                           sequential_ms=seq, bound_ms=bnd, bound_by=by,
                           plan_bound_ms=p_bnd, plan_bound_by=p_by,
                           library_ms=None)
        del x, dtA, b, c
    torch.cuda.empty_cache()
    z = rows["zamba2 serving"]
    note = (f"zamba2 shape {z['shape']}: {z['ms']:.4f} ms, bound "
            f"{z['bound_ms']:.4f} ({z['bound_by']}), plan bound "
            f"{z['plan_bound_ms']:.4f} ({z['plan_bound_by']}), "
            f"ssd_chunked {z['plain_ms']:.4f}")
    return {"ssd_scan": dict(rows["mamba2 serving"], max_abs_err=err,
                             note=note)}


# ===========================================================================
# phases 7, 9, 10: serving a model at full width
# ===========================================================================

def _teacher_forced(server, toks, new_tokens, use_kernel, cfg=None):
    """Prefill logits and every decode step's logits of ``server``'s model
    (under ``cfg``, by default the server's) fed the prompt and then
    ``new_tokens`` (``[B, n]``)."""
    import torch

    from repro_torch.models import transformer as T

    cfg = cfg or server.cfg
    cache, ring = T.init_cache(cfg, toks.shape[0], server.bucket_seq,
                               toks.device)
    with torch.inference_mode():
        logits, cache = T.prefill(server.params, cfg, toks, cache, ring,
                                  use_kernel)
        out = [logits[:, :cfg.vocab_size]]
        for t in range(new_tokens.shape[1]):
            logits, cache = T.decode_step(server.params, cfg,
                                          new_tokens[:, t], cache, ring,
                                          use_kernel)
            out.append(logits[:, :cfg.vocab_size])
    return torch.stack(out, dim=1)            # [B, n + 1, V]


class _Patched:
    """Within the block, each named function of the model layers
    (``models.layers``) is ``wrap(name, function)``; each wrapper sees the
    calls in layer order."""

    def __init__(self, wrap, names):
        from repro_torch.models import layers

        self.layers, self.wrap = layers, wrap
        self.saved = {n: getattr(layers, n) for n in names}

    def __enter__(self):
        for name, fn in self.saved.items():
            setattr(self.layers, name, self.wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.layers, name, fn)


def _held_against_plain(readings: dict):
    """Run the kernel and, on the same inputs, the plain version; append
    the reading of the kernel's output to ``readings[name]`` (an SSD scan:
    ``_ssd_err``; attention: ``bf16_ulp_err``); go on with the kernel's
    output."""
    def wrap(name, fn):
        def call(*args, use_kernel=None, **kw):
            out = fn(*args, use_kernel=True, **kw)
            ref = fn(*args, use_kernel=False, **kw)
            readings.setdefault(name, []).append(
                _ssd_err(out, ref) if name == "ssd"
                else bf16_ulp_err(out, ref))
            return out
        return call
    return wrap


def _drift(a, b) -> tuple[float, float]:
    """Max abs and root-mean-square difference of two logit tensors."""
    d = a.float() - b.float()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def _round_mantissa(x, bits: int):
    """``x`` rounded to ``bits`` mantissa bits (to nearest, ties away)."""
    import torch

    drop = 23 - bits
    i = x.float().view(torch.int32)
    i = (i + (1 << (drop - 1))) & -(1 << drop)
    return i.view(torch.float32).to(x.dtype)


def _layer0_rounded(n_layers: int, bits: int):
    """The wrapped functions (run as the caller asks: the plain versions
    in a plain run), with the output of every ``n_layers``-th call — layer
    0's, in a model that calls the function once per layer — rounded to
    ``bits`` mantissa bits (``y`` of a ``(y, state)`` pair): the control of
    the bf16 end-to-end limit."""
    calls = {}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls[name] = calls.get(name, 0) + 1
            if (calls[name] - 1) % n_layers:
                return out
            if isinstance(out, tuple):
                return (_round_mantissa(out[0], bits),) + tuple(out[1:])
            return _round_mantissa(out, bits)
        return call
    return wrap


def _kernel_calls(cfg, steps: int) -> dict:
    """Calls of each kernel dispatcher in one generate (prefill + ``steps``
    decode steps): attention once per attention layer (dense) or shared-
    block application (hybrid), the SSD scan once per Mamba layer in the
    prefill and never in a decode step."""
    n_attn = {"dense": cfg.n_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1)
              }[cfg.family]
    n_mamba = 0 if cfg.family == "dense" else cfg.n_layers
    return {"attention": n_attn, "decode_attention": n_attn * steps,
            "ssd": n_mamba}


def phase_serving(dev, arch: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.serving import ModelServer

    cfg = get_config(arch)
    spec = SERVED[arch]
    t0 = time.perf_counter()
    server = ModelServer(cfg, bucket_batch=SERVE_B, bucket_seq=SERVE_SEQ,
                         seed=SEED, device=dev)
    n_params = sum(p.numel() for p in server.params.parameters())
    server.warmup()
    torch.cuda.synchronize()
    log(f"  {cfg.name} ({cfg.family}): {cfg.n_layers} layers, "
        f"d={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"hd={cfg.head_dim}, ssm {cfg.ssm_heads}x{cfg.ssm_head_dim} N="
        f"{cfg.ssm_state}, vocab {cfg.vocab_size}, {n_params} parameters "
        f"({cfg.param_dtype} master, {cfg.dtype} compute); init + warmup "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT))

    # the main path: one generate, counted
    torch.cuda.synchronize()
    for mod in (fa, gd, ss):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    tokens, prefill_s, decode_s = server.generate(prompts, SERVE_STEPS)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {**fa.LAUNCHES, **gd.LAUNCHES, **ss.LAUNCHES}
    calls = _kernel_calls(cfg, SERVE_STEPS)
    expect = {"flash_attention": calls["attention"],
              "flash_attention_dq": 0, "flash_attention_dkv": 0,
              "gqa_decode": calls["decode_attention"],
              "ssd_scan": calls["ssd"]}
    log(f"  generate launches: {launches} (expected {expect}); peak device "
        f"memory {peak_gb:.2f} GB")
    check(launches == expect, f"{arch} launches {launches} != {expect}")
    check(tokens.shape == (SERVE_B, SERVE_STEPS), "generated tokens shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "generated tokens in the vocabulary")
    new_tok_s = SERVE_B * SERVE_STEPS / decode_s
    log(f"  prefill {1e3 * prefill_s:.2f} ms ({SERVE_B}x{SERVE_PROMPT} "
        f"tokens), decode {1e3 * decode_s / SERVE_STEPS:.3f} ms/token-step "
        f"({SERVE_STEPS} steps), {new_tok_s:.1f} new tokens/s, "
        f"{SERVE_B * SERVE_STEPS / (prefill_s + decode_s):.1f} tokens/s "
        "end to end")

    # The same model with the plain versions, teacher-forced on those
    # tokens. In bf16 a kernel and its plain version compute the same
    # float32 values in different orders, so an output near a bf16
    # rounding boundary rounds to a neighbouring value, and the layers'
    # bf16 residual stream carries those ulps to the logits. So every
    # kernel call is held on its own inputs (attention at the ulp bound,
    # the SSD scan at SSD_TOL of its largest value), and the bf16 logits
    # at the model's limit, which the control must exceed.
    toks = torch.from_numpy(prompts).to(dev)
    new = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    held = {}
    with _Patched(_held_against_plain(held), KERNEL_DISPATCHERS):
        kern = _teacher_forced(server, toks, new, True)
    plain = _teacher_forced(server, toks, new, False)
    check(bool(torch.isfinite(kern).all()), "kernel logits are finite")
    check(torch.equal(kern[:, :-1].argmax(-1), new),
          "teacher-forced kernel logits pick the generated tokens")
    n_held = {n: len(r) for n, r in held.items()}
    check(n_held == {n: c for n, c in calls.items() if c},
          f"kernel calls held {n_held}, expected {calls}")
    out = dict(prefill_ms=1e3 * prefill_s, new_tokens_per_s=new_tok_s,
               peak_gb=peak_gb, held=n_held,
               launches={k: launches[k] for k, n in expect.items() if n})
    attn = held.get("attention", []) + held.get("decode_attention", [])
    if attn:
        call_err = max(r[0] for r in attn)
        call_ulps = max(r[1] for r in attn)
        log(f"  bf16, every attention call of the teacher-forced run "
            f"({len(attn)} calls) kernel vs plain on its inputs: max abs "
            f"{call_err:.3g}, max {call_ulps:.3g} ulps beyond {BF16_ATOL} "
            f"(prefill max abs "
            f"{max(r[0] for r in held['attention']):.3g})")
        check(call_ulps <= BF16_ULPS,
              f"serving attention calls beyond {BF16_ULPS} bf16 ulps + "
              f"{BF16_ATOL} ({call_ulps:.3g} ulps)")
        check(call_err <= ATTN_TOL["bfloat16"],
              f"serving attention calls kernel vs plain max abs {call_err}")
        out.update(call_err=call_err, call_ulps=call_ulps)
    if "ssd" in held:
        ssd_err = max(held["ssd"])
        log(f"  every SSD scan call of the teacher-forced run "
            f"({len(held['ssd'])} calls, float32 inputs) kernel vs plain "
            f"on its inputs: scale-free error max {ssd_err:.3g}, layer 0 "
            f"{held['ssd'][0]:.3g}")
        check(ssd_err <= SSD_TOL, f"serving ssd calls kernel vs plain "
              f"scale-free error {ssd_err}")
        out.update(ssd_call_err=ssd_err)
    drift = _drift(kern, plain)
    del kern
    controls = {}
    for bits in CONTROL_SWEEP:
        with _Patched(_layer0_rounded(cfg.n_layers, bits), spec["control"]):
            ctrl = _teacher_forced(server, toks, new, False)
        controls[bits] = _drift(ctrl, plain)
        del ctrl
    tol = spec["bf16_tol"]
    rms_tol, rms_bits = spec["bf16_rms"]
    log(f"  bf16 teacher-forced logits, kernels vs plain: max abs "
        f"{drift[0]:.4g}, rms {drift[1]:.4g} (limits {tol} max abs and "
        f"{rms_tol} rms, which the controls b={CONTROL_BITS} and "
        f"b={rms_bits} must exceed; |logits| up to "
        f"{float(plain.abs().max()):.3g}, rms "
        f"{float(plain.float().pow(2).mean().sqrt()):.4g})")
    log(f"  control, the plain model with layer 0's {spec['control'][0]} "
        "output rounded to b mantissa bits, vs plain: " + ", ".join(
            f"b={b} max abs {e[0]:.4g} rms {e[1]:.4g}"
            for b, e in controls.items()))
    check(drift[0] <= tol,
          f"bf16 serving logits kernels vs plain max abs {drift[0]}")
    check(controls[CONTROL_BITS][0] > tol,
          f"control b={CONTROL_BITS} max abs {controls[CONTROL_BITS][0]} "
          f"within the limit {tol}: it does not separate")
    check(drift[1] <= rms_tol,
          f"bf16 serving logits kernels vs plain rms {drift[1]}")
    check(controls[rms_bits][1] > rms_tol,
          f"control b={rms_bits} rms {controls[rms_bits][1]} within the "
          f"limit {rms_tol}: it does not separate")
    out.update(bf16_logits_err=drift[0], bf16_logits_rms=drift[1],
               control_err=controls[CONTROL_BITS][0],
               control_rms=controls[rms_bits][1])
    del plain
    cfg32 = cfg.with_(dtype="float32")
    kern = _teacher_forced(server, toks, new, True, cfg32)
    plain = _teacher_forced(server, toks, new, False, cfg32)
    per_step = (kern - plain).abs().amax(dim=(0, 2))
    err = float(per_step.max())
    log(f"  float32 teacher-forced logits, kernels vs plain: max abs "
        f"{err:.3g} (prefill {float(per_step[0]):.3g}, worst step "
        f"{int(per_step.argmax())}); |logits| up to "
        f"{float(kern.abs().max()):.3g}")
    check(err <= F32_LOGITS_TOL,
          f"float32 serving logits kernels vs plain max abs {err}")
    out.update(f32_logits_err=err)
    del kern, plain

    # where the time goes: device time by kernel of the prefill and of four
    # decode steps after it, against generate's wall time per step
    from repro_torch.models import transformer as T

    cache, ring = T.init_cache(cfg, SERVE_B, SERVE_SEQ, dev)
    pre = device_ms_by_kernel(
        lambda: T.prefill(server.params, cfg, toks, cache, ring))
    n_prof = 4
    dec = device_ms_by_kernel(lambda: [
        T.decode_step(server.params, cfg, new[:, t], cache, ring)
        for t in range(n_prof)])
    step_busy = sum(dec.values()) / n_prof
    step_wall = 1e3 * decode_s / SERVE_STEPS
    step_b7 = sum(t for name, t in dec.items()
                  if "gqa_decode_kernel" in name) / n_prof
    log(f"  prefill device busy {sum(pre.values()):.2f} ms of "
        f"{1e3 * prefill_s:.2f} ms wall; decode step device busy "
        f"{step_busy:.3f} ms of {step_wall:.3f} ms wall (device idle "
        f"{100 * (1 - step_busy / step_wall):.1f} %), of which B7 "
        f"{step_b7:.3f} ms")
    for label, by_kernel in (("prefill", pre), (f"{n_prof} decode steps",
                                                 dec)):
        log(f"  {label}, device ms by kernel:")
        for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {t:9.3f} ms  {name[:90]}")
    del server, cache
    torch.cuda.empty_cache()
    out.update(decode_ms_per_step=step_wall, decode_busy_ms=step_busy,
               decode_b7_ms=step_b7)
    return out


# ===========================================================================
# phase 11: the flash-attention backward kernels vs their plain version
# ===========================================================================

def _bwd_err(out, ref) -> float:
    """Max abs difference over the plain output's largest |value|, or over
    1 where that is smaller."""
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1.0))


def _bwd_work(B, Sq, Skv, Hq, Hkv, hd, causal, window, nbytes: int
              ) -> dict:
    """``{kernel: (bytes, operations)}`` of B5 and B6: each input read
    once, each output written once; 2·hd operations per visible (query,
    key) pair and product, three products for dQ (S, dP, dS·k), four for
    dK/dV (S, dP, Pᵀ·dO, dSᵀ·q)."""
    pairs = B * Hq * _visible_pairs(Sq, Skv, causal, window)
    q_side, kv_side, rows = B * Sq * Hq * hd, B * Skv * Hkv * hd, B * Hq * Sq
    return {"flash_attention_dq": (nbytes * (3 * q_side + 2 * kv_side)
                                   + 8 * rows, 6 * hd * pairs),
            "flash_attention_dkv": (nbytes * (2 * q_side + 4 * kv_side)
                                    + 8 * rows, 8 * hd * pairs)}


def phase_backward_kernels(dev) -> dict:
    """B5 and B6 against flash_attention_bwd_ref (and, in float32, torch's
    autograd through attention_ref); numbers at the training shape
    (bfloat16)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # (label, B, Sq, Skv, Hq, Hkv, hd, causal, window)
    main = ("training", TRAIN_B, TRAIN_S, TRAIN_S, 15, 5, 64, True, 0)
    cases = [main,
             ("hd = 80, G = 1", 2, 512, 512, 8, 8, 80, True, 0),
             ("window 256, hd = 128", 2, 1000, 1000, 6, 2, 128, True, 256),
             ("ragged Sq = 1000", 2, 1000, 1000, 15, 5, 64, True, 0),
             ("non-causal, Sq != Skv", 2, 300, 333, 6, 2, 32, False, 0)]
    err = {"flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    for dtype in ("float32", "bfloat16"):
        for label, B, Sq, Skv, Hq, Hkv, hd, causal, window in cases:
            dt = getattr(torch, dtype)
            q = _randn((B, Sq, Hq, hd), dt, gen)
            k = _randn((B, Skv, Hkv, hd), dt, gen)
            v = _randn((B, Skv, Hkv, hd), dt, gen)
            do = _randn((B, Sq, Hq, hd), dt, gen)
            kw = dict(causal=causal, window=window)
            o, lse = fa.flash_attention_cuda(q, k, v, **kw)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            ref = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            refs = {"plain": ref}
            if dtype == "float32":
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                out = fa.attention_ref(*leaves, **kw)
                refs["autograd"] = torch.autograd.grad(out, leaves, do)
                del leaves, out
            torch.cuda.synchronize()
            parts = []
            for name, r in refs.items():
                errs = [_bwd_err(a, b) for a, b in zip(got, r)]
                parts.append(f"vs {name}: " + ", ".join(
                    f"{n} {e:.3g}{_held_in_ulps(a, b, f'{label} {n}')}"
                    for n, e, a, b in zip(("dq", "dk", "dv"), errs, got, r)))
                if dtype == "float32":
                    check(max(errs) <= BWD_TOL,
                          f"backward {label} vs {name} err {errs}")
                err["flash_attention_dq"] = max(
                    err["flash_attention_dq"],
                    float((got[0].float() - r[0].float()).abs().max()))
                err["flash_attention_dkv"] = max(
                    err["flash_attention_dkv"], *(
                        float((a.float() - b.float()).abs().max())
                        for a, b in zip(got[1:], r[1:])))
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"backward {label} {dtype} finite")
            log(f"  backward {label} {dtype} [{B},{Sq},{Skv},{Hq}/{Hkv},"
                f"{hd}] causal={causal} window={window}: " + "; ".join(parts))
            del q, k, v, do, o, lse, got, ref, refs
    _, B, Sq, Skv, Hq, Hkv, hd, causal, window = main
    dt = torch.bfloat16
    q = _randn((B, Sq, Hq, hd), dt, gen)
    k = _randn((B, Skv, Hkv, hd), dt, gen)
    v = _randn((B, Skv, Hkv, hd), dt, gen)
    do = _randn((B, Sq, Hq, hd), dt, gen)
    o, lse = fa.flash_attention_cuda(q, k, v)
    dsum = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {"flash_attention_dq": time_ms(
              lambda: fa.flash_attention_dq_cuda(q, k, v, do, lse, dsum)),
          "flash_attention_dkv": time_ms(
              lambda: fa.flash_attention_dkv_cuda(q, k, v, do, lse, dsum))}
    plain = time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, do, lse))
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), dos,
                                              retain_graph=True))
    out = {}
    for name, (n_bytes, n_ops) in _bwd_work(B, Sq, Skv, Hq, Hkv, hd, causal,
                                            window, 2).items():
        b, by = bound_ms(n_bytes, n_ops, BF16_OPS_S)
        products = ("bf16: tensor-core products (mma.sync), Pᵀ split "
                    "into two bf16 terms and dSᵀ into three; float32: "
                    "CUDA-core products; " if name == "flash_attention_dkv"
                    else "bf16: tensor-core products (mma.sync), dS split "
                    "into two bf16 terms; float32: CUDA-core products; ")
        out[name] = dict(shape=[B, Sq, Hq, Hkv, hd], max_abs_err=err[name],
                         ms=ms[name], plain_ms=plain, bound_ms=b,
                         bound_by=by, library_ms=lib,
                         note=products + "plain_ms and library_ms time dQ, "
                              "dK and dV together (flash_attention_bwd_ref; "
                              "the backward of "
                              "scaled_dot_product_attention)")
        log(f"  {name} {out[name]['shape']} bf16: kernel {ms[name]:.4f} ms,"
            f" bound {b:.4f} ms ({by}, {n_ops / 1e9:.2f} GFLOP); plain "
            f"backward {plain:.4f} ms, sdpa backward {lib:.4f} ms (both "
            f"for dQ, dK and dV); "
            f"{_rates(n_ops, ms[name], b, lib, 'sdpa backward')}")
    both = sum(ms.values())
    log(f"  B5 + B6 {both:.4f} ms, {both / lib:.2f}x sdpa backward")
    del q, k, v, do, o, lse, dsum, qs, ks, vs, sdpa
    torch.cuda.empty_cache()
    return out


# ===========================================================================
# phase 12: training smollm-360m at full width
# ===========================================================================

@contextlib.contextmanager
def _patched_backward(wrap):
    """Within the block, the backward dispatcher the autograd Function
    calls (``flash_attention.ops.flash_attention_bwd``) is ``wrap(fn)``."""
    from repro_torch.kernels.flash_attention import ops

    saved = ops.flash_attention_bwd
    ops.flash_attention_bwd = wrap(saved)
    try:
        yield
    finally:
        ops.flash_attention_bwd = saved


def _dout_scale(grads) -> float:
    """``2**s`` for the integer ``s`` that brings the largest |value| of
    ``grads`` into [0.5, 1) (1 where they are all 0)."""
    m = max(float(t.float().abs().max()) for t in grads)
    return 2.0 ** -math.frexp(m)[1] if m > 0 else 1.0


def _held_reading(fn, args, kw, fault=None):
    """B5/B6 (``fn(*args, use_kernel=True)``, ``args`` = (q, k, v, o, do,
    lse)) against the plain version on the same inputs. Returns the
    kernels' ``(dq, dk, dv)`` and ``(max abs, ulps, scaled ulps)``: the
    largest ``bf16_ulp_err`` over the three, as they come and again with
    dO scaled by the power of two that brings the plain version's largest
    |value| into [0.5, 1). The backward is linear in dO (o and lse are
    fixed, D = rowsum(dO∘O) is linear too), so the scaled outputs are the
    unscaled ones times that power, exactly, and the BF16_ATOL floor no
    longer hides their ulps where the gradients are small. ``fault``, if
    given, is applied to the kernels' dq before it is read: the control."""
    def pair(a):
        out = list(fn(*a, use_kernel=True, **kw))
        if fault is not None:
            out[0] = fault(out[0])
        return out, fn(*a, use_kernel=False, **kw)

    out, ref = pair(args)
    errs = [bf16_ulp_err(a, b) for a, b in zip(out, ref)]
    q, k, v, o, do, lse = args
    out_s, ref_s = pair((q, k, v, o, do * _dout_scale(ref), lse))
    scaled = max(bf16_ulp_err(a, b)[1] for a, b in zip(out_s, ref_s))
    return tuple(out), (max(e[0] for e in errs), max(e[1] for e in errs),
                        scaled)


def _bwd_held(readings: list, first: list):
    """Run B5/B6 and the plain version on the same inputs; append each
    call's ``_held_reading``; keep the first call's ``(fn, args, kw)`` in
    ``first`` (for the control); go on with the kernels' gradients."""
    def wrap(fn):
        def call(*args, use_kernel=None, **kw):
            if not first:
                first.append((fn, args, kw))
            out, reading = _held_reading(fn, args, kw)
            readings.append(reading)
            return out
        return call
    return wrap


def _dq_rounded(n_layers: int, bits: int):
    """The backward as asked, with layer 0's dQ (the last of each step's
    ``n_layers`` calls: the backward runs from the last layer) rounded to
    ``bits`` mantissa bits: the control of the gradient check."""
    calls = [0]

    def wrap(fn):
        def call(*args, **kw):
            dq, dk, dv = fn(*args, **kw)
            calls[0] += 1
            if calls[0] % n_layers == 0:
                dq = _round_mantissa(dq, bits)
            return dq, dk, dv
        return call
    return wrap


def _grads_of(model, cfg, batch, use_kernel) -> dict:
    """``{name: gradient}`` of the loss (a copy), and the loss."""
    from repro_torch.models import transformer as T

    for p in model.parameters():
        p.grad = None
    loss = T.loss_fn(model, cfg, batch, use_kernel)
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _leaf_err(a: dict, b: dict) -> tuple[float, str]:
    """The worst leaf's max abs difference over its largest |value|."""
    errs = {n: float((a[n] - b[n]).abs().max()
                     / b[n].abs().max().clamp_min(1e-30)) for n in b}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _train_batch(pipe, step: int, dev) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(dev)
            for k, v in pipe.batch_at(step).items()}


def _resume_check(dev) -> dict:
    """At full width and RESUME_LAYERS layers, with deterministic
    algorithms: 4 straight steps against 2 steps, a CheckpointManager save,
    a restore into a differently seeded state, and 2 more steps."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)

    cfg = get_config("smollm_360m").with_(n_layers=RESUME_LAYERS, remat=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    step_fn = make_train_step(cfg, opt)

    def fresh(seed):
        return init_train_state(cfg, opt, torch.Generator(device=dev)
                                .manual_seed(seed))

    torch.use_deterministic_algorithms(True)
    try:
        straight = fresh(SEED)
        for s in range(4):
            straight, _ = step_fn(straight, _train_batch(pipe, s, dev))
        state = fresh(SEED)
        for s in range(2):
            state, _ = step_fn(state, _train_batch(pipe, s, dev))
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            mgr = CheckpointManager(d, keep=3, every=2)
            t0 = time.perf_counter()
            check(mgr.maybe_save(2, state), "checkpoint at step 2")
            copy_s = time.perf_counter() - t0
            mgr.wait()
            save_s = time.perf_counter() - t0
            del state
            start, state = mgr.restore_latest(fresh(SEED + 1))
        check(start == 2, f"resumed from step {start}")
        for s in range(2, 4):
            state, _ = step_fn(state, _train_batch(pipe, s, dev))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    a = dict(straight.params.named_parameters())
    b = dict(state.params.named_parameters())
    differ = [f"param {n}" for n in a if not torch.equal(a[n], b[n])]
    for which in ("m", "v"):
        ta, tb = getattr(straight.opt, which), getattr(state.opt, which)
        differ += [f"{which} {n}" for n in ta if not torch.equal(ta[n],
                                                                tb[n])]
    check(int(straight.opt.step) == int(state.opt.step) == 4, "Adam step")
    check(not differ, f"resume not bitwise: {differ[:5]}")
    log(f"  resume at {RESUME_LAYERS} layers: 4 straight steps bitwise "
        f"equal to 2 + save + restore + 2 on all {len(a)} parameters and "
        f"their Adam moments (host copy {copy_s:.2f} s, save "
        f"{save_s:.2f} s)")
    return dict(resume_leaves=3 * len(a) + 1)


def phase_training(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.train import run_training
    from repro_torch.models import transformer as T
    from repro_torch.training import AdamWConfig, make_train_step

    cfg = get_config("smollm_360m").with_(remat=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for mod in (fa, gd, ss):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = run_training(arch="smollm_360m", preset="full", steps=TRAIN_STEPS,
                       global_batch=TRAIN_B, seq_len=TRAIN_S, seed=SEED,
                       lr=TRAIN_LR, verbose=False, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = {**fa.LAUNCHES, **gd.LAUNCHES, **ss.LAUNCHES}
    per_step = {"flash_attention": 2 * cfg.n_layers,     # forward + remat
                "flash_attention_dq": cfg.n_layers,
                "flash_attention_dkv": cfg.n_layers,
                "gqa_decode": 0, "ssd_scan": 0}
    expect = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"  run_training launches over {TRAIN_STEPS} steps: {launches} "
        f"(expected {expect})")
    check(launches == expect, f"training launches {launches} != {expect}")
    losses = run["losses"]
    check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
          f"training losses finite: {losses}")
    log("  losses " + ", ".join(f"{x:.4f}" for x in losses))
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    model = run["state"].params
    n_params = sum(p.numel() for p in model.parameters())
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(p.grad.any())]
    check(not bad, f"parameters without a gradient: {bad[:5]}")
    step_ms = 1e3 * statistics.median(run["step_s"][1:])
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{n_params} parameters, remat, lr {TRAIN_LR}")
    log(f"  step ms {', '.join(f'{1e3 * s:.1f}' for s in run['step_s'])} "
        f"(first is warm-up); median {step_ms:.2f} ms, {tok_s:.0f} "
        f"tokens/s; peak device memory {peak_gb:.2f} GB; run_training "
        f"{total_s:.1f} s with init; every parameter has a nonzero "
        "gradient")

    # every B5/B6 call of one step held against the plain version
    pipe = TokenPipeline(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                         seed=SEED)
    batch = _train_batch(pipe, TRAIN_STEPS, dev)
    held, first = [], []
    with _patched_backward(_bwd_held(held, first)):
        _grads_of(model, cfg, batch, None)
    check(len(held) == cfg.n_layers, f"held {len(held)} backward calls")
    call_err, call_ulps, call_scaled = (max(h[i] for h in held)
                                        for i in range(3))
    with torch.no_grad():
        _, ctrl_call = _held_reading(*first[0], fault=lambda dq:
                                     _round_mantissa(dq, CALL_CONTROL_BITS))
    del first
    log(f"  bf16, every B5/B6 call of one step ({len(held)} calls) vs the "
        f"plain version on its inputs: max abs {call_err:.3g}, max "
        f"{call_ulps:.3g} ulps beyond {BF16_ATOL}; with dO scaled so that "
        f"the largest gradient is in [0.5, 1): max {call_scaled:.3g} ulps "
        f"(per call: {', '.join(f'{h[2]:.3g}' for h in held)}); control "
        f"(the first call's dq at {CALL_CONTROL_BITS} mantissa bits): "
        f"{ctrl_call[1]:.3g} ulps, scaled {ctrl_call[2]:.3g}")
    check(call_ulps <= BF16_ULPS, f"training backward calls beyond "
          f"{BF16_ULPS} bf16 ulps + {BF16_ATOL} ({call_ulps:.3g})")
    check(call_scaled <= BF16_ULPS, f"training backward calls at scaled dO "
          f"beyond {BF16_ULPS} bf16 ulps + {BF16_ATOL} ({call_scaled:.3g})")
    check(ctrl_call[2] > BF16_ULPS, f"backward call control at scaled dO "
          f"within {BF16_ULPS} bf16 ulps ({ctrl_call[2]:.3g})")

    # where one step's device time goes
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=10)
    step_fn = make_train_step(cfg, opt)
    state = run["state"]
    batch = _train_batch(pipe, TRAIN_STEPS + 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    by_kernel = device_ms_by_kernel(lambda: step_fn(state, batch))
    prof_wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(by_kernel.values())
    ours = {name: sum(t for k, t in by_kernel.items() if kern in k)
            for name, kern in (("B4", "flash_attention_fwd_"),
                               ("B5", "flash_attention_dq_"),
                               ("B6", "flash_attention_dkv_"))}
    n_calls = dict(zip(ours, (per_step["flash_attention"],
                              per_step["flash_attention_dq"],
                              per_step["flash_attention_dkv"])))
    log(f"  one step under the profiler: device busy {busy:.2f} ms, "
        f"{100 * busy / step_ms:.1f} % of the median step {step_ms:.2f} ms "
        f"(the profiled step took {prof_wall:.0f} ms with the profiler's "
        "own cost); device ms per step "
        + ", ".join(f"{k} {t:.2f} ms ({100 * t / busy:.1f} %, "
                    f"{n_calls[k]} x {t / n_calls[k]:.3f} ms)"
                    for k, t in ours.items()))
    gemm = sum(t for k, t in by_kernel.items()
               if any(g in k.lower() for g in ("nvjet", "gemm", "xmma",
                                               "cutlass")))
    log(f"  of the device time: B4-B6 {sum(ours.values()):.2f} ms, GEMMs "
        f"{gemm:.2f} ms, everything else (elementwise, casts, reductions, "
        f"the optimizer) {busy - sum(ours.values()) - gemm:.2f} ms, over "
        f"{len(by_kernel)} kernel names")
    for name, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    del run, state, model, batch
    torch.cuda.empty_cache()

    # float32 gradients: kernels vs plain, and the control
    cfg32 = cfg.with_(dtype="float32")
    model = T.init_params(cfg32, torch.Generator(device=dev)
                          .manual_seed(SEED))
    batch = _train_batch(TokenPipeline(cfg32, global_batch=GRAD_B,
                                       seq_len=GRAD_S, seed=SEED), 0, dev)
    g_kern = _grads_of(model, cfg32, batch, None)
    g_plain = _grads_of(model, cfg32, batch, False)
    err, worst = _leaf_err(g_kern, g_plain)
    del g_kern
    with _patched_backward(_dq_rounded(cfg.n_layers, GRAD_CONTROL_BITS)):
        g_ctrl = _grads_of(model, cfg32, batch, False)
    ctrl, ctrl_worst = _leaf_err(g_ctrl, g_plain)
    log(f"  float32 gradients of a {GRAD_B}x{GRAD_S}-token step, kernels "
        f"vs plain: worst leaf {err:.3g} of its largest value ({worst}); "
        f"control (layer 0's dQ at {GRAD_CONTROL_BITS} mantissa bits) "
        f"{ctrl:.3g} ({ctrl_worst}); limit {GRAD_TOL}")
    check(err <= GRAD_TOL, f"float32 gradients kernels vs plain {err}")
    check(ctrl > GRAD_TOL, f"gradient control {ctrl} within {GRAD_TOL}")
    del model, g_plain, g_ctrl, batch
    torch.cuda.empty_cache()

    out = dict(step_ms=step_ms, tokens_per_s=tok_s, peak_gb=peak_gb,
               busy_share=busy / step_ms, launches=launches,
               call_ulps=call_ulps, call_ulps_scaled=call_scaled,
               call_control_scaled=ctrl_call[2], grad_err=err,
               grad_control=ctrl,
               losses=losses)
    out.update(_resume_check(dev))
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS reads this when its first handle is made: deterministic
    # products for the bitwise resume check of phase 12
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.core import max_impls_of, synthetic_instance

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    phase_build()

    t0 = time.perf_counter()
    inst = synthetic_instance(U_MAIN, n_edges=E_MAIN, seed=SEED)
    P, K = inst.P, max_impls_of(inst)
    log(f"  main-path instance U={inst.U} E={inst.E} P={P} S={inst.S} "
        f"M={K} ({time.perf_counter() - t0:.2f} s on the host)")

    log("phase 2: kernels vs plain versions")
    kern = phase_kernels(dev, inst)

    log(f"phase 3/4: main path at U={U_MAIN}, E={E_MAIN}")
    main_path = phase_main_path(dev, inst)

    log("phase 5: paper scale vs host oracle; the dense batched path")
    phase_paper_scale(dev)
    phase_batched(dev)

    log("phase 6: attention kernels vs plain versions")
    kern.update(phase_attention_kernels(dev))

    def serve(phase: int, arch: str) -> dict:
        log(f"phase {phase}: serving {arch}, {SERVE_B} prompts x "
            f"{SERVE_PROMPT} tokens, {SERVE_STEPS} new tokens")
        return phase_serving(dev, arch)

    served = {"smollm_360m": serve(7, "smollm_360m")}
    log("phase 8: SSD scan kernel vs plain versions")
    kern.update(phase_ssd_kernel(dev))
    served.update(mamba2_2p7b=serve(9, "mamba2_2p7b"),
                  zamba2_2p7b=serve(10, "zamba2_2p7b"))
    log("phase 11: flash-attention backward kernels vs plain versions")
    kern.update(phase_backward_kernels(dev))
    log(f"phase 12: training smollm_360m, {TRAIN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_S} tokens")
    trained = phase_training(dev)
    log("phase 13: the sweep engine (repro_torch.sweeps) at the paper's "
        "widths")
    t13 = time.perf_counter()
    swept = phase_sweeps(dev)
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s; chip_smoke so "
        f"far {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on its slice's main path: B4/B7 serving
    # smollm-360m, B8 serving mamba2-2.7b, B5/B6 training smollm-360m
    launches = {**main_path["launches"],
                **served["smollm_360m"]["launches"],
                **served["mamba2_2p7b"]["launches"],
                **{k: trained["launches"][k]
                   for k in ("flash_attention_dq", "flash_attention_dkv")}}

    log(card)
    rows = [dict(name=name, route="cuda", source=SOURCE[name],
                 replaces=REPLACES[name], launches=launches[name],
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 shape=r["shape"], **{k: r[k] for k in EXTRA_KEYS if k in r})
            for name, r in kern.items()]
    for row in rows:
        if row["name"] in ("qos_matrix", "greedy_argmax"):
            row["sweep_launches"] = swept["fig3"]["launches"][row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
