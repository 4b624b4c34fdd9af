#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits nonzero, no result):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of the kernel library from src/repro_torch/csrc;
2. every CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged small shapes, with its time, the plain
   version's time, its bound and, where one exists, a PyTorch call's time;
3. the main path at full size: a 1,000,000-user, 1,000-edge instance
   through evaluate_sparse (kernels) and Router.route (dense QoS kernel +
   OMS), with launch counts; then the same tick with the plain versions
   (same x), a second kernel tick (bit-identical), and σ against a float64
   host evaluation;
4. the routed value against the sparse σ;
5. paper-scale instances against the host oracle (egp_np + sigma_np).

It prints a JSON line of per-kernel numbers and, last, the device line
``{"ok": true, "device": {...}}``. It needs the repository around it and
exits nonzero where torch sees no CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Main-path scale (the §VI-B catalog: 100 services, ≤ 10 implementations).
U_MAIN, E_MAIN, SEED = 1_000_000, 1000, 0
#: H100 SXM peaks (data sheet): HBM bytes/s and non-tensor-core f32 op/s.
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
REPS = 25
QOS_TOL = 1e-6
SOURCE = "src/repro_torch/csrc/qos_kernels.cu"
REPLACES = {
    "qos_matrix": "src/repro/kernels/qos_matrix/qos_matrix.py:120",
    "qos_candidates": "src/repro/kernels/qos_matrix/qos_matrix.py:190",
    "greedy_argmax": "src/repro/kernels/qos_matrix/qos_matrix.py:244",
}


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


def phase_kernels(dev, main_P: int, main_K: int) -> dict:
    """Each kernel vs its plain version; returns per-kernel numbers at the
    main path's shapes."""
    import torch

    from repro_torch.kernels.qos_matrix import ops, ref

    dm = 10.0
    out = {}

    # --- B1 qos_matrix -----------------------------------------------------
    err = 0.0
    for U, P, seed in ((1, 1, 0), (37, 5, 1), (513, 257, 3),
                       (U_MAIN, main_P, 4)):
        args = _qos_inputs(U, P, seed, dev)
        k = ops.qos_matrix_cuda(*args, delta_max=dm)
        p = ref.qos_matrix_ref(*args, delta_max=dm)
        torch.cuda.synchronize()
        e = float((k - p).abs().max())
        log(f"  qos_matrix [{U}, {P}]: max_abs_err={e:.3g}")
        check(e <= QOS_TOL, f"qos_matrix [{U}, {P}] err {e}")
        err = max(err, e)
        del k, p
    ms = time_ms(lambda: ops.qos_matrix_cuda(*args, delta_max=dm))
    plain = time_ms(lambda: ref.qos_matrix_ref(*args, delta_max=dm))
    n_bytes = U * P * 4 + U * 5 * 4 + P * 4 * 4
    b, by = bound_ms(n_bytes, 18 * U * P)
    out["qos_matrix"] = dict(shape=[U, P], max_abs_err=err, ms=ms,
                             plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=None)
    del args
    torch.cuda.empty_cache()

    # --- B2 qos_candidates --------------------------------------------------
    err = 0.0
    for U, K, seed in ((1, 1, 0), (300, 7, 1), (257, 10, 2),
                       (U_MAIN, main_K, 4)):
        args = _cand_inputs(U, K, seed, dev)
        k = ops.qos_candidates_cuda(*args, delta_max=dm)
        p = ref.qos_candidates_ref(*args, delta_max=dm)
        torch.cuda.synchronize()
        e = float((k - p).abs().max())
        log(f"  qos_candidates [{U}, {K}]: max_abs_err={e:.3g}")
        check(e <= QOS_TOL, f"qos_candidates [{U}, {K}] err {e}")
        check(not bool(k[args[7] == 0].any()), "invalid pairs must be 0")
        err = max(err, e)
    ms = time_ms(lambda: ops.qos_candidates_cuda(*args, delta_max=dm))
    plain = time_ms(lambda: ref.qos_candidates_ref(*args, delta_max=dm))
    b, by = bound_ms(16 * U + 20 * U * K, 17 * U * K)
    out["qos_candidates"] = dict(shape=[U, K], max_abs_err=err, ms=ms,
                                 plain_ms=plain, bound_ms=b, bound_by=by,
                                 library_ms=None)
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
    b, by = bound_ms(E * P * 4 + E * P + E * 8, 2 * E * P)
    out["greedy_argmax"] = dict(shape=[E, P], max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=b, bound_by=by,
                                library_ms=lib)
    for name, r in out.items():
        log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']}")
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
    table = impl_table_np(inst.sm_service, inst.S)
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

    # where the greedy loop's device time goes (torch.profiler kernel times)
    by_kernel = device_ms_by_kernel(lambda: egp_place_sparse_torch(
        cand_idx, cand_q, ti.u_edge, ti.sm_service, ti.sm_r, ti.R,
        max_iters=inst.P + 1))
    busy = sum(by_kernel.values())
    log(f"  egp loop device busy {busy:.1f} ms of {egp_ms:.1f} ms wall "
        f"({100 * busy / egp_ms:.1f} %, {len(by_kernel)} kernel names)")
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
                egp_ms=egp_ms, cand_ms=cand_ms, upload_ms=upload_ms,
                route_warm_ms=route_warm)


def phase_paper_scale(dev) -> None:
    import numpy as np

    from repro_torch.core import (egp_np, qos_matrix_np, realworld_instance,
                                  sigma_np, synthetic_instance)
    from repro_torch.serving import Router
    from repro_torch.workloads import evaluate_host, evaluate_sparse

    cases = [(f"synthetic(2000, 10, seed={s})",
              synthetic_instance(2000, n_edges=10, seed=s)) for s in (0, 1, 2)]
    cases.append(("realworld(300)", realworld_instance(300)))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import max_impls_of, synthetic_instance
    from repro_torch.kernels._build import load_library

    dev = torch.device("cuda")
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
    _, info = load_library()
    log(f"  library {info['path']} built={info['built']} in "
        f"{info['build_s']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    t0 = time.perf_counter()
    inst = synthetic_instance(U_MAIN, n_edges=E_MAIN, seed=SEED)
    P, K = inst.P, max_impls_of(inst)
    log(f"  main-path instance U={inst.U} E={inst.E} P={P} S={inst.S} "
        f"M={K} ({time.perf_counter() - t0:.2f} s on the host)")

    log("phase 2: kernels vs plain versions")
    kern = phase_kernels(dev, main_P=P, main_K=K)

    log(f"phase 3/4: main path at U={U_MAIN}, E={E_MAIN}")
    main_path = phase_main_path(dev, inst)

    log("phase 5: paper scale vs host oracle")
    phase_paper_scale(dev)

    log(card)
    rows = [dict(name=name, route="cuda", source=SOURCE,
                 replaces=REPLACES[name],
                 launches=main_path["launches"][name],
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 shape=r["shape"])
            for name, r in kern.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
