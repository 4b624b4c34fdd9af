"""Training traffic: the port's training step (``make_train_step``) on a
state holding the benchmark's weights, fed a new seeded batch a step.

Set-up builds the state and the step and drives them through the first
``check_steps`` steps (the warm-up of the step's one shape), recording the
losses, the first gradient as AdamW took it (from its first moment after
one step) and each parameter's change over those steps. The window then
runs further steps of the same object until ``--seconds`` have passed:
its throughput is every token of
every step over the time from the first step's start to the last one's
end. A traced run then goes on under the profiler: one step, and
``trace_steps`` steps in the traced window. After that the program's state
is freed and the plain reference follows the first steps from the same
weights and batches.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from bench import checks, feed, port, weights as W
from bench.reference import adamw as RA
from bench.reference import model as R
from bench.tracing import profiled, window_range


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _norms(tensors: dict, scale: float = 1.0) -> dict:
    names = list(tensors)
    vals = torch.stack([t.detach().float().norm() for t in tensors.values()])
    return {n: float(v) * scale for n, v in zip(names, vals.cpu().tolist())}


def _change(params: dict, wts: W.Weights) -> dict:
    out = {}
    for n, p in params.items():
        out[n] = (p.detach() - wts.leaf(n)).norm()
    wts.forget()
    vals = torch.stack(list(out.values())).cpu().tolist()
    return dict(zip(out, vals))


def run(ctx) -> dict:
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.trainer import (TrainState, make_train_step,
                                              param_tree)

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, S, V = tr["batch"], tr["seq_len"], cfg["vocab_size"]
    opt = tr["optimizer"]
    mc = port.model_config(cfg)
    wts = W.Weights(cfg, ctx.seed, dev)
    model = port.build_model(mc, wts.make())
    opt_cfg = AdamWConfig(**opt, state_dtype=cfg["opt_state_dtype"])
    state = TrainState(model, adamw_init(param_tree(model), opt_cfg))
    step = make_train_step(mc, opt_cfg)

    # the first steps: the warm-up, and what the reference will follow
    booked = 0.0
    prog = {"losses": []}
    for k in range(1, tr["check_steps"] + 1):
        state, met = step(state, feed.train_batch(ctx.seed, k, B, S, V, dev))
        _sync(dev)
        t = time.perf_counter()
        prog["losses"].append(float(met["loss"]))
        if k == 1:
            prog["grad_norms"] = _norms(state.opt.m, 1 / (1 - opt["b1"]))
        booked += time.perf_counter() - t
    t = time.perf_counter()
    prog["change_norms"] = _change(param_tree(model), wts)
    booked += time.perf_counter() - t
    del met
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start - booked
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # the window
    k = tr["check_steps"]
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    while True:
        k += 1
        state, met = step(state, feed.train_batch(ctx.seed, k, B, S, V, dev))
        losses.append(met["loss"])
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    _sync(dev)
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if ctx.trace:
        with profiled(True) as trace:
            # one step under the profiler before the traced steps, so that
            # its start-up falls outside them
            for traced in (False, True):
                with window_range() if traced else contextlib.nullcontext():
                    for _ in range(tr["trace_steps"] if traced else 1):
                        k += 1
                        state, met = step(state, feed.train_batch(
                            ctx.seed, k, B, S, V, dev))
                    _sync(dev)
    losses = [float(l) for l in losses]
    failed = sum(not math.isfinite(l) for l in losses)
    window_s = t1 - t0
    del state, model, step, met
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(cfg, tr, ctx.seed, dev)
    numbers, where = checks.train_numbers(prog, ref)
    out = {"setup_s": setup_s,
           "e2e": {"train_tokens_per_s": len(losses) * B * S / window_s},
           "record": {"steps": len(losses), "window_s": window_s,
                      "batch": B, "seq_len": S,
                      "traced": {"steps": tr["trace_steps"]
                                 if ctx.trace else 0}},
           "trace": trace, "numbers": numbers, "where": where,
           "attempted": len(losses), "failed": failed,
           "memory_peak_bytes": peak,
           "readings": {"program": prog, "reference": ref}}
    if ctx.control:
        out["control"] = {
            name: checks.train_numbers(
                reference_steps(cfg, tr, ctx.seed, dev, **kw), ref)[0]
            for name, kw in (("fp8", {"fp8": True}),
                             ("half_batch", {"half": True}))}
    return out


def reference_steps(cfg: dict, tr: dict, seed: int, dev, *,
                    fp8: bool = False, half: bool = False) -> dict:
    """The plain reference through the first ``check_steps`` steps from
    the benchmark's weights and batches: the losses, the first clipped
    gradient's norm and each parameter's change, by leaf. ``fp8`` runs it
    as the control; ``half`` leaves half of each batch out (a fault)."""
    B, S, V = tr["batch"], tr["seq_len"], cfg["vocab_size"]
    rows = B // 2 if half else B
    wts = W.Weights(cfg, seed, dev)
    params = {n: t.detach().requires_grad_() for n, t in wts.make().items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"losses": []}
    with R.float32_matmuls():
        for k in range(1, tr["check_steps"] + 1):
            batch = feed.train_batch(seed, k, B, S, V, dev)
            loss = R.loss(params, cfg, batch["tokens"][:rows],
                          batch["targets"][:rows], fp8)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            norms = RA.step(params, grads, m, v, k, tr["optimizer"])
            for p in params.values():
                p.grad = None
            del grads
            out["losses"].append(float(loss.detach()))
            if k == 1:
                out["grad_norms"] = norms
    del m, v
    out["change_norms"] = _change(params, wts)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
