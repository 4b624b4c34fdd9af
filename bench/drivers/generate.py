"""Serving traffic: greedy ``ModelServer.generate`` calls of the port,
the model holding the benchmark's weights, offered at a fixed rate.

Call ``i`` is due ``i / calls_per_s`` seconds after the window opens and
holds ``batch`` seeded prompts of one length (``prompt_lens`` in turn,
the seed choosing where the cycle starts) for ``new_tokens`` tokens; the server
takes the calls in order, one at a time, each when it is due or when the
one before has returned. Set-up warms one call of every prompt length.

``judge: throughput`` (offered above capacity, so the server never
waits): calls start until ``--seconds`` have passed, and the rate is the
generated tokens of every call over the time from the first call's start
to the last one's end. ``judge: latency`` (below capacity): every call due
inside the window is served, and each request's latency runs from its
call's due time to the return of its tokens. A traced run then goes on
under the profiler: one call, and ``trace_calls`` calls back to back in
the traced window. Host-clock readings come from the window, device
readings from the traced calls.

After the window the program is freed, and the plain reference reads a
seeded sample of the served requests (``check_rows``, the longest prompt
length among them): its logits over each prompt and the tokens served
before each position, and the widest gap by which a served token lies
below its best.
"""
from __future__ import annotations

import gc
import itertools
import math
import time

import numpy as np
import torch

from bench import checks, feed, port, weights as W
from bench.reference import model as R
from bench.tracing import call_range, profiled, window_range

#: Rows of one reference forward.
REF_ROWS = 8


def run(ctx) -> dict:
    from repro_torch.serving.engine import ModelServer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, V, n_new = tr["batch"], cfg["vocab_size"], tr["new_tokens"]
    mc = port.model_config(cfg)
    model = port.build_model(mc, W.Weights(cfg, ctx.seed, dev).make())
    server = ModelServer(mc, params=model, bucket_batch=B,
                         bucket_seq=tr["bucket_seq"], device=dev)
    for L in sorted(set(tr["prompt_lens"])):
        warm = feed.prompts(ctx.seed, -1 - L, B, L, V)
        server.generate(warm, n_steps=min(n_new, 2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t_start

    calls = window(ctx, server, B, V, n_new)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace, traced = None, None
    if ctx.trace:
        with profiled(True) as trace:
            # a short call under the profiler before the traced calls, so
            # that its start-up falls outside them
            L = tr["prompt_lens"][0]
            server.generate(feed.prompts(ctx.seed, -1, B, L, V),
                            n_steps=min(n_new, 2))
            with window_range():
                traced = []
                for i in range(tr["trace_calls"]):
                    L = feed.length(ctx.seed, tr["prompt_lens"], i)
                    with call_range(True):
                        server.generate(feed.prompts(ctx.seed, i, B, L, V),
                                        n_steps=n_new)
                    traced.append({"len": L})
    del server, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    span = calls[-1]["end"] - calls[0]["start"]
    e2e = {"output_tokens_per_s": sum(c["tokens"].size for c in calls) / span}
    lat = sorted(1e3 * (c["end"] - c["due"]) for c in calls for _ in range(B))
    e2e["request_ms_p95"] = lat[math.ceil(0.95 * len(lat)) - 1]
    failed = sum(int(((c["tokens"] < 0) | (c["tokens"] >= V)).sum())
                 for c in calls)
    gaps = served_gaps(cfg, tr, ctx.seed, calls, dev, control=ctx.control)
    record = {"calls": [{k: v for k, v in c.items() if k != "tokens"}
                        for c in calls],
              "batch": B, "new_tokens": n_new, "bucket_seq": tr["bucket_seq"],
              "span_s": span, "traced": {"calls": traced}}
    out = {"setup_s": setup_s, "e2e": e2e, "record": record, "trace": trace,
           "numbers": {"logit_gap": gaps["program"]},
           "where": {"logit_gap": gaps["where"], "rows": gaps["rows"]},
           "attempted": len(calls) * B, "failed": failed,
           "memory_peak_bytes": peak}
    if ctx.control:
        out["control"] = {"fp8": {"logit_gap": gaps["control"]}}
    return out


def window(ctx, server, B: int, V: int, n_new: int) -> list:
    """The measured window: the calls in order, each started when due or
    when the one before has returned; ``[{i, len, due, start, end,
    prefill_s, decode_s, tokens}]``, times from the window's start."""
    tr = ctx.traffic
    interval = 1.0 / tr["calls_per_s"]
    latency = tr["judge"] == "latency"
    calls = []
    t0 = time.perf_counter()
    for i in itertools.count():
        due = t0 + i * interval
        if (due - t0 >= ctx.seconds) if latency else \
                (i and time.perf_counter() - t0 >= ctx.seconds):
            break
        L = feed.length(ctx.seed, tr["prompt_lens"], i)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        start = time.perf_counter()
        toks, pf, dc = server.generate(feed.prompts(ctx.seed, i, B, L, V),
                                       n_steps=n_new)
        calls.append({"i": i, "len": L, "due": due - t0,
                      "start": start - t0, "end": time.perf_counter() - t0,
                      "prefill_s": pf, "decode_s": dc, "tokens": toks})
    return calls


def sample(seed: int, calls: list, n: int) -> list:
    """``n`` served requests ``(call, row)`` drawn from the seed, one of
    the longest prompt length among them."""
    B = calls[0]["tokens"].shape[0]
    pool = [(ci, r) for ci in range(len(calls)) for r in range(B)]
    rng = np.random.Generator(np.random.PCG64(feed.mix(seed, 4)))
    picked = [pool[j] for j in rng.choice(len(pool), min(n, len(pool)),
                                          replace=False)]
    longest = max(c["len"] for c in calls)
    if all(calls[ci]["len"] != longest for ci, _ in picked):
        ci = next(j for j, c in enumerate(calls) if c["len"] == longest)
        picked[0] = (ci, int(rng.integers(B)))
    return picked


def served_gaps(cfg: dict, tr: dict, seed: int, calls: list, dev,
                control: bool = False) -> dict:
    """The reference's widest gap below its best of the sampled served
    tokens (and with ``control``, of the tokens the float8 reference puts
    first at the same positions)."""
    B, V, n_new = tr["batch"], cfg["vocab_size"], tr["new_tokens"]
    picked = sample(seed, calls, tr["check_rows"])
    w = W.Weights(cfg, seed, dev).make()
    by_len = {}
    for ci, r in picked:
        by_len.setdefault(calls[ci]["len"], []).append((ci, r))
    worst, where, ctrl = 0.0, None, 0.0
    with torch.no_grad(), R.float32_matmuls():
        for L, reqs in sorted(by_len.items()):
            for at in range(0, len(reqs), REF_ROWS):
                part = reqs[at:at + REF_ROWS]
                served = np.stack([calls[ci]["tokens"][r]
                                   for ci, r in part])          # [b, n_new]
                prompt = np.stack([feed.prompts(seed, calls[ci]["i"], B, L,
                                                V)[r] for ci, r in part])
                seq = torch.as_tensor(np.concatenate(
                    [prompt, served[:, :-1]], 1).astype(np.int64),
                    device=dev)
                served_t = torch.as_tensor(served.astype(np.int64),
                                           device=dev)
                lg = R.logits(w, cfg, R.hidden(w, cfg, seq)[:, L - 1:])
                g = checks.served_gap(lg.reshape(-1, V),
                                      served_t.reshape(-1))
                if g > worst or where is None:
                    worst, where = g, f"prompt length {L}"
                if control:
                    lc = R.logits(w, cfg, R.hidden(w, cfg, seq, fp8=True)
                                  [:, L - 1:], fp8=True)
                    ctrl = max(ctrl, checks.served_gap(
                        lg.reshape(-1, V), lc.argmax(-1).reshape(-1)))
                del lg
    return {"program": worst, "control": ctrl, "where": where,
            "rows": len(picked)}
