"""Model FLOPs of the benchmark's configurations, from the layer shapes.

Matrix products count 2 operations a multiply-add per token (6 for a
training step: forward, and the two products of the backward); the SSD
scan and causal attention add their frozen kernel costs (:mod:`.kernels`)
at the cell's shapes and the configuration's chunk, forward and backward
for training. A rematerialised forward is not counted: it is work the
program chose, not work the model needs. Each shared-block application of
a hybrid counts on its own. Elementwise work (norms, the depthwise conv,
gates) is left out.
"""
from __future__ import annotations

from . import kernels as K


def _dims(cfg: dict) -> dict:
    D = cfg["d_model"]
    din = cfg.get("ssm_expand", 2) * D
    P = cfg.get("ssm_head_dim", 64)
    hybrid = cfg["family"] == "hybrid"
    n_heads = cfg.get("n_heads", 0)
    return dict(
        D=D, din=din, N=cfg.get("ssm_state", 0), P=P, H=din // P,
        chunk=cfg.get("ssm_chunk", 256), V=cfg["vocab_size"],
        n_mamba=cfg["n_layers"],
        n_apps=cfg["n_layers"] // cfg["shared_attn_every"] if hybrid else 0,
        Hq=n_heads, Hkv=cfg.get("n_kv_heads", 0),
        hd=cfg.get("head_dim") or (D // n_heads if n_heads else 0),
        F=cfg.get("d_ff", 0))


def body_params(cfg: dict) -> int:
    """Matrix parameters a token passes through below the head: every
    Mamba2 layer's ``in_proj`` and ``out_proj``, and each shared-block
    application's attention projections and MLP."""
    d = _dims(cfg)
    D, din, N, H = d["D"], d["din"], d["N"], d["H"]
    mamba = D * (2 * din + 2 * N + H) + din * D
    attn = D * d["hd"] * (2 * d["Hq"] + 2 * d["Hkv"])
    mlp = 3 * D * d["F"]
    return d["n_mamba"] * mamba + d["n_apps"] * (attn + mlp)


def train_step_flops(cfg: dict, B: int, S: int) -> float:
    """One training step of ``B`` sequences of ``S`` tokens, every
    position in the loss."""
    d = _dims(cfg)
    tokens = B * S
    flops = 6 * tokens * (body_params(cfg) + d["D"] * d["V"])
    if d["n_mamba"]:
        fwd = K.ssd_scan_cost(B, S, d["H"], d["P"], d["N"], d["chunk"], False)
        bwd = K.ssd_scan_bwd_cost(B, S, d["H"], d["P"], d["N"], d["chunk"],
                                  False)
        flops += d["n_mamba"] * (fwd.flops + bwd.flops)
    if d["n_apps"]:
        args = (B, S, S, d["Hq"], d["Hkv"], d["hd"], 2)
        fwd = K.flash_attention_cost(*args)
        bwd = sum(c.flops for c in K.flash_attention_bwd_cost(*args).values())
        flops += d["n_apps"] * (fwd.flops + bwd)
    return float(flops)


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """A prefill of ``B`` prompts of ``S`` tokens: every position through
    the body, the head at the last position only."""
    d = _dims(cfg)
    flops = 2 * B * S * body_params(cfg) + 2 * B * d["D"] * d["V"]
    if d["n_mamba"]:
        flops += d["n_mamba"] * K.ssd_scan_cost(
            B, S, d["H"], d["P"], d["N"], d["chunk"], False).flops
    if d["n_apps"]:
        flops += d["n_apps"] * K.flash_attention_cost(
            B, S, S, d["Hq"], d["Hkv"], d["hd"], 2).flops
    return float(flops)


def decode_step_flops(cfg: dict, B: int, kv_len: int, cache_slots: int
                      ) -> float:
    """One decode step of ``B`` rows whose caches then hold ``kv_len``
    positions (the new one included) in ``cache_slots`` slots."""
    d = _dims(cfg)
    flops = 2 * B * (body_params(cfg) + d["D"] * d["V"])
    if d["n_mamba"]:
        _, ops = K.ssd_scan_work(B, 1, d["H"], d["P"], d["N"], d["chunk"],
                                 True)
        flops += d["n_mamba"] * ops["sequential"]
    if d["n_apps"]:
        slots = K.decode_slots([kv_len] * B, cache_slots)
        flops += d["n_apps"] * K.gqa_decode_cost(
            B, d["Hkv"], d["Hq"] // d["Hkv"], d["hd"], 2, slots).flops
    return float(flops)


def generate_flops(cfg: dict, B: int, S: int, n_steps: int,
                   cache_slots: int) -> float:
    """A greedy generate call: the prefill and ``n_steps`` decode steps
    (every step it runs, the last one's logits included)."""
    return prefill_flops(cfg, B, S) + sum(
        decode_step_flops(cfg, B, S + j + 1, cache_slots)
        for j in range(n_steps))
