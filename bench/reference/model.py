"""Mamba2 and Zamba2 in plain float32 PyTorch.

Follows the published block equations as the configuration file states
them (the Mamba2 SSD layer of arXiv:2405.21060; the Zamba2 backbone with
its two alternating shared attention + MLP blocks after every
``shared_attn_every`` Mamba2 layers, arXiv:2411.15242, with the
departures the configuration lists under ``assumed``: the shared blocks
take the residual stream alone, without the concatenated embedding and
without LoRA projectors). No kernel, cache or batching: a full-sequence
forward, the SSD as the chunked "minimal" algorithm of the Mamba2 paper,
attention as an explicit masked softmax.

``fp8=True`` is the control: every matrix product's two operands rounded
to float8 e4m3 with a per-tensor scale, the precision below the
configuration's bfloat16. Matrix products run in full float32 (TF32 off:
:func:`float32_matmuls`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tree = Dict[str, torch.Tensor]

FP8_MAX = 448.0


@contextlib.contextmanager
def float32_matmuls():
    """Matrix products in float32, not TF32, while the block runs."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32; the gradient passes through the rounding unchanged, so the
    products' backward runs on the rounded operands."""
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t.detach())


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    return x @ w


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a ``(1 + gain)`` scale."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + gain)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = x[..., j+1] + ... + x[..., i]`` for ``i >= j``,
    ``-inf`` above the diagonal."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device),
                       -1)
    s = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    on = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return s.masked_fill(~on, -math.inf)


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """The SSD scan from a zero state: ``h_t = exp(A_t) h_{t-1} + X_t
    B_tᵀ``, ``y_t = h_t C_t``, chunk by chunk. X ``[b, L, h, p]``, A ``[b,
    L, h]``, B/C ``[b, L, n]`` (one group for every head). Returns ``y [b,
    L, h, p]``."""
    b, L, h, p = X.shape
    pad = (-L) % chunk
    if pad:
        X = F.pad(X, (0, 0, 0, 0, 0, pad))
        A = F.pad(A, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    c = X.shape[1] // chunk
    X = X.reshape(b, c, chunk, h, p)
    B = B.reshape(b, c, chunk, -1)
    C = C.reshape(b, c, chunk, -1)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)           # [b,h,c,l]
    A_cum = torch.cumsum(A, dim=-1)
    # within each chunk
    scores = torch.einsum("bcln,bcsn->bcls", C, B)[:, None] \
        * torch.exp(segsum(A))                                  # [b,h,c,l,s]
    y = torch.einsum("bhcls,bcshp->bclhp", scores, X)
    # each chunk's state, carried across chunks
    decay_in = torch.exp(A_cum[..., -1:] - A_cum).permute(0, 2, 3, 1)
    states = torch.einsum("bcln,bclhp->bchpn", B, X * decay_in[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    decay_out = torch.exp(A_cum).permute(0, 2, 3, 1)            # [b,c,l,h]
    y = y + torch.einsum("bcln,bchpn->bclhp", C, states) * decay_out[..., None]
    return y.reshape(b, c * chunk, h, p)[:, :L]


def mamba_layer(w: Tree, i: int, cfg: dict, x: torch.Tensor,
                fp8: bool = False) -> torch.Tensor:
    """Pre-norm Mamba2 layer ``i`` with its residual."""
    p = f"mamba.{i}."
    eps = cfg["norm_eps"]
    D = cfg["d_model"]
    din = cfg.get("ssm_expand", 2) * D
    P = cfg.get("ssm_head_dim", 64)
    H, N, cw = din // P, cfg["ssm_state"], cfg.get("conv_width", 4)
    b, S, _ = x.shape
    h = rms_norm(x, w[p + "ln"], eps)
    z, xbc, dt = torch.split(linear(h, w[p + "block.in_proj"], fp8),
                             [din, din + 2 * N, H], dim=-1)
    dt = dt + w[p + "block.dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))             # softplus
    xpad = F.pad(xbc, (0, 0, cw - 1, 0))
    conv = sum(xpad[:, k:k + S] * w[p + "block.conv_w"][k] for k in range(cw))
    xbc = F.silu(conv + w[p + "block.conv_b"])
    xs, Bm, Cm = torch.split(xbc, [din, N, N], dim=-1)
    xs = xs.reshape(b, S, H, P)
    A = -torch.exp(w[p + "block.A_log"])
    y = ssd(xs * dt[..., None], dt * A, Bm, Cm, cfg.get("ssm_chunk", 256))
    y = y + xs * w[p + "block.D_skip"][:, None]
    y = y.reshape(b, S, din) * F.silu(z)
    y = rms_norm(y, w[p + "block.norm_scale"], eps)
    return x + linear(y, w[p + "block.out_proj"], fp8)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split halves, positions from 0. x ``[b, S, H,
    hd]``."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (np.arange(0, hd, 2) / hd)
    ang = np.arange(S)[:, None] * freqs[None]
    cos = torch.as_tensor(np.cos(ang), dtype=torch.float32,
                          device=x.device)[:, None]
    sin = torch.as_tensor(np.sin(ang), dtype=torch.float32,
                          device=x.device)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def shared_block(w: Tree, j: int, cfg: dict, x: torch.Tensor,
                 fp8: bool = False) -> torch.Tensor:
    """Shared block ``j``: causal attention with rotary positions, then the
    gated MLP, each pre-norm with its residual."""
    p = f"shared.{j}."
    eps = cfg["norm_eps"]
    D, Hq, Hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"]
    b, S, _ = x.shape
    h = rms_norm(x, w[p + "ln1"], eps)

    def heads(name, n):
        return linear(h, w[p + name].reshape(D, n * hd), fp8) \
            .reshape(b, S, n, hd)

    theta = float(cfg.get("rope_theta", 1e6))
    q = _rope(heads("attn.wq", Hq), theta)
    k = _rope(heads("attn.wk", Hkv), theta)
    v = heads("attn.wv", Hkv)
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(mask, -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    x = x + linear(o.reshape(b, S, Hq * hd),
                   w[p + "attn.wo"].reshape(Hq * hd, D), fp8)
    h = rms_norm(x, w[p + "ln2"], eps)
    act = F.silu if cfg.get("act", "silu") == "silu" else \
        (lambda t: F.gelu(t, approximate="tanh"))
    g = act(linear(h, w[p + "mlp.w_gate"], fp8)) * linear(h, w[p + "mlp.w_up"],
                                                         fp8)
    return x + linear(g, w[p + "mlp.w_down"], fp8)


def hidden(w: Tree, cfg: dict, tokens: torch.Tensor, fp8: bool = False,
           remat: bool = False) -> torch.Tensor:
    """The final hidden state ``[b, S, D]`` (before the final norm) of
    ``tokens [b, S]``. ``remat`` recomputes each layer in the backward."""
    def run(fn, *args):
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    x = w["tok"][tokens]
    n = cfg["n_layers"]
    every = cfg.get("shared_attn_every", 0) if cfg["family"] == "hybrid" \
        else 0
    for i in range(n):
        x = run(mamba_layer, w, i, cfg, x, fp8)
        if every and (i + 1) % every == 0:
            j = ((i + 1) // every - 1) % cfg["n_shared_blocks"]
            x = run(shared_block, w, j, cfg, x, fp8)
    return x


def logits(w: Tree, cfg: dict, x: torch.Tensor, fp8: bool = False
           ) -> torch.Tensor:
    """Float32 logits over the vocabulary of hidden states ``x``."""
    head = w["tok"].T if cfg.get("tie_embeddings") else w["head"]
    out = linear(rms_norm(x, w["final_norm"], cfg["norm_eps"]), head, fp8)
    return out[..., :cfg["vocab_size"]]


def loss(w: Tree, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor,
         fp8: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy over every position, each layer
    rematerialised in the backward."""
    x = hidden(w, cfg, tokens, fp8, remat=True)
    lg = logits(w, cfg, x, fp8)
    return (torch.logsumexp(lg, -1)
            - torch.gather(lg, -1, targets[..., None])[..., 0]).mean()
