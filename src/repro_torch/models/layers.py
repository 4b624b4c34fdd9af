"""Model layers in PyTorch: the single-device subset of the JAX package's
``models/layers.py`` (attention, MLP, the capacity-based MoE and the
Mamba2 block).

Parameters live in small :class:`torch.nn.Module` holders
(:class:`Attention`, :class:`MLP`, :class:`MoE`, :class:`Mamba`); the math is plain
tensor functions with the reference's names and layouts (``[B, S, H, hd]``
activations, ``[D, H, hd]`` projections), so the two packages compare like
with like. Prefill attention goes through
:func:`~repro_torch.kernels.flash_attention.attention` (B4), decode
attention through :func:`~repro_torch.kernels.gqa_decode.decode_attention`
(B7) and a Mamba prefill's SSD scan through
:func:`~repro_torch.kernels.ssd_scan.ssd` (B8); their ``use_kernel`` flag is
passed through. The chunked scan :func:`ssd_chunked` (B8's plain version)
lives beside its kernel and is re-exported here. The MoE's expert
products are plain batched products (the reference leaves them to XLA
too). Mesh sharding, sequence parallelism and the MoE's expert- and
tensor-parallel paths are not ported yet.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import attention
from repro_torch.kernels.gqa_decode import decode_attention
from repro_torch.kernels.ssd_scan import ssd, ssd_chunked

from .config import ModelConfig

__all__ = ["Attention", "MLP", "Mamba", "MoE", "MoERouting", "apply_rope",
           "attention_block", "dense", "init_attention", "init_mamba",
           "init_mlp", "init_moe", "mamba_block", "mlp_block",
           "moe_block", "moe_capacity", "moe_local", "moe_route",
           "rms_norm", "ssd_chunked", "ssd_decode_step", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, …)."""
    return _DTYPES[name]


def _normal(shape, generator: torch.Generator, dtype, std: float = 0.02):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device) * std


def _param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter (serving runs under ``torch.inference_mode``,
    so it records no graph)."""
    return nn.Parameter(t)


# ===========================================================================
# Primitives
# ===========================================================================

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with a ``(1 + scale)`` gain, computed in float32."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """``x [..., d] @ w [d, f]`` with ``w`` cast to the compute dtype."""
    return x @ w.to(dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device
                ) -> torch.Tensor:
    """The reference's float64 frequencies, as float32, kept on ``device``
    (made once: a host-to-device copy per call would stall the stream)."""
    f = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.as_tensor(f, dtype=torch.float32).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotary embedding, split-halves convention. x: ``[..., S, H, hd]``;
    positions: ``[..., S]`` integer."""
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    ang = positions.float()[..., :, None, None] * freqs   # [..., S, 1, hd/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str):
    """``silu``, or ``gelu`` in its tanh approximation."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise KeyError(f"unknown activation {name!r}")


# ===========================================================================
# Attention
# ===========================================================================

class Attention(nn.Module):
    """Projections of one attention block over the padded head layout of
    ``cfg.gqa``: ``wq [D, Hq_pad, hd]``, ``wk``/``wv [D, Hkv_pad, hd]``,
    ``wo [Hq_pad, hd, D]``."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   dtype: torch.dtype) -> Attention:
    """Normal(0, 0.02) projections on the generator's device; the slots of
    padded (dummy) heads are zero, as in the reference."""
    pad = cfg.gqa
    D, hd = cfg.d_model, cfg.head_dim
    dev = generator.device

    def slot_mask(slot_to_orig):
        return torch.tensor([1.0 if o >= 0 else 0.0 for o in slot_to_orig],
                            dtype=dtype, device=dev)

    wq = _normal((D, pad.n_q_pad, hd), generator, dtype) \
        * slot_mask(pad.q_slot_to_q)[None, :, None]
    wk = _normal((D, pad.n_kv_pad, hd), generator, dtype) \
        * slot_mask(pad.kv_slot_to_kv)[None, :, None]
    wv = _normal((D, pad.n_kv_pad, hd), generator, dtype) \
        * slot_mask(pad.kv_slot_to_kv)[None, :, None]
    wo = _normal((pad.n_q_pad, hd, D), generator, dtype) \
        * slot_mask(pad.q_slot_to_q)[:, None, None]
    return Attention(wq, wk, wv, wo)


def _project_heads(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
                   ) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd).to(dtype)).unflatten(-1, (H, hd))


def attention_block(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    start: int, *, window: int,
                    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    = None, kv_len: Optional[torch.Tensor] = None,
                    ring: bool = False, use_kernel: Optional[bool] = None,
                    stash=None):
    """qkv projection → rope → attention → output projection.

    x: ``[B, S, D]`` at positions ``start .. start + S - 1`` in every row
    (static batching keeps positions uniform across the batch, so they are
    a host int and addressing the cache needs no device sync). Without a
    cache this is a full-sequence forward. With ``kv_cache = (ck, cv)`` of
    ``[B, Sc, Hkv, hd]``:

    * ``S == 1`` is a decode step: the new k/v are written into slot
      ``start`` (``start % Sc`` in ring mode) **in place**, then the
      token attends the cache through ``decode_attention`` with ``kv_len``;
    * ``S > 1`` is a prefill: k/v fill the first S slots (in ring mode with
      ``S > Sc``, the last Sc positions, rolled so slot ``j`` holds position
      ``j mod Sc``), and the prompt attends itself.

    A write past the end of a non-ring cache raises :class:`ValueError`
    (the reference clamps it onto the last slot). A full-sequence forward
    under grad records its attention output, the reference's ``attn_out``
    (before the output projection), into ``stash`` (an
    :class:`~repro_torch.kernels.flash_attention.AttentionStash`) or, when
    that holds one already, takes it from there. Returns
    ``(out [B, S, D], (ck, cv))``; the cache tensors are the ones passed
    in, updated.
    """
    dt = torch_dtype(cfg.dtype)
    B, S = x.shape[:2]
    positions = torch.arange(start, start + S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    q = apply_rope(_project_heads(x, p.wq, dt), positions, cfg.rope_theta)
    k = apply_rope(_project_heads(x, p.wk, dt), positions, cfg.rope_theta)
    v = _project_heads(x, p.wv, dt)

    if kv_cache is None:
        o = attention(q, k, v, causal=cfg.causal, window=window,
                      softcap=cfg.attn_softcap, use_kernel=use_kernel,
                      stash=stash)
        new_kv = (k, v)
    else:
        ck, cv = kv_cache
        Sc = ck.shape[1]
        if S == 1:
            if not ring and start >= Sc:
                raise ValueError(
                    f"decode at position {start} overruns the {Sc}-slot KV "
                    "cache; allocate a longer cache (bucket_seq)")
            slot = start % Sc if ring else start
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
            o = decode_attention(q[:, 0], ck, cv, kv_len, window=window,
                                 ring=ring, softcap=cfg.attn_softcap,
                                 use_kernel=use_kernel)[:, None]
        else:
            if ring and S > Sc:
                shift = (start + S - Sc) % Sc
                ck.copy_(torch.roll(k[:, -Sc:], shift, dims=1))
                cv.copy_(torch.roll(v[:, -Sc:], shift, dims=1))
            elif S > Sc:
                raise ValueError(f"a {S}-token prompt does not fit the "
                                 f"{Sc}-slot KV cache")
            else:
                ck[:, :S] = k
                cv[:, :S] = v
            o = attention(q, k, v, causal=cfg.causal, window=window,
                          softcap=cfg.attn_softcap, use_kernel=use_kernel)
        new_kv = (ck, cv)

    H, hd, D = p.wo.shape
    out = o.flatten(-2) @ p.wo.reshape(H * hd, D).to(dt)
    return out, new_kv


# ===========================================================================
# Dense MLP (SwiGLU / GeLU)
# ===========================================================================

class MLP(nn.Module):
    """``w_gate``/``w_up [D, F_pad]``, ``w_down [F_pad, D]``."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_param,
                                                  (w_gate, w_up, w_down))


def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype) -> MLP:
    D, F_ = cfg.d_model, cfg.d_ff_pad
    return MLP(_normal((D, F_), generator, dtype),
               _normal((D, F_), generator, dtype),
               _normal((F_, D), generator, dtype))


def mlp_block(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    h = _act(cfg.act)(dense(x, p.w_gate, dt)) * dense(x, p.w_up, dt)
    return dense(h, p.w_down, dt)


# ===========================================================================
# MoE (capacity-based, sort dispatch)
# ===========================================================================

class MoE(nn.Module):
    """The router ``[D, E]`` (float32) and the experts' ``w_gate``/``w_up
    [E, D, F_pad]`` and ``w_down [E, F_pad, D]``."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = map(
            _param, (router, w_gate, w_up, w_down))


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype) -> MoE:
    D, F_, E = cfg.d_model, cfg.d_ff_pad, cfg.n_experts
    return MoE(_normal((D, E), generator, torch.float32),
               _normal((E, D, F_), generator, dtype),
               _normal((E, D, F_), generator, dtype),
               _normal((E, F_, D), generator, dtype))


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity: lossless (``T·k``) for decode-sized batches of
    at most 256 assignment slots, else ``T·k·capacity_factor // E`` (at
    least 1), the reference's ``_moe_capacity``."""
    if n_tokens * cfg.top_k <= 256:
        return n_tokens * cfg.top_k
    return max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor
                      // cfg.n_experts))


class MoERouting(NamedTuple):
    """The routing of ``T`` tokens: ``gate``/``idx [T, k]`` (the top-k
    probabilities, normalised, and their experts, lower expert first on a
    tie), ``slot [T, k]`` (each assignment's row of the expert batches,
    ``n_slots = E · capacity`` where it is dropped) and ``kept [T, k]``
    (bool: not dropped for capacity)."""
    gate: torch.Tensor
    idx: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
              capacity: int) -> MoERouting:
    """Route ``x [T, D]``: float32 router logits, softmax, top-k by a
    stable descending sort (``lax.top_k``'s order: on a tie the lower
    expert first; ``torch.topk`` promises no order), gates divided by
    ``max(sum, 1e-9)``; then the assignments in token order, sorted stably
    by expert, take positions ``0, 1, …`` in their expert's batch, and
    those at or past ``capacity`` are dropped (the lower token index is
    kept)."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(se, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[se]
    kept = pos < capacity
    slot = torch.where(kept, se * capacity + pos,
                       torch.full_like(pos, E * capacity))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    return MoERouting(gate, idx, slot[inv].reshape(T, k),
                      kept[inv].reshape(T, k))


def moe_local(x: torch.Tensor, p: MoE, cfg: ModelConfig, capacity: int
              ) -> torch.Tensor:
    """The reference's ``_moe_local`` over every expert (one device):
    gather each expert's tokens into ``[E, capacity, D]`` batches through a
    slot → token map (the dump slot ``n_slots`` is discarded), the expert
    products as batched products in the compute dtype, and the combine
    ``out = out + y[slot_j] · g_j`` for j = 0..k−1 in that dtype, in the
    reference's order. x: ``[T, D]``."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    r = moe_route(x, p.router, cfg, capacity)
    n_slots = E * capacity
    flat_slot = r.slot.reshape(-1)
    slot_token = torch.zeros(n_slots + 1, dtype=torch.long, device=x.device)
    slot_token[flat_slot] = torch.arange(T, device=x.device
                                         ).repeat_interleave(k)
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=x.device)
    slot_valid[flat_slot] = r.kept.reshape(-1)
    xb = (x[slot_token[:-1]] * slot_valid[:-1, None].to(dt)
          ).reshape(E, capacity, D)
    h = _act(cfg.act)(torch.bmm(xb, p.w_gate.to(dt))) \
        * torch.bmm(xb, p.w_up.to(dt))
    yb = torch.bmm(h, p.w_down.to(dt)).reshape(n_slots, D)
    yb = torch.cat([yb, yb.new_zeros(1, D)])
    weight = r.gate.to(dt) * r.kept.to(dt)
    out = torch.zeros(T, D, dtype=dt, device=x.device)
    for j in range(k):
        out = out + yb[r.slot[:, j]] * weight[:, j:j + 1]
    return out


def moe_block(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """MoE FFN of ``x [B, S, D]`` on one device, capacity from the
    ``B·S`` tokens (the reference's ``moe_block`` with ``ctx=None``)."""
    B, S, D = x.shape
    out = moe_local(x.reshape(-1, D), p, cfg, moe_capacity(B * S, cfg))
    return out.reshape(B, S, D)


# ===========================================================================
# Mamba2 (SSD — state-space duality, chunked)
# ===========================================================================

class Mamba(nn.Module):
    """One Mamba2 block: ``in_proj [D, 2·din + 2N + H]``, the depthwise
    causal conv ``conv_w [cw, din + 2N]`` and ``conv_b``, float32 ``A_log``,
    ``D_skip`` and ``dt_bias [H]``, the gated norm's ``norm_scale [din]``
    and ``out_proj [din, D]``."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D_skip, dt_bias,
                 norm_scale, out_proj):
        super().__init__()
        (self.in_proj, self.conv_w, self.conv_b, self.A_log, self.D_skip,
         self.dt_bias, self.norm_scale, self.out_proj) = map(
            _param, (in_proj, conv_w, conv_b, A_log, D_skip, dt_bias,
                     norm_scale, out_proj))


def init_mamba(cfg: ModelConfig, generator: torch.Generator,
               dtype: torch.dtype) -> Mamba:
    """Normal(0, 0.02) projections and conv, zero conv bias and norm scale;
    ``A_log = log(linspace(1, 16, H))`` and ``dt_bias`` the inverse softplus
    of ``linspace(1e-3, 0.1, H)``, as in the reference."""
    D = cfg.d_model
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * N
    dev = generator.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return Mamba(
        _normal((D, 2 * din + 2 * N + H), generator, dtype),
        _normal((cfg.conv_width, conv_ch), generator, dtype),
        torch.zeros(conv_ch, dtype=dtype, device=dev),
        f32(np.log(np.linspace(1.0, 16.0, H).astype(np.float32))),
        torch.ones(H, dtype=torch.float32, device=dev),
        f32(np.log(np.expm1(np.linspace(1e-3, 0.1, H)))),
        torch.zeros(din, dtype=dtype, device=dev),
        _normal((din, D), generator, dtype))


def ssd_decode_step(x: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, state: torch.Tensor):
    """One-token SSD recurrence. x ``[b, h, p]``, dtA ``[b, h]``, B/C ``[b,
    n]``, state ``[b, h, p, n]``. Returns ``(y [b, h, p], state)``."""
    decay = torch.exp(dtA)[..., None, None]
    state = state * decay + torch.einsum("bn,bhp->bhpn", B, x)
    y = torch.einsum("bn,bhpn->bhp", C, state)
    return y, state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` at every x (torch's
    ``softplus`` turns into the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_block(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                use_kernel: Optional[bool] = None):
    """Mamba2 block. x: ``[B, S, D]``. ``cache = (conv_state [B, cw-1,
    ch], ssm_state [B, H, P, N] float32)`` continues a sequence; ``None``
    starts one. ``S > 1`` (or no cache) scans the sequence through the SSD
    dispatcher from the cache's state; ``S == 1`` with a cache is a decode
    step. Returns ``(out [B, S, D], (new_conv, new_ssm))``; the cache
    tensors passed in are not modified."""
    dt_ = torch_dtype(cfg.dtype)
    Bsz, S, _ = x.shape
    din, N, H, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    conv_ch = din + 2 * N

    zxbcdt = dense(x, p.in_proj, dt_)
    z, xBC, dt = torch.split(zxbcdt, [din, din + 2 * N, H], dim=-1)
    dt = _softplus(dt.float() + p.dt_bias.float())              # [B,S,H]

    cw = cfg.conv_width
    if cache is None:
        xpad = F.pad(xBC, (0, 0, cw - 1, 0))
    else:
        xpad = torch.cat([cache[0].to(dt_), xBC], dim=1)
    new_conv = xpad[:, xpad.shape[1] - (cw - 1):] if cw > 1 else \
        torch.zeros((Bsz, 0, conv_ch), dtype=dt_, device=x.device)
    # the depthwise causal conv as the reference writes it: a sum of
    # shifted slices in order (F.conv1d would run f32 through cuDNN's TF32)
    conv = sum(xpad[:, i:i + S] * p.conv_w[i].to(dt_)[None, None]
               for i in range(cw))
    xBC = F.silu(conv + p.conv_b.to(dt_))

    xin, Bmat, Cmat = torch.split(xBC, [din, N, N], dim=-1)
    xin = xin.reshape(Bsz, S, H, hp)
    A = -torch.exp(p.A_log.float())                             # [H]
    dtA = dt * A                                                # [B,S,H]
    Xd = xin * dt.to(dt_)[..., None]

    if cache is None or S > 1:
        init = cache[1].float() if cache is not None else None
        Y, final_state = ssd(Xd.float(), dtA, Bmat.float(), Cmat.float(),
                             chunk=cfg.ssm_chunk, initial_state=init,
                             use_kernel=use_kernel)
    else:
        y1, final_state = ssd_decode_step(
            Xd[:, 0].float(), dtA[:, 0], Bmat[:, 0].float(),
            Cmat[:, 0].float(), cache[1].float())
        Y = y1[:, None]

    Y = Y.to(dt_) + xin * p.D_skip.to(dt_)[None, None, :, None]
    Y = Y.reshape(Bsz, S, din)
    Y = rms_norm(Y * F.silu(z), p.norm_scale, cfg.norm_eps)
    out = dense(Y, p.out_proj, dt_)
    return out, (new_conv.to(dt_), final_state.float())
