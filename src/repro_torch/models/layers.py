"""Dense model layers in PyTorch: the single-device subset of the JAX
package's ``models/layers.py``.

Parameters live in small :class:`torch.nn.Module` holders
(:class:`Attention`, :class:`MLP`); the math is plain tensor functions with
the reference's names and layouts (``[B, S, H, hd]`` activations, ``[D, H,
hd]`` projections), so the two packages compare like with like. Prefill
attention goes through :func:`~repro_torch.kernels.flash_attention.attention`
(B4) and decode attention through
:func:`~repro_torch.kernels.gqa_decode.decode_attention` (B7); their
``use_kernel`` flag is passed through. Mesh sharding, sequence parallelism,
MoE and Mamba are not ported yet.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import attention
from repro_torch.kernels.gqa_decode import decode_attention

from .config import ModelConfig

__all__ = ["Attention", "MLP", "apply_rope", "attention_block", "dense",
           "init_attention", "init_mlp", "mlp_block", "rms_norm",
           "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, …)."""
    return _DTYPES[name]


def _normal(shape, generator: torch.Generator, dtype, std: float = 0.02):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device) * std


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


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
                    ring: bool = False, use_kernel: Optional[bool] = None):
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
    (the reference clamps it onto the last slot). Returns
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
                      softcap=cfg.attn_softcap, use_kernel=use_kernel)
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
