"""Seeded weights of a configuration, made by the benchmark and handed to
both the program and the plain reference.

Every Normal(0, ``init_std``) leaf is a view of one flat float32 buffer,
drawn on the device in blocks of :data:`BLOCK` elements, block ``j`` from
its own generator seeded with ``(seed, j)``: a few large draws, and any
leaf can be drawn again alone (:meth:`Weights.leaf`) to compare what the
program made of it. The other leaves are the Mamba2 schedules and zero
norm gains. Names and shapes are the port's parameter names, so the
program's model and the reference read the same dictionary.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: Elements of one draw.
BLOCK = 2 ** 26

Shape = Tuple[int, ...]


def _dims(cfg: dict) -> dict:
    D = cfg["d_model"]
    din = cfg.get("ssm_expand", 2) * D
    H = din // cfg.get("ssm_head_dim", 64)
    N = cfg.get("ssm_state", 0)
    return dict(D=D, din=din, H=H, N=N, ch=din + 2 * N,
                cw=cfg.get("conv_width", 4), V=cfg["vocab_size"])


def leaves(cfg: dict) -> List[Tuple[str, Shape, str]]:
    """``(name, shape, init)`` of every parameter, in the port's order;
    ``init`` is ``normal``, ``zeros``, ``ones``, ``a_log`` or ``dt_bias``.
    The vocabulary is padded to a multiple of 8 rows as the port pads it
    (the configurations here need none)."""
    d = _dims(cfg)
    D, din, H, N, V = d["D"], d["din"], d["H"], d["N"], d["V"]
    Vp = -(-V // 8) * 8
    out = [("tok", (Vp, D), "normal")]
    for i in range(cfg["n_layers"]):
        p = f"mamba.{i}."
        out += [(p + "ln", (D,), "zeros"),
                (p + "block.in_proj", (D, 2 * din + 2 * N + H), "normal"),
                (p + "block.conv_w", (d["cw"], d["ch"]), "normal"),
                (p + "block.conv_b", (d["ch"],), "zeros"),
                (p + "block.A_log", (H,), "a_log"),
                (p + "block.D_skip", (H,), "ones"),
                (p + "block.dt_bias", (H,), "dt_bias"),
                (p + "block.norm_scale", (din,), "zeros"),
                (p + "block.out_proj", (din, D), "normal")]
    if cfg["family"] == "hybrid":
        Hq, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
        hd, F = cfg["head_dim"], cfg["d_ff"]
        for j in range(cfg["n_shared_blocks"]):
            p = f"shared.{j}."
            out += [(p + "ln1", (D,), "zeros"),
                    (p + "attn.wq", (D, Hq, hd), "normal"),
                    (p + "attn.wk", (D, Hkv, hd), "normal"),
                    (p + "attn.wv", (D, Hkv, hd), "normal"),
                    (p + "attn.wo", (Hq, hd, D), "normal"),
                    (p + "ln2", (D,), "zeros"),
                    (p + "mlp.w_gate", (D, F), "normal"),
                    (p + "mlp.w_up", (D, F), "normal"),
                    (p + "mlp.w_down", (F, D), "normal")]
    out.append(("final_norm", (D,), "zeros"))
    if not cfg.get("tie_embeddings", False):
        out.append(("head", (D, Vp), "normal"))
    return out


def _schedule(init: str, H: int) -> np.ndarray:
    if init == "a_log":
        return np.log(np.linspace(1.0, 16.0, H).astype(np.float32))
    return np.log(np.expm1(np.linspace(1e-3, 0.1, H))).astype(np.float32)


def _block_seed(seed: int, j: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + j * 0xBF58476D1CE4E5B9
            + 1) % (2 ** 63)


class Weights:
    """The weights of ``cfg`` for ``seed`` on ``device``."""

    def __init__(self, cfg: dict, seed: int, device, block: int = BLOCK):
        self.cfg, self.seed, self.block = cfg, int(seed), block
        self.device = torch.device(device)
        self.std = float(cfg.get("init_std", 0.02))
        self.spec = leaves(cfg)
        self.offsets: Dict[str, int] = {}
        n = 0
        for name, shape, init in self.spec:
            if init == "normal":
                self.offsets[name] = n
                n += math.prod(shape)
        self.n_random = n
        self._last: Optional[Tuple[int, torch.Tensor]] = None

    def _draw(self, j: int, out: torch.Tensor) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_block_seed(self.seed, j))
        torch.randn(out.shape, generator=gen, out=out)

    def make(self) -> Dict[str, torch.Tensor]:
        """Every leaf, the random ones views of one buffer."""
        nb = -(-self.n_random // self.block)
        flat = torch.empty(nb * self.block, dtype=torch.float32,
                           device=self.device)
        for j in range(nb):
            self._draw(j, flat[j * self.block:(j + 1) * self.block])
        flat.mul_(self.std)
        return {name: self._leaf(name, shape, init, flat)
                for name, shape, init in self.spec}

    def _leaf(self, name: str, shape: Shape, init: str,
              flat: Optional[torch.Tensor]) -> torch.Tensor:
        if init == "normal":
            off = self.offsets[name]
            return flat[off:off + math.prod(shape)].view(shape)
        if init in ("zeros", "ones"):
            return (torch.zeros if init == "zeros" else torch.ones)(
                shape, dtype=torch.float32, device=self.device)
        return torch.as_tensor(_schedule(init, shape[0]),
                               device=self.device)

    def leaf(self, name: str) -> torch.Tensor:
        """Leaf ``name`` drawn again on its own (a new tensor)."""
        for n, shape, init in self.spec:
            if n == name:
                break
        else:
            raise KeyError(name)
        if init != "normal":
            return self._leaf(name, shape, init, None)
        off, size = self.offsets[name], math.prod(shape)
        out = torch.empty(size, dtype=torch.float32, device=self.device)
        done = 0
        while done < size:
            j, at = divmod(off + done, self.block)
            take = min(self.block - at, size - done)
            if self._last is None or self._last[0] != j:
                buf = torch.empty(self.block, dtype=torch.float32,
                                  device=self.device)
                self._draw(j, buf)
                self._last = (j, buf)
            out[done:done + take] = self._last[1][at:at + take]
            done += take
        return out.mul_(self.std).view(shape)

    def forget(self) -> None:
        """Drop the block :meth:`leaf` keeps for the next leaf."""
        self._last = None
