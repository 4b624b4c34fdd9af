"""Assigned input-shape cells and per-architecture applicability rules: the
port of ``repro.launch.shapes``, the same cells and reasons."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import ARCH_IDS, get_config

__all__ = ["ShapeCell", "SHAPES", "cell_plan", "all_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

#: archs allowed to run long_500k (sub-quadratic decode state growth is
#: bounded: SSM / hybrid / SWA-only). gemma2's alternating *global* layers
#: keep full-range KV ⇒ excluded (see DESIGN.md §Arch-applicability).
LONG_OK = {"mamba2_2p7b", "zamba2_2p7b", "mixtral_8x7b"}


def cell_plan(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    if cfg.encoder_only and cell.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and arch not in LONG_OK:
        return False, ("full-attention arch: 500k decode KV state grows "
                       "unboundedly (assignment rule: skip)")
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = cell_plan(arch, shape)
            out.append((arch, shape, ok, why))
    return out
