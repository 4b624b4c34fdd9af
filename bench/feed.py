"""The benchmark's inputs, drawn from the seed: training batches of token
ids (batch ``k`` from its own generator, so the reference can draw the
same batch again) and serving prompts."""
from __future__ import annotations

import numpy as np
import torch


def mix(seed: int, *keys: int) -> int:
    h = int(seed) & (2 ** 64 - 1)
    for k in keys:
        h = (h * 0x9E3779B97F4A7C15 + int(k) + 0x632BE59BD9B4E019) \
            % (2 ** 64)
        h ^= h >> 29
    return h % (2 ** 63)


def train_batch(seed: int, k: int, B: int, S: int, V: int, device
                ) -> dict:
    """Batch ``k``: ``tokens`` and next-token ``targets`` ``[B, S]``,
    int64, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, 1, k))
    ids = torch.randint(0, V, (B, S + 1), generator=gen, device=device)
    return {"tokens": ids[:, :-1], "targets": ids[:, 1:]}


def prompts(seed: int, i: int, B: int, S: int, V: int) -> np.ndarray:
    """Call ``i``'s ``[B, S]`` prompt ids (int32)."""
    rng = np.random.Generator(np.random.PCG64(mix(seed, 2, i)))
    return rng.integers(0, V, (B, S), dtype=np.int64).astype(np.int32)


def length(seed: int, lens, i: int) -> int:
    """Call ``i``'s prompt length: the lengths in turn, starting where the
    seed says. Every seed offers the same work in the same cycle, so the
    wait behind the longest calls, which sets the tail, is the same."""
    return lens[(i + seed) % len(lens)]
