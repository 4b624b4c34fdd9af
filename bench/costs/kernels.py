"""The work of each hand-written kernel the cells drive, as operations (2
per multiply-add) and HBM bytes (each input read once, each output written
once), computed from shapes alone.

Frozen copies of the port's cost functions (``flash_attention_cost``,
``flash_attention_bwd_cost`` and ``visible_pairs`` from
``kernels/flash_attention/ops.py``; ``gqa_decode_cost`` and
``decode_slots`` from ``kernels/gqa_decode/ops.py``; ``ssd_scan_work``,
``ssd_scan_cost`` and ``ssd_scan_bwd_cost`` from ``kernels/ssd_scan/ops.py``)
as they stood when the benchmark was written. A metric calls them with the
cell's shapes, never with what the program launched, so a roofline share
reads the same work whatever implements it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple


class KernelCost(NamedTuple):
    flops: float
    bytes: float


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a prefill attends (positions from 0, the causal
    and sliding-window masks)."""
    total = 0
    for q in range(Sq):
        hi = min(Skv, q + 1) if causal else Skv
        lo = max(0, q - window + 1) if window else 0
        total += max(hi - lo, 0)
    return total


def flash_attention_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                         hd: int, itemsize: int, causal: bool = True,
                         window: int = 0) -> KernelCost:
    """B4: q, k and v read once, the output and the float32 lse written
    once; two products of 2·hd operations per visible pair and query
    head."""
    return KernelCost(
        flops=4 * hd * B * Hq * visible_pairs(Sq, Skv, causal, window),
        bytes=itemsize * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd)
        + 4 * B * Hq * Sq)


def flash_attention_bwd_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                             hd: int, itemsize: int, causal: bool = True,
                             window: int = 0) -> Dict[str, KernelCost]:
    """B5 (dQ: three products) and B6 (dK/dV: four products), 2·hd
    operations per visible pair and product."""
    pairs = B * Hq * visible_pairs(Sq, Skv, causal, window)
    q_side, kv_side, rows = B * Sq * Hq * hd, B * Skv * Hkv * hd, B * Hq * Sq
    return {"flash_attention_dq": KernelCost(
                6 * hd * pairs,
                itemsize * (3 * q_side + 2 * kv_side) + 8 * rows),
            "flash_attention_dkv": KernelCost(
                8 * hd * pairs,
                itemsize * (2 * q_side + 4 * kv_side) + 8 * rows)}


def decode_slots(kv_len: Sequence[int], Sc: int, *, window: int = 0,
                 ring: bool = False, slot0: int = 0,
                 sc_total: int | None = None) -> int:
    """Valid cache slots of the block ``slot0 .. slot0 + Sc - 1`` summed
    over the rows of ``kv_len``: the slots a decode step must read."""
    total = Sc if sc_total is None else int(sc_total)
    out = 0
    for n in kv_len:
        if ring:
            lo, hi = 0, total if n > total else min(n, total)
        else:
            hi = min(n, total)
            lo = max(0, n - window) if window else 0
        out += max(0, min(hi, slot0 + Sc) - max(lo, slot0))
    return out


def gqa_decode_cost(B: int, Hkv: int, G: int, hd: int, itemsize: int,
                    slots: int, return_lse: bool = False) -> KernelCost:
    """B7 over ``slots`` valid cache slots: q read and the output written,
    K and V of the valid slots read, kv_len read; two products of 2·hd
    operations per slot and query head."""
    return KernelCost(
        flops=4 * hd * G * Hkv * slots,
        bytes=itemsize * (2 * B * Hkv * G * hd + 2 * slots * Hkv * hd)
        + 4 * B + (4 * B * Hkv * G if return_lse else 0))


def ssd_scan_work(B: int, L: int, H: int, P: int, N: int, chunk: int,
                  with_init: bool) -> Tuple[float, Dict[str, float]]:
    """``(bytes, {algorithm: operations})`` of one SSD scan, float32: the
    ``chunked`` algorithm (C·Bᵀ over the visible pairs once per row and
    chunk, per head scores·X, C·stateᵀ and the state update) and the
    ``sequential`` one (5 P N per row, head and step)."""
    pairs = sum(q * (q + 1) // 2 for q in
                (min(chunk, L - c0) for c0 in range(0, L, chunk)))
    n_bytes = 4 * (2 * B * L * H * P + B * L * H + 2 * B * L * N
                   + (2 if with_init else 1) * B * H * P * N)
    return n_bytes, {
        "chunked": 2 * B * (pairs * N + H * (pairs * P + 2 * L * P * N)),
        "sequential": 5 * B * H * L * P * N}


def ssd_scan_cost(B: int, L: int, H: int, P: int, N: int, chunk: int,
                  with_init: bool) -> KernelCost:
    """B8: the chunked algorithm's operations and the scan's bytes."""
    n_bytes, ops = ssd_scan_work(B, L, H, P, N, chunk, with_init)
    return KernelCost(ops["chunked"], n_bytes)


def ssd_scan_bwd_cost(B: int, L: int, H: int, P: int, N: int, chunk: int,
                      with_dfinal: bool) -> KernelCost:
    """The SSD backward: x, dtA, b, c, dy, the forward's entering states
    and chunk decay (and dfinal) read once, dx, ddtA, db, dc and dinit
    written once, float32; 2 operations per multiply-add of the chunked
    backward over the visible pairs."""
    Lp = -(-L // chunk) * chunk
    nc = Lp // chunk
    pairs = nc * chunk * (chunk + 1) // 2
    n_bytes = 4 * (3 * B * L * H * P + 2 * B * L * H + 4 * B * L * N
                   + B * nc * H * (P * N + 1)
                   + (2 if with_dfinal else 1) * B * H * P * N)
    macs = B * (3 * pairs * N + H * (2 * pairs * P + 4 * Lp * P * N))
    return KernelCost(2 * macs, n_bytes)


def bound_s(cost: KernelCost, flops_per_s: float, bytes_per_s: float
            ) -> float:
    """The least time the card could take for ``cost``: the larger of its
    operations at ``flops_per_s`` and its bytes at ``bytes_per_s``."""
    return max(cost.flops / flops_per_s, cost.bytes / bytes_per_s)
