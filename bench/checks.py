"""What decides ``correct``: the numbers compared between the program's
outputs and the plain reference's, each held to its limit from
``limits/<cell>.json``.

Training (:func:`train_numbers`): for each of the first steps the relative
gap of the loss; by the worst leaf, the gap between the program's norm of
the first gradient as the optimizer took it and the reference's; by the
worst leaf, the same of each parameter's change over those steps. A leaf's
gap is measured against the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose reference first gradient is under a
thousandth of the median leaf's are left out of the change: Adam moves
them by round-off alone.

Serving (:func:`served_gap`): the widest gap by which a served token's
reference logit lies below the reference's best at its position.
"""
from __future__ import annotations

import statistics
from typing import Dict, Sequence, Tuple

import torch

#: A leaf is left out of the change when its reference first gradient is
#: under this share of the median leaf's.
QUIET_LEAF = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap, against the larger of its reference norm and the
    median leaf's."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def train_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], dict]:
    """``({number: value}, {number: where})`` of a program's first steps
    (``prog``) against the reference's (``ref``); each a dict of
    ``losses`` (list), ``grad_norms`` and ``change_norms`` (by leaf).

    The numbers: ``loss_gap``, the largest relative gap of a step's loss;
    ``grad_norm_gap`` and ``change_norm_gap``, the worst leaf's gap; and
    ``grad_norm_gap.median_leaf`` and ``change_norm_gap.median_leaf``, the
    median leaf's gap, which does not ride on the noise of the smallest
    leaves. A cell's limits file says which of them it compares."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    names = sorted(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"][n] for n in names)
    moving = [n for n in names if ref["grad_norms"][n] >= QUIET_LEAF * med]
    numbers = {"loss_gap": max(losses)}
    where = {"loss_gap": f"step {1 + losses.index(max(losses))}"}
    for key, leaves in (("grad_norm", names), ("change_norm", moving)):
        gaps = _leaf_gaps(prog[f"{key}s"], ref[f"{key}s"], leaves)
        worst = max(gaps, key=gaps.get)
        numbers[f"{key}_gap"] = gaps[worst]
        numbers[f"{key}_gap.median_leaf"] = statistics.median(gaps.values())
        where[f"{key}_gap"] = worst
    where["quiet_leaves"] = _kinds(set(names) - set(moving))
    return numbers, where


def _kinds(names) -> Dict[str, int]:
    """Leaf names counted by their last part (``A_log``, ``ln``, ...)."""
    out: Dict[str, int] = {}
    for n in names:
        k = n.rsplit(".", 1)[-1]
        out[k] = out.get(k, 0) + 1
    return out


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """``max(ref_logits) - ref_logits[served]`` at every position, widest:
    ``ref_logits [n, V]`` float32, ``served [n]`` token ids. A token
    outside the vocabulary reads infinity."""
    V = ref_logits.shape[-1]
    if bool(((served < 0) | (served >= V)).any()):
        return float("inf")
    best = ref_logits.max(-1).values
    got = torch.gather(ref_logits, -1, served[:, None].long())[:, 0]
    return float((best - got).max())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """Whether every number the limits name is within its limit (a missing
    number or limit fails), and each beside its limit."""
    shown, ok = {}, True
    for name in sorted(limits):
        v, lim = numbers.get(name), limits.get(name)
        good = v is not None and lim is not None and v == v and v <= lim
        ok = ok and good
        shown[name] = {"value": v, "limit": lim}
    return ok, shown
