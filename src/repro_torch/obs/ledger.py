"""Greedy decision ledger — the "explain this pick" layer.

The paper's central algorithmic claim (Theorem 2 of arXiv:2104.15094)
is that the efficient greedy placement (EGP) achieves
``σ(greedy) ≥ (1 − 1/e) · OPT`` for the submodular objective of
Eq. (1). The sweeps verify that in aggregate; this module makes it
checkable **per placement**: every EGP / sparse-EGP pick is recorded as

    (edge, impl, benefit, marginal gain, remaining storage budget,
     #candidates considered, rank of chosen candidate, placed?)

so a tick's ledger exposes the live submodular gain curve (cumulative
marginal gains, concave by submodularity) and a certificate

    σ(greedy) ≥ (1 − 1/e) · σ̄     with σ̄ = sigma_upper_bound_np(...)

where σ̄ is the per-user relaxation bound (each user served by its best
individually-feasible implementation, budgets ignored) — an efficiently
computable upper bound on the LP optimum, so ``ratio ≥ 1 − 1/e``
*against σ̄* is strictly stronger than the guarantee. A ratio below the
line does **not** refute Theorem 2 (σ̄ overshoots OPT); it flags a
placement worth a closer look, which is exactly what a ledger is for.

Marginal gains are exact by construction: the ledger tracks each
user's best placed QoS (``best_u``) and books
``gain = Σ_u max(0, Q[u, p★] − best_u)`` per placed pick, so the gains
telescope — their sum equals the realized ``σ(x)`` of the placement to
float64 summation order (≤ 1e-6; the sparse top-k path books gains in
f32 inside the kernel's lock-step loop, documented tolerance ~1e-3
relative).

Hook protocol: :func:`enable_ledger` installs the ledger as
``repro_torch.core.placement._DECISION_SINK`` (``repro_torch.core.dynamic``
reads it from there), so the core never imports :mod:`repro_torch.obs` —
the disabled hot path in the pick loops is one module-attribute load +
``is None``. Everything here is observational: picks are recorded, not
influenced, and stores/TickReports/digests stay byte-identical.

Exports are JSONL (one record per placement instance), versioned by
:data:`LEDGER_SCHEMA_VERSION`; the schema and the file format are the
reference's (:mod:`repro.obs.ledger`), so each package's
:func:`load_ledger` reads the other's files.
"""
from __future__ import annotations

import atexit
import json
import math
import os
from typing import Any, Dict, List, Optional

__all__ = [
    "LEDGER_SCHEMA_VERSION",
    "ONE_MINUS_INV_E",
    "CERT_TOL",
    "DecisionLedger",
    "enable_ledger",
    "disable_ledger",
    "get_ledger",
    "enable_ledger_from_env",
    "ingest_sparse_trace",
    "load_ledger",
    "why_text",
]

#: Version stamp of the decision-ledger JSONL records.
LEDGER_SCHEMA_VERSION = 1

#: The Theorem-2 guarantee line: 1 − 1/e ≈ 0.6321.
ONE_MINUS_INV_E = 1.0 - 1.0 / math.e

#: Slack on the certificate comparison (float summation order).
CERT_TOL = 1e-9

_LEDGER: Optional["DecisionLedger"] = None


class DecisionLedger:
    """Ring of per-placement-instance pick records.

    One *record* covers one greedy placement run (one serving tick, or
    one standalone ``egp_np`` call). Within it, every candidate the
    greedy considered becomes a *pick* entry; ``placed`` distinguishes
    actual placements from infeasible/zero-benefit rejections.
    """

    def __init__(self, *, capacity: int = 1024) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._n = 0               # monotone; slot = n % capacity
        self.evicted_records = 0
        self._open: Optional[Dict[str, Any]] = None
        self._emit_queue: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    # record lifecycle (called from core pick loops / controllers)
    # ------------------------------------------------------------------
    def begin(self, *, tick: int = -1, seed: Optional[int] = None,
              algo: str = "egp") -> None:
        """Open a record; an already-open record is closed uncertified
        (standalone ``egp_np`` calls never see an explicit ``end``)."""
        if self._open is not None:
            self._commit(self._open)
        self._open = {
            "ledger_schema": LEDGER_SCHEMA_VERSION,
            "tick": int(tick), "seed": seed, "algo": algo,
            "picks": [],
        }

    def pick(self, *, edge: int, impl: int, benefit: float, gain: float,
             remaining: float, n_candidates: int, rank: int,
             placed: bool, bias: float = 0.0) -> None:
        """Book one greedy consideration (auto-opens a record)."""
        if self._open is None:
            self.begin()
        p: Dict[str, Any] = {
            "seq": len(self._open["picks"]),
            "edge": int(edge), "impl": int(impl),
            "benefit": float(benefit), "gain": float(gain),
            "remaining": float(remaining),
            "n_candidates": int(n_candidates), "rank": int(rank),
            "placed": bool(placed),
        }
        if bias:
            p["bias"] = float(bias)
        self._open["picks"].append(p)

    def end(self, *, sigma: Optional[float] = None,
            sigma_bound: Optional[float] = None) -> Dict[str, Any]:
        """Close the open record, attaching the certificate."""
        rec = self._open if self._open is not None else {
            "ledger_schema": LEDGER_SCHEMA_VERSION,
            "tick": -1, "seed": None, "algo": "egp", "picks": []}
        self._open = None
        self._commit(rec, sigma=sigma, sigma_bound=sigma_bound)
        return rec

    def _commit(self, rec: Dict[str, Any], *,
                sigma: Optional[float] = None,
                sigma_bound: Optional[float] = None) -> None:
        gains = [p["gain"] for p in rec["picks"] if p["placed"]]
        rec["n_picks"] = len(rec["picks"])
        rec["n_placed"] = len(gains)
        rec["gain_sum"] = float(sum(gains))
        # the live submodular gain curve: cumulative gain after each
        # placed pick — concave (non-increasing increments per edge)
        curve, acc = [], 0.0
        for g in gains:
            acc += g
            curve.append(acc)
        rec["gain_curve"] = curve
        if sigma is not None:
            rec["sigma"] = float(sigma)
        if sigma_bound is not None:
            rec["sigma_bound"] = float(sigma_bound)
            if sigma is not None:
                bound = float(sigma_bound)
                ratio = (float(sigma) / bound) if bound > 0 else 1.0
                rec["ratio"] = ratio
                rec["cert_ok"] = ratio >= ONE_MINUS_INV_E - CERT_TOL
        slot = self._n % self.capacity
        if self._ring[slot] is not None:
            self.evicted_records += 1
        self._ring[slot] = rec
        self._n += 1
        if len(self._emit_queue) >= self.capacity:
            self._emit_queue.pop(0)
        self._emit_queue.append(rec)

    # ------------------------------------------------------------------
    # reads / export
    # ------------------------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        """Committed records, oldest first."""
        n = min(self._n, self.capacity)
        start = self._n - n
        return [self._ring[i % self.capacity]
                for i in range(start, self._n)]

    def record_for(self, tick: int) -> Optional[Dict[str, Any]]:
        """Latest committed record for ``tick``."""
        for rec in reversed(self.records()):
            if rec["tick"] == tick:
                return rec
        return None

    def drain_emits(self) -> List[Dict[str, Any]]:
        out, self._emit_queue = self._emit_queue, []
        return out

    def to_jsonl(self) -> str:
        return "".join(json.dumps(rec, sort_keys=True) + "\n"
                       for rec in self.records())

    def save(self, path: str) -> None:
        from .trace import _atomic_write_text
        _atomic_write_text(path, self.to_jsonl())


# ----------------------------------------------------------------------
# install / uninstall (wires the core's sink attribute)
# ----------------------------------------------------------------------
def _set_core_sink(led: Optional[DecisionLedger]) -> None:
    # obs → core import happens here, at enable time, never at import
    # time — the core stays free of any obs dependency and its
    # disabled-path cost is one attribute load + `is None`.
    from repro_torch.core import placement
    placement._DECISION_SINK = led


def enable_ledger(*, capacity: int = 1024) -> DecisionLedger:
    """Install a fresh global :class:`DecisionLedger` and return it."""
    global _LEDGER
    _LEDGER = DecisionLedger(capacity=capacity)
    _set_core_sink(_LEDGER)
    return _LEDGER


def disable_ledger() -> Optional[DecisionLedger]:
    """Remove the global ledger; returns it for final export."""
    global _LEDGER
    led, _LEDGER = _LEDGER, None
    _set_core_sink(None)
    return led


def get_ledger() -> Optional[DecisionLedger]:
    return _LEDGER


def enable_ledger_from_env() -> Optional[DecisionLedger]:
    """``REPRO_OBS_LEDGER=<path>`` → ledger on, JSONL saved on exit."""
    path = os.environ.get("REPRO_OBS_LEDGER")
    if not path or _LEDGER is not None:
        return _LEDGER
    led = enable_ledger()

    def _save() -> None:
        if get_ledger() is led:
            led.save(path)

    atexit.register(_save)
    return led


def ingest_sparse_trace(led: DecisionLedger, trace: Dict[str, Any], *,
                        tick: int = -1, seed: Optional[int] = None,
                        sigma: Optional[float] = None,
                        sigma_bound: Optional[float] = None
                        ) -> Dict[str, Any]:
    """Convert an ``egp_place_sparse_torch(..., with_trace=True)`` trace
    into one ledger record (its tensors are moved to the host once, here). Picks are booked in lock-step order
    (iteration-major, then edge), rank 0 by construction (the sparse
    loop takes the per-edge benefit argmax). Gains were accumulated in
    f32 inside the device loop — their sum matches ``sigma_sparse_torch``
    to f32 summation order (documented tolerance ~1e-3 relative)."""
    import numpy as np

    def host(a):
        return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)

    pick = host(trace["pick"])
    placed = host(trace["placed"])
    benefit = host(trace["benefit"])
    gain = host(trace["gain"])
    remaining = host(trace["remaining"])
    ncand = host(trace["n_candidates"])
    n_iters = int(trace.get("n_iters", pick.shape[0]))
    led.begin(tick=tick, seed=seed, algo="egp_sparse")
    E = pick.shape[1]
    for it in range(min(n_iters, pick.shape[0])):
        for e in range(E):
            p = int(pick[it, e])
            if p < 0:
                continue
            led.pick(edge=e, impl=p, benefit=float(benefit[it, e]),
                     gain=float(gain[it, e]),
                     remaining=float(remaining[it, e]),
                     n_candidates=int(ncand[it, e]), rank=0,
                     placed=bool(placed[it, e]))
    return led.end(sigma=sigma, sigma_bound=sigma_bound)


# ----------------------------------------------------------------------
# offline readers (CLI `why`)
# ----------------------------------------------------------------------
def load_ledger(path: str) -> List[Dict[str, Any]]:
    """Load ledger records — from a :meth:`DecisionLedger.save` JSONL
    file (either package's) or a stream file carrying ``ledger`` frames."""
    records: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if obj.get("type") == "ledger":       # stream frame
                obj = obj["payload"]
            if "ledger_schema" not in obj:
                continue
            have = obj["ledger_schema"]
            if have != LEDGER_SCHEMA_VERSION:
                raise ValueError(
                    f"unreadable ledger schema v{have} (this reader "
                    f"understands v{LEDGER_SCHEMA_VERSION})")
            records.append(obj)
    return records


def why_text(rec: Dict[str, Any], edge: Optional[int] = None) -> str:
    """Render one ledger record as the ``why`` pick table + gain curve."""
    picks = rec.get("picks", [])
    if edge is not None:
        picks = [p for p in picks if p["edge"] == edge]
    head = (f"placement tick={rec.get('tick')} algo={rec.get('algo')} "
            f"picks={rec.get('n_picks')} placed={rec.get('n_placed')}")
    if edge is not None:
        head += f" (edge {edge}: {len(picks)} pick(s))"
    lines = [head,
             f"  {'seq':>4} {'edge':>4} {'impl':>4} {'benefit':>10} "
             f"{'gain':>10} {'remaining':>10} {'cands':>5} {'rank':>4} "
             f"placed"]
    acc = 0.0
    for p in picks:
        if p["placed"]:
            acc += p["gain"]
        bias = f" bias={p['bias']:.3g}" if "bias" in p else ""
        lines.append(
            f"  {p['seq']:>4} {p['edge']:>4} {p['impl']:>4} "
            f"{p['benefit']:>10.4f} {p['gain']:>10.4f} "
            f"{p['remaining']:>10.3f} {p['n_candidates']:>5} "
            f"{p['rank']:>4} {'yes' if p['placed'] else 'no '}{bias}")
    curve = rec.get("gain_curve", [])
    if curve:
        lines.append("  gain curve: "
                     + " → ".join(f"{g:.4f}" for g in curve[:16])
                     + (" …" if len(curve) > 16 else ""))
    if "sigma" in rec:
        lines.append(f"  sigma(greedy) = {rec['sigma']:.6f}   "
                     f"gain_sum = {rec['gain_sum']:.6f}")
    if "sigma_bound" in rec and "ratio" in rec:
        ok = bool(rec.get("cert_ok"))
        verdict = ("OK" if ok else
                   "BELOW LINE (bound is a relaxation — investigate, "
                   "not necessarily a violation)")
        lines.append(
            f"  certificate: sigma/bound = {rec['sigma']:.4f}/"
            f"{rec['sigma_bound']:.4f} = {rec['ratio']:.4f} "
            f"{'≥' if ok else '<'} 1−1/e = {ONE_MINUS_INV_E:.4f} → "
            f"{verdict}")
    return "\n".join(lines)
