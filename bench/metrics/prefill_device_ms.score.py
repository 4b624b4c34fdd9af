"""Device milliseconds of a prefill: the card's busy time inside the
program's ``serve.prefill`` range of each traced call (the range opens on
an idle card and closes after a synchronisation, so it holds prefill's
operations alone), the mean by prompt length over the traced calls,
weighted by the window's calls as ``prefill_ms`` takes its mean, so the
two compare: their difference is the host's share of a prefill. None
where the program marks no such range."""
from statistics import mean

from bench.tracing import CALL

PREFILL = "serve.prefill"


def read(view):
    r, tr = view.record, view.trace
    if tr is None or not tr.device:
        return None
    prefills = tr.ranges(PREFILL)
    by_len = {}
    for (a, b), call in zip(tr.ranges(CALL), r["traced"]["calls"]):
        inside = [(s, e) for s, e in prefills if a <= s and e <= b]
        if inside:
            by_len.setdefault(call["len"], []).append(
                sum(tr.busy_between(s, e) for s, e in inside))
    calls = r.get("calls")
    if not calls or any(c["len"] not in by_len for c in calls):
        return None
    return 1e3 * sum(mean(by_len[c["len"]]) for c in calls) / len(calls)
