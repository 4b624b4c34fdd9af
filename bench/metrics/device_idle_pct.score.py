"""The share of the untraced window in which the card ran nothing, in
percent: one less the device time the window's calls would take, each
its prompt length's mean device time over the traced calls (the union of
the operations inside each call's range), over the time from the
window's first call's start to its last one's end. The profiler slows the
host's dispatch, so the traced calls' own gaps would read its cost; the
device time a call is what it does not change."""
from statistics import mean

from bench.tracing import CALL


def read(view):
    r, tr = view.record, view.trace
    if tr is None or not tr.device:
        return None
    by_len = {}
    for (a, b), call in zip(tr.ranges(CALL), r["traced"]["calls"]):
        by_len.setdefault(call["len"], []).append(tr.busy_between(a, b))
    if not r["calls"] or any(c["len"] not in by_len for c in r["calls"]):
        return None
    busy = sum(mean(by_len[c["len"]]) for c in r["calls"])
    return 100 * (1 - busy / r["span_s"])
