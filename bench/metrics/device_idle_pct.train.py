"""The share of the untraced window in which the card ran nothing, in
percent: one less the device time a step, from the traced steps (the
union of their operations), over the wall time a step of the window. The
profiler slows the host's dispatch, so the traced window's own gaps
would read its cost; the device time a step is what it does not change."""


def read(view):
    r, tr = view.record, view.trace
    steps = r["traced"]["steps"]
    if tr is None or not tr.device or not steps or not r["steps"]:
        return None
    busy = tr.busy_s() / steps
    wall = r["window_s"] / r["steps"]
    return 100 * (1 - busy / wall)
