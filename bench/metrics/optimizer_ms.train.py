"""Device milliseconds a training step in the operations the optimizer
launched: those launched inside the program's ``train.optimizer`` ranges
(the global norm and AdamW) within the traced window, over its steps.
None where the program marks no such range.

The trace keeps no correlation ids, and nothing synchronises between the
backward and the optimizer: the card is still running backward
operations when the range opens, and runs the optimizer's last ones after
it closes. So the rule pairs each device operation with its launch by
order. The window opens and closes on an idle card (the cell's training
loop synchronises before and inside it), and the step runs on one stream,
which runs operations in the order they were launched. So the k-th host
launch call that starts inside the window (a kernel launch, an
asynchronous copy or set; a launch call reported inside another one is
the same launch) launched the k-th device operation that starts inside
it, the profiler's synchronisation records left out. An operation is the
optimizer's when its launch call starts inside a ``train.optimizer``
range; its device time is summed."""
import re

OPTIMIZER = "train.optimizer"
#: host calls that put one operation on the device's stream
LAUNCH = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")
#: device records that are no operation of the program
NOT_OP = re.compile(r"Sync|Wait Event")


def launch_times(host, a: float, b: float) -> list:
    """Start times (us) of the launch calls that start in ``[a, b]``, a
    call inside another one's interval taken as that one."""
    out, end = [], float("-inf")
    for s, e in sorted((s, e) for n, s, e in host
                       if a <= s <= b and LAUNCH.match(n)):
        if s >= end:
            out.append(s)
        end = max(end, e)
    return out


def read(view):
    steps = view.record["traced"]["steps"]
    tr = view.trace
    if tr is None or not tr.device or not steps:
        return None
    a, b = tr.window
    ranges = [(s, e) for s, e in tr.ranges(OPTIMIZER) if a <= s and e <= b]
    if not ranges:
        return None
    ops = sorted((s, e) for n, s, e in tr.device
                 if a <= s < b and not NOT_OP.search(n))
    us, i = 0.0, 0
    for t, (s, e) in zip(launch_times(tr.host, a, b), ops):
        while i < len(ranges) and ranges[i][1] < t:
            i += 1
        if i < len(ranges) and ranges[i][0] <= t:
            us += min(e, b) - s
    return us / 1e3 / steps
