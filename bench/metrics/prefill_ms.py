"""Milliseconds of a prefill: the prefill seconds each ``generate`` call
of the (untraced) window returns, the mean over calls."""


def read(view):
    calls = view.record.get("calls")
    if not calls:
        return None
    return 1e3 * sum(c["prefill_s"] for c in calls) / len(calls)
