"""Model FLOPs of the window's generate calls (``costs.model.generate_flops``:
each prefill and every decode step it runs) over the time from the first
call's start to the last one's end, untraced, and the card's bf16
peak, in percent."""


def read(view):
    r = view.record
    if not r.get("calls"):
        return None
    flops = sum(view.model.generate_flops(
        view.config, r["batch"], c["len"], r["new_tokens"], r["bucket_seq"])
        for c in r["calls"])
    return 100 * flops / r["span_s"] / view.peaks["bf16_flops_per_s"]
