"""Model FLOPs of the window's steps (``costs.model.train_step_flops``)
over their wall time, untraced, and the card's bf16 peak, in percent."""


def read(view):
    r = view.record
    if not r.get("steps"):
        return None
    flops = view.model.train_step_flops(view.config, r["batch"],
                                        r["seq_len"]) * r["steps"]
    return 100 * flops / r["window_s"] / view.peaks["bf16_flops_per_s"]
