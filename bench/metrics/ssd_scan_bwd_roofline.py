"""The SSD scan's backward against its roofline: the least time the card
could take for the traced steps' backward scans (one a Mamba2 layer a
step, ``costs.kernels.ssd_scan_bwd_cost`` at the cell's shapes and the
configuration's chunk; float32 inputs, so operations at the tensor cores'
TF32 rate, bytes at the HBM rate) over the device time of the kernels
named below, in percent."""
import re

KERNELS = re.compile(r"ssd_bwd_")


def read(view):
    r, tr = view.record, view.trace
    steps = r["traced"]["steps"]
    if tr is None or not steps:
        return None
    spent = sum(tr.seconds_by_name(lambda n: bool(KERNELS.search(n)))
                .values())
    if spent <= 0:
        return None
    c = view.config
    din = c.get("ssm_expand", 2) * c["d_model"]
    P = c.get("ssm_head_dim", 64)
    cost = view.kernels.ssd_scan_bwd_cost(
        r["batch"], r["seq_len"], din // P, P, c["ssm_state"],
        c.get("ssm_chunk", 256), False)
    bound = view.kernels.bound_s(cost, view.peaks["tf32_flops_per_s"],
                                 view.peaks["hbm_bytes_per_s"])
    return 100 * bound * c["n_layers"] * steps / spent
