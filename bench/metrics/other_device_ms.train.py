"""Device milliseconds a training step in operations that are neither
matrix products from the library nor the port's own kernels (elementwise
passes, casts, reductions, copies, the optimizer), from the traced
window, over its steps."""
import re

GEMM = re.compile(r"nvjet|gemm|xmma|cutlass|cublas", re.I)
PORT = re.compile(r"ssd_|flash_attention|gqa_decode|qos_|topk_candidates|"
                  r"greedy_argmax")


def read(view):
    steps = view.record["traced"]["steps"]
    if not steps or view.trace is None or not view.trace.device:
        return None
    ms = 1e3 * sum(view.trace.seconds_by_name(
        lambda n: not GEMM.search(n) and not PORT.search(n)).values())
    return ms / steps
