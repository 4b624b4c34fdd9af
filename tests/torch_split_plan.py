"""The split-bf16 precision plan of the SSD scan's tensor-core kernels
(``csrc/ssd_scan.cu``, B8, and ``csrc/ssd_scan_bwd.cu``, its backward),
emulated on the CPU: the terms a float32 operand enters a product as, and
each 16-deep k-step summed apart. ``tests/test_torch_ssd.py`` rehearses
the forward with it, ``tests/test_torch_ssd_bwd.py`` the backward. Imports
neither JAX nor the reference."""
import torch

#: The kernels' scale-free gate against a plain version (chip_smoke.py
#: SSD_TOL: the reference's 3e-4 kernel tolerance, tests/test_kernels.py).
SSD_TOL = 3e-4
#: Each plan: the terms a float32 operand enters a tensor-core product as,
#: and the (A term, B term) products summed. "bf16x3" is the kernels':
#: hi = bf16(x), lo = bf16(x - hi), and lo·hi + hi·lo + hi·hi (lo·lo, about
#: 2^-18 of the product, is dropped). The one-term plans are its controls.
PLANS = {"bf16x3": ("bf16", 2, ((1, 0), (0, 1), (0, 0))),
         "bf16x1": ("bf16", 1, ((0, 0),)),
         "tf32x1": ("tf32", 1, ((0, 0),))}
#: Products are summed over k in chunks of this depth (one mma.sync), each
#: in a zeroed float32 fragment that is then added to the accumulator.
K_CHUNK = 16


def _round_tf32(t):
    """``t`` rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    i = t.view(torch.int32)
    return ((i + (1 << 12)) & -(1 << 13)).view(torch.float32)


def _terms(t, kind: str, n: int) -> list:
    rnd = ((lambda u: u.to(torch.bfloat16).float()) if kind == "bf16"
           else _round_tf32)
    out, rest = [], t.float()
    for _ in range(n):
        out.append(rnd(rest))
        rest = rest - out[-1]
    return out


def _plan_mm(a, b, plan: str):
    """``a [..., M, K] @ b [..., K, N]`` as the kernels form it: operands as
    the plan's terms, each product in float32, each K_CHUNK-deep chunk of
    k summed apart and added to the float32 result in order."""
    kind, n, pairs = PLANS[plan]
    at, bt = _terms(a, kind, n), _terms(b, kind, n)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], K_CHUNK):
        d = torch.zeros_like(acc)
        for i, j in pairs:
            d = d + at[i][..., k0:k0 + K_CHUNK] @ bt[j][..., k0:k0 + K_CHUNK, :]
        acc = acc + d
    return acc
