"""The first-step loss gap that phase 25 of chip_smoke.py gates (the mesh's
bfloat16 loss against one device's, relative), measured in the reference
and in the port at the same small configuration on the CPU:

    python tests/torch_mesh_bf16_gap.py

The reference (tests/torch_mesh_reference.py ``gap``, a subprocess with 4
host devices) computes GAP_ARCH's smoke config in bfloat16 on one device
and on each GAP_SHAPES Auto mesh with ``sp_matmuls``; the port computes
the same from the reference's parameters on 4 gloo ranks (data, model) =
each shape, and on one device. Prints one line a shape and one JSON
object."""
from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_ranks as R  # noqa: E402


def main() -> None:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        import numpy as np

        ref = R.run_reference(tmp, "gap")
        want = dict(np.load(ref))
        for shape in R.GAP_SHAPES:
            key = f"{shape[0]}{shape[1]}"
            ranks = R.spawn(R.gap_case, shape[0] * shape[1],
                            os.path.join(tmp, key), ref, shape)
            one_ref = float(want["gap/one"])
            got = dict(
                reference=abs(float(want[f"gap/{key}"]) - one_ref)
                / abs(one_ref),
                port=abs(ranks[0]["mesh"] - ranks[0]["one"])
                / abs(ranks[0]["one"]),
                reference_losses=(one_ref, float(want[f"gap/{key}"])),
                port_losses=(ranks[0]["one"], ranks[0]["mesh"]))
            out[key] = got
            print(f"{R.GAP_ARCH} smoke bf16 {R.GAP_B}x{R.GAP_S}, mesh "
                  f"{shape}: |mesh - one device| / one device: reference "
                  f"{got['reference']:.3g}, port {got['port']:.3g}",
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
