"""A copy of the benchmark in a temporary checkout whose configurations
and traffic are cut to a size the CPU runs in a second, for the tests."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "mamba2-2p7b": dict(n_layers=2, d_model=64, vocab_size=256,
                        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                        init_std=0.2),
}
#: A hybrid of the same cut: two alternating shared attention + MLP
#: blocks after every second Mamba2 layer, as the port runs the family
#: (no cell holds one yet; the reference, weights and costs serve it).
TINY_HYBRID = dict(TINY_CONFIG["mamba2-2p7b"], name="hybrid-tiny",
                   family="hybrid", n_layers=4, n_heads=4, n_kv_heads=4,
                   head_dim=16, d_ff=128, shared_attn_every=2,
                   n_shared_blocks=2, tie_embeddings=False,
                   rope_theta=1e6, act="silu")
TINY_TRAFFIC = {
    "train-4k": dict(batch=2, seq_len=16, trace_steps=2),
    "score-1k": dict(batch=4, prompt_lens=[8, 16, 24], new_tokens=1,
                     bucket_seq=25, calls_per_s=1000.0, check_rows=6,
                     trace_calls=3),
}


#: The numbers the tiny cells compare, by driver.
NUMBERS = {"train": ("loss_gap", "grad_norm_gap", "change_norm_gap"),
           "generate": ("logit_gap",)}


def checkout(tmp: Path, limits: dict | None = None) -> Path:
    """``tmp`` holding ``BENCHMARK.json``, a copy of ``bench/`` with the
    tiny sizes, and the program's ``src`` (linked). ``limits`` replaces
    every cell's limits (default: generous ones that sound tiny runs
    meet)."""
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(REPO / "src")
    for name, cut in TINY_CONFIG.items():
        edit(root / "bench" / "configs" / f"{name}.json", cut)
    for name, cut in TINY_TRAFFIC.items():
        edit(root / "bench" / "traffic" / f"{name}.json", cut)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        tr = json.loads((root / "bench" / "traffic" /
                         f"{cell['traffic']}.json").read_text())
        path = root / "bench" / "limits" / f"{cell['name']}.json"
        path.write_text(json.dumps({"limits": {
            k: (limits or {}).get(k, 0.5) for k in NUMBERS[tr["driver"]]}}))
    return root


def edit(path: Path, changes: dict) -> None:
    doc = json.loads(path.read_text())
    doc.update(changes)
    path.write_text(json.dumps(doc, indent=1))
