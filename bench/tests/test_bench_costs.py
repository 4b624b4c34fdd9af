"""The frozen costs at the cells' shapes, and at those of the hybrid's
cells left for later (a zamba2-sized hybrid as the port runs it), against
values worked out by hand from the formulas (2 operations a multiply-add,
float32 scan tensors, bf16 attention tensors)."""
import json
from pathlib import Path

from bench.costs import kernels as K
from bench.costs import model as M

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


#: The port's zamba2-2.7b as it runs it (shared blocks over the 2,560-wide
#: stream): the hybrid's sizes for its FLOP count.
HYBRID = dict(_cfg("mamba2-2p7b"), family="hybrid", n_layers=54,
              ssm_state=64, n_heads=32, n_kv_heads=32, head_dim=80,
              d_ff=10240, vocab_size=32000, shared_attn_every=6,
              n_shared_blocks=2, tie_embeddings=False)


def test_ssd_backward_at_the_training_cells():
    # mamba2: B 2, L 4,096, H 80, P 64, N 128, chunk 256: 16 chunks of
    # 32,896 visible pairs; bytes of x, dy, dx, dtA, ddtA, b, c, db, dc,
    # the 16 entering states and decays, and dinit
    assert tuple(K.ssd_scan_bwd_cost(2, 4096, 80, 64, 128, 256, False)) \
        == (65316847616, 614475776)
    assert tuple(K.ssd_scan_bwd_cost(2, 4096, 80, 64, 64, 256, False)) \
        == (43437785088, 561522688)


def test_ssd_forward_at_the_serving_cells():
    assert tuple(K.ssd_scan_cost(8, 2048, 80, 64, 128, 256, False)) \
        == (65047363584, 714080256)
    assert tuple(K.ssd_scan_cost(128, 512, 80, 64, 64, 256, False)) \
        == (173212172288, 2906652672)


def test_attention_at_the_hybrids_shapes():
    # 8,390,656 causal pairs of 4,096 positions, 32 heads of 80
    assert K.visible_pairs(4096, 4096, True, 0) == 4096 * 4097 // 2
    assert tuple(K.flash_attention_cost(2, 4096, 4096, 32, 32, 80, 2)) \
        == (171840634880, 168820736)
    bwd = K.flash_attention_bwd_cost(2, 4096, 4096, 32, 32, 80, 2)
    assert tuple(bwd["flash_attention_dq"]) == (257760952320, 211812352)
    assert tuple(bwd["flash_attention_dkv"]) == (343681269760, 253755392)
    assert tuple(K.flash_attention_cost(128, 512, 512, 32, 32, 80, 2)) \
        == (172134236160, 1350565888)


def test_decode_attention_first_step_at_the_hybrids_decode_shape():
    slots = K.decode_slots([513] * 128, 576)
    assert slots == 65664
    assert tuple(K.gqa_decode_cost(128, 32, 1, 80, 2, slots)) \
        == (672399360, 673710592)


def test_model_flops():
    m, z = _cfg("mamba2-2p7b"), HYBRID
    # in_proj 2560 x 10576 and out_proj 5120 x 2560, 64 layers; the tied
    # head of 50,288 rows
    assert M.body_params(m) == 64 * (2560 * 10576 + 5120 * 2560)
    # 54 layers of 2560 x 10448 + 5120 x 2560; 9 shared applications of
    # 4 projections 2560 x 2560 and a 3 x 2560 x 10240 MLP
    assert M.body_params(z) == 54 * (2560 * 10448 + 5120 * 2560) \
        + 9 * (4 * 2560 * 2560 + 3 * 2560 * 10240)
    assert M.train_step_flops(m, 2, 4096) == 138990376189952.0
    assert M.train_step_flops(z, 2, 4096) == 166667564875776.0
    assert M.generate_flops(z, 128, 512, 64, 576) == 469901667991552.0
    assert [M.generate_flops(m, 8, L, 1, 2049) for L in (512, 1024, 2048)] \
        == [22154515841024.0, 44262088245248.0, 88477233053696.0]


def test_bound_is_the_larger_side():
    c = K.KernelCost(flops=989e12, bytes=3.35e12)
    assert K.bound_s(c, 989e12, 3.35e12) == 1.0
    assert K.bound_s(K.KernelCost(2.0, 1.0), 1.0, 4.0) == 2.0
