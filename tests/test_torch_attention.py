"""The port's attention kernels (B4 flash-attention forward, B7 GQA decode):
their plain PyTorch versions against the JAX reference (the Pallas kernels
in interpret mode, their jnp oracles and the model layer's jnp twins) on
the same seeded inputs, the dispatchers' device rules and the wrappers'
guards, and — on a CUDA card only — each CUDA kernel against its plain
version.

JAX is imported by a fixture, so this file also runs where only the port
is installed (as on a card without JAX): the JAX comparisons skip there and
the kernel tests run."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gqa_decode as gd
from repro_torch.kernels.flash_attention.ref import NEG, SAFE
from test_torch_flash_bwd import (BF16_ULPS, FRAGMENT_EDGE_CASES,
                                  REHEARSAL_CASES, _bf16_terms, _bf16_ulps,
                                  _visible)

#: The reference's own tolerances (tests/test_kernels.py).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def jref():
    """The JAX reference's attention kernels, oracles and layer twins."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.flash_attention import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref
    from repro.kernels.gqa_decode.gqa_decode import gqa_decode
    from repro.kernels.gqa_decode.ref import gqa_decode_ref
    from repro.models.layers import decode_attention_jnp

    return types.SimpleNamespace(
        jnp=jnp, flash_attention=flash_attention, attention_ref=attention_ref,
        gqa_decode=gqa_decode, gqa_decode_ref=gqa_decode_ref,
        decode_attention_jnp=decode_attention_jnp)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device="cpu"):
    """Seeded normal values, rounded to ``dtype`` once, as a torch tensor
    (and the same values as float32 NumPy for JAX)."""
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return t.to(getattr(torch, dtype)).to(device)


def _np(t):
    return t.float().cpu().numpy()


def _jx(jref, t, dtype):
    return jref.jnp.asarray(_np(t), getattr(jref.jnp, dtype))


# ===========================================================================
# B4 flash attention: plain version vs the reference
# ===========================================================================

FLASH_CASES = [  # (B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap)
    (1, 80, 80, 4, 2, 32, True, 0, 0.0),
    (1, 80, 80, 4, 2, 32, True, 24, 0.0),
    (2, 80, 80, 4, 2, 32, False, 0, 0.0),
    (1, 80, 80, 4, 2, 32, True, 0, 50.0),
    (1, 50, 70, 6, 2, 16, False, 0, 0.0),     # ragged, Sq != Skv
    (1, 70, 70, 3, 1, 64, True, 16, 30.0),    # window + softcap, G = 3
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_attention_ref_matches_jax_flash_and_oracle(jref, dtype, case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, Hq, hd), dtype)
    k = _randn(rng, (B, Skv, Hkv, hd), dtype)
    v = _randn(rng, (B, Skv, Hkv, hd), dtype)
    out, lse = fa.attention_ref(q, k, v, causal=causal, window=window,
                                softcap=softcap, return_lse=True)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    jq, jk, jv = (_jx(jref, t, dtype) for t in (q, k, v))
    jout, jlse = jref.flash_attention(
        jq, jk, jv, causal=causal, window=window, softcap=softcap,
        block_q=32, block_kv=32, interpret=True, return_lse=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                                softcap=softcap)
    tol = TOL[dtype]
    for ref in (jout, oracle):
        np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=tol,
                               rtol=tol)


def test_attention_dispatcher_device_rules():
    rng = np.random.default_rng(1)
    q = _randn(rng, (1, 9, 2, 32), "float32")
    k = _randn(rng, (1, 9, 1, 32), "float32")
    ref = fa.attention_ref(q, k, k)
    assert torch.equal(fa.attention(q, k, k), ref)        # CPU → plain
    assert torch.equal(fa.attention(q, k, k, use_kernel=False), ref)
    with pytest.raises(ValueError, match="CUDA"):
        fa.attention(q, k, k, use_kernel=True)             # no fallback


@pytest.mark.parametrize("bad", ["hd", "dtype", "groups"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 4, 32)
    k = torch.zeros(1, 4, 2, 32)
    if bad == "hd":
        q, k = q[..., :16].contiguous(), k[..., :16].contiguous()
    elif bad == "dtype":
        q, k = q.half(), k.half()
    else:
        k = torch.zeros(1, 4, 3, 32)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_cuda(q, k, k)
    assert fa.LAUNCHES["flash_attention"] == 0


def _flash_bf16_emulated(q, k, v, *, causal, window, terms):
    """The bf16 B4 kernel's arithmetic: float32 scores of the bf16 q and k
    (exact products), the online softmax over 64-key tiles with the
    kernel's sentinels and the row sum taken from the unrounded P, and
    P·V with the float32 P split into ``terms`` bf16 terms, each
    multiplied into one float32 accumulator."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    ok = _visible(Sq, Skv, causal, window)
    m = torch.full(qf.shape[:-1], NEG)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, Skv, 64):
        tile = slice(k0, k0 + 64)
        s = qf @ kf[..., tile, :].transpose(-1, -2) * (1.0 / hd ** 0.5)
        s = torch.where(ok[:, tile], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = m_new.clamp_min(SAFE)
        corr = torch.where(m > 0.5 * NEG,
                           torch.exp(m.clamp_min(SAFE) - m_safe), 0.0)
        p = torch.exp(s - m_safe[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + sum(
            t @ vf[..., tile, :] for t in _bf16_terms(p, terms))
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


@pytest.mark.parametrize("case", REHEARSAL_CASES, ids=str)
def test_bf16_split_of_p_holds_the_ulp_gate(case):
    """B4 multiplies P, computed in float32, into a bf16 tensor-core product
    as two bf16 terms (hi + lo): the output then lands within the card's
    gate of the plain version, 2 bf16 ulps + 1e-5. The control, one bf16
    term, lands far above it, so the gate tells the two apart."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale = case
    rng = np.random.default_rng(10)
    q = _randn(rng, (B, Sq, Hq, hd), "bfloat16") * q_scale
    k = _randn(rng, (B, Skv, Hkv, hd), "bfloat16")
    v = _randn(rng, (B, Skv, Hkv, hd), "bfloat16")
    kw = dict(causal=causal, window=window)
    ref = fa.attention_ref(q, k, v, **kw)
    assert _bf16_ulps(_flash_bf16_emulated(q, k, v, terms=2, **kw),
                      ref) <= BF16_ULPS
    assert _bf16_ulps(_flash_bf16_emulated(q, k, v, terms=1, **kw),
                      ref) > BF16_ULPS


# ===========================================================================
# B7 GQA decode: plain version vs the reference
# ===========================================================================

DECODE_CASES = [  # (B, Hq, Hkv, hd, Sc, kv_len, window, ring, softcap)
    (3, 8, 2, 32, 96, (3, 64, 96), 0, False, 0.0),
    (3, 8, 2, 32, 96, (3, 64, 96), 16, False, 0.0),
    (3, 8, 2, 32, 96, (3, 64, 200), 0, True, 0.0),
    (3, 6, 2, 64, 64, (1, 40, 64), 0, False, 50.0),
    (2, 4, 2, 16, 40, (50, 30), 0, True, 0.0),    # ring, Sc % 32 != 0
    (2, 15, 5, 32, 48, (200, 7), 0, False, 0.0),  # kv_len > Sc, G = 3
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_gqa_decode_ref_matches_jax_oracle_and_layer(jref, dtype, case):
    B, Hq, Hkv, hd, Sc, kv_len, window, ring, softcap = case
    rng = np.random.default_rng(2)
    q = _randn(rng, (B, Hq, hd), dtype)
    kc = _randn(rng, (B, Sc, Hkv, hd), dtype)
    vc = _randn(rng, (B, Sc, Hkv, hd), dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32)
    out = gd.gqa_decode_ref(q, kc, vc, lens, window=window, ring=ring,
                            softcap=softcap)
    assert out.dtype == q.dtype and out.shape == q.shape
    jq, jk, jv = (_jx(jref, t, dtype) for t in (q, kc, vc))
    jl = jref.jnp.asarray(np.asarray(kv_len, np.int32))
    refs = [jref.gqa_decode_ref(jq, jk, jv, jl, window=window, ring=ring,
                                softcap=softcap),
            jref.decode_attention_jnp(jq, jk, jv, jl, window=window,
                                      attn_softcap=softcap, ring=ring)]
    if Sc % 32 == 0:   # the Pallas kernel attends its padding (ROADMAP §C)
        refs.append(jref.gqa_decode(jq, jk, jv, jl, window=window, ring=ring,
                                    softcap=softcap, block_kv=32,
                                    interpret=True))
    tol = TOL[dtype]
    for ref in refs:
        np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)


def test_decode_valid_mask_keeps_ring_slots_inside_the_cache():
    lens = torch.tensor([50, 30, 40, 41], dtype=torch.int32)
    ok = gd.decode_valid_mask(lens, 40, ring=True)
    assert ok.shape == (4, 40)
    assert ok[0].all() and ok[2].all() and ok[3].all()
    assert ok[1, :30].all() and not ok[1, 30:].any()
    win = gd.decode_valid_mask(torch.tensor([20], dtype=torch.int32), 40,
                               window=8)
    assert win[0].nonzero().flatten().tolist() == list(range(12, 20))


def test_decode_dispatcher_device_rules():
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 4, 32), "float32")
    kc = _randn(rng, (2, 16, 2, 32), "float32")
    lens = torch.tensor([5, 16], dtype=torch.int32)
    ref = gd.gqa_decode_ref(q, kc, kc, lens)
    assert torch.equal(gd.decode_attention(q, kc, kc, lens), ref)
    assert torch.equal(gd.decode_attention(q, kc, kc, lens,
                                           use_kernel=False), ref)
    with pytest.raises(ValueError, match="CUDA"):
        gd.decode_attention(q, kc, kc, lens, use_kernel=True)
    with pytest.raises(ValueError, match="head dim"):
        gd.gqa_decode_cuda(q[..., :16].contiguous(),
                           kc[..., :16].contiguous(),
                           kc[..., :16].contiguous(), lens)
    assert gd.LAUNCHES["gqa_decode"] == 0


# ===========================================================================
# CUDA kernels vs their plain versions (card only)
# ===========================================================================

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    c for c in FLASH_CASES if c[5] in fa.HEAD_DIMS] + [
    (2, 300, 300, 15, 5, 64, True, 0, 0.0),
    (1, 200, 333, 8, 2, 128, False, 100, 50.0),
    (1, 1, 65, 2, 1, 32, True, 0, 0.0),
    (1, 300, 300, 32, 32, 80, True, 0, 0.0),   # zamba2's shared blocks
], ids=str)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap = case
    rng = np.random.default_rng(4)
    q = _randn(rng, (B, Sq, Hq, hd), dtype, cuda)
    k = _randn(rng, (B, Skv, Hkv, hd), dtype, cuda)
    v = _randn(rng, (B, Skv, Hkv, hd), dtype, cuda)
    n0 = fa.LAUNCHES["flash_attention"]
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    ref, ref_lse = fa.attention_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, return_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    _check_flash(out, lse, ref, ref_lse, dtype)


def _check_flash(out, lse, ref, ref_lse, dtype):
    """B4's output and lse against the plain version's: within the
    reference's tolerance, and a bf16 output also within the ulp gate
    (2 bf16 ulps + 1e-5)."""
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=0)
    if dtype == "bfloat16":
        assert _bf16_ulps(out, ref) <= BF16_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FRAGMENT_EDGE_CASES, ids=str)
def test_flash_kernel_at_fragment_edges(cuda, dtype, case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale = case
    rng = np.random.default_rng(12)
    q = _randn(rng, (B, Sq, Hq, hd), dtype, cuda) * q_scale
    k = _randn(rng, (B, Skv, Hkv, hd), dtype, cuda)
    v = _randn(rng, (B, Skv, Hkv, hd), dtype, cuda)
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_cuda(q, k, v, **kw)
    ref, ref_lse = fa.attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    _check_flash(out, lse, ref, ref_lse, dtype)


@pytest.mark.cuda
def test_flash_kernel_is_deterministic(cuda):
    rng = np.random.default_rng(13)
    q = _randn(rng, (2, 300, 15, 64), "bfloat16", cuda)
    k = _randn(rng, (2, 300, 5, 64), "bfloat16", cuda)
    v = _randn(rng, (2, 300, 5, 64), "bfloat16", cuda)
    first = fa.flash_attention_cuda(q, k, v)
    again = fa.flash_attention_cuda(q, k, v)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


#: B7's split plan at its edges (B, Hq, Hkv, hd, Sc, kv_len, window, ring,
#: softcap): rows of 1, 7, 64 and 65 slots over 8 splits (empty and one-slot
#: splits), a window narrower than the 8 splits x 64 slots, ring past an Sc
#: that is no multiple of 64, kv_len 0 with G = 8 (two chunks of 4 heads),
#: and G = 5 at hd = 80.
DECODE_SPLIT_EDGE_CASES = [
    (4, 15, 5, 64, 2048, (1, 7, 64, 65), 0, False, 0.0),
    (2, 6, 2, 64, 1024, (1000, 600), 40, False, 0.0),
    (2, 6, 2, 32, 300, (1000, 299), 0, True, 0.0),
    (3, 8, 1, 128, 100, (100, 37, 0), 0, False, 30.0),
    (2, 10, 2, 80, 2048, (1040, 65), 0, False, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    c for c in DECODE_CASES if c[3] in gd.HEAD_DIMS] + [
    (8, 15, 5, 64, 2048, (1, 7, 64, 129, 1000, 1024, 2047, 2048), 0,
     False, 0.0),
    (2, 32, 16, 128, 300, (300, 170), 64, False, 50.0),
    (2, 32, 32, 80, 2048, (1040, 7), 0, False, 0.0),   # zamba2, G = 1
] + DECODE_SPLIT_EDGE_CASES, ids=str)
def test_decode_kernel_matches_plain(cuda, dtype, case):
    B, Hq, Hkv, hd, Sc, kv_len, window, ring, softcap = case
    rng = np.random.default_rng(5)
    q = _randn(rng, (B, Hq, hd), dtype, cuda)
    kc = _randn(rng, (B, Sc, Hkv, hd), dtype, cuda)
    vc = _randn(rng, (B, Sc, Hkv, hd), dtype, cuda)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    n0 = gd.LAUNCHES["gqa_decode"]
    out = gd.gqa_decode_cuda(q, kc, vc, lens, window=window, ring=ring,
                             softcap=softcap)
    ref = gd.gqa_decode_ref(q, kc, vc, lens, window=window, ring=ring,
                            softcap=softcap)
    torch.cuda.synchronize()
    assert gd.LAUNCHES["gqa_decode"] == n0 + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    if dtype == "bfloat16":
        assert _bf16_ulps(out, ref) <= BF16_ULPS


@pytest.mark.cuda
def test_decode_kernel_is_deterministic(cuda):
    """The splits merge in rank order: two calls give the same bits."""
    rng = np.random.default_rng(14)
    q = _randn(rng, (8, 15, 64), "bfloat16", cuda)
    kc = _randn(rng, (8, 2048, 5, 64), "bfloat16", cuda)
    vc = _randn(rng, (8, 2048, 5, 64), "bfloat16", cuda)
    lens = torch.tensor([1040, 1, 7, 64, 65, 2047, 2048, 513],
                        dtype=torch.int32, device=cuda)
    assert torch.equal(gd.gqa_decode_cuda(q, kc, vc, lens),
                       gd.gqa_decode_cuda(q, kc, vc, lens))


@pytest.mark.cuda
def test_attention_wrappers_refuse_misaligned_tensors(cuda):
    """The kernels read q/k/v with 16-byte loads: a view that starts off a
    16-byte boundary is refused, not read."""
    def misaligned(shape):
        n = int(np.prod(shape))
        return torch.zeros(n + 1, device=cuda)[1:].view(shape)

    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(q, misaligned((1, 8, 1, 32)),
                                torch.zeros(1, 8, 1, 32, device=cuda))
    lens = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        gd.gqa_decode_cuda(q[:, 0], misaligned((1, 8, 1, 32)),
                           torch.zeros(1, 8, 1, 32, device=cuda), lens)
