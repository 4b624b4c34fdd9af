"""B7's split-KV plan (``csrc/gqa_decode.cu``), rehearsed on the CPU.

The kernel splits each (KV head, row)'s valid cache range over the S
blocks of a thread block cluster (S from ``decode_splits``), runs an
online softmax per stream of lanes inside each block, merges the streams
of a warp by a butterfly, the warps of a block in warp order, and the
blocks in rank order. :func:`_split_plan` repeats that plan in plain
torch, in float32, with the kernel's constants, and the tests hold it
against the port's plain version and the JAX reference's Pallas kernel
(interpret mode) and oracle. JAX is imported by a fixture."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import gqa_decode as gd
from repro_torch.kernels.gqa_decode.ref import NEG, SAFE
from test_torch_flash_bwd import BF16_ULPS, _bf16_ulps

#: The kernel's block: 4 warps; each stream keeps the loads of 4 slots in
#: flight per pass.
WARPS, UNROLL = 4, 4
#: An H100's SMs, as decode_splits reads them on the card.
H100_SMS = 132
F32_TOL = 2e-5


@pytest.fixture
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.gqa_decode.gqa_decode import gqa_decode
    from repro.kernels.gqa_decode.ref import gqa_decode_ref

    return types.SimpleNamespace(jnp=jnp, gqa_decode=gqa_decode,
                                 gqa_decode_ref=gqa_decode_ref)


def _lanes_per_slot(hd: int) -> int:
    """Lanes a slot's row is spread over, 8 columns a lane."""
    return 4 if hd <= 32 else 8 if hd <= 64 else 16


def _fold(m, l, a, m2, l2, a2):
    """The kernel's merge of two online-softmax states (the reference's
    corr rule: a state with m <= -1e30 / 2 weighs 0)."""
    m_new = torch.maximum(m, m2)
    m_safe = m_new.clamp_min(SAFE)

    def weight(ms):
        return torch.where(ms > 0.5 * NEG,
                           torch.exp(ms.clamp_min(SAFE) - m_safe), 0.0)

    c1, c2 = weight(m), weight(m2)
    return m_new, l * c1 + l2 * c2, a * c1[..., None] + a2 * c2[..., None]


def _split_plan(q, kc, vc, kv_len, *, splits, window=0, ring=False,
                softcap=0.0, drop_split=None, slot0=0, sc_total=None,
                return_lse=False):
    """B7's arithmetic plan in float32: ``splits`` parts of each row's
    valid range ``[lo, hi)`` (on the whole ``sc_total``-slot cache,
    intersected with the block of slots ``slot0 ..`` that ``kc``/``vc``
    hold), a stream per group of lanes running the online softmax over
    batches of UNROLL slots, then the merges in the kernel's order, and
    with ``return_lse`` the kernel's logsumexp. ``drop_split`` leaves one
    rank out of the merge (a control)."""
    B, Hq, hd = q.shape
    Sc, Hkv = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    spw = 32 // _lanes_per_slot(hd)
    streams = WARPS * spw
    scale = 1.0 / hd ** 0.5
    qf = q.float().reshape(B, Hkv, G, hd)
    kf, vf = kc.float(), vc.float()
    total = Sc if sc_total is None else sc_total
    out = torch.zeros(B, Hkv, G, hd)
    lse = torch.zeros(B, Hkv, G)
    for b in range(B):
        n = int(kv_len[b])
        hi = min(max(0, min(n, total)), slot0 + Sc) - slot0
        lo = max(max(0, n - window) if (not ring and window > 0) else 0,
                 slot0) - slot0
        per = -(-max(hi - lo, 0) // splits)
        ranks = []
        for r in range(splits):
            t_lo, t_hi = lo + r * per, min(hi, lo + (r + 1) * per)
            m = torch.full((streams, Hkv, G), NEG)
            l = torch.zeros(streams, Hkv, G)
            acc = torch.zeros(streams, Hkv, G, hd)
            for t0 in range(t_lo, t_hi, streams * UNROLL):
                t = (t0 + torch.arange(UNROLL)[:, None] * streams
                     + torch.arange(streams)[None, :])        # [UNROLL, st]
                ok = t < t_hi
                tc = t.clamp(max=max(Sc - 1, 0))
                kt = kf[b, tc] * ok[..., None, None]        # [U, st, Hkv, hd]
                vt = vf[b, tc] * ok[..., None, None]
                s = torch.einsum("kgd,ujkd->ujkg", qf[b], kt) * scale
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                s = torch.where(ok[..., None, None], s, NEG)
                m_new = torch.maximum(m, s.amax(0))
                m_safe = m_new.clamp_min(SAFE)
                corr = torch.where(m > 0.5 * NEG,
                                   torch.exp(m.clamp_min(SAFE) - m_safe), 0.0)
                p = torch.exp(s - m_safe)
                l = l * corr + p.sum(0)
                acc = acc * corr[..., None] + torch.einsum(
                    "ujkg,ujkd->jkgd", p, vt)
                m = m_new
            # the warp's streams by a butterfly, then the warps in order
            m, l, acc = (x.reshape(WARPS, spw, *x.shape[1:])
                         for x in (m, l, acc))
            o = 1
            while o < spw:
                partner = torch.arange(spw) ^ o
                m, l, acc = _fold(m, l, acc, m[:, partner], l[:, partner],
                                  acc[:, partner])
                o *= 2
            bm, bl, ba = NEG * torch.ones(Hkv, G), torch.zeros(Hkv, G), \
                torch.zeros(Hkv, G, hd)
            for w in range(WARPS):
                bm, bl, ba = _fold(bm, bl, ba, m[w, 0], l[w, 0], acc[w, 0])
            ranks.append((bm, bl, ba))
        fm, fl, fa = NEG * torch.ones(Hkv, G), torch.zeros(Hkv, G), \
            torch.zeros(Hkv, G, hd)
        for r, (bm, bl, ba) in enumerate(ranks):
            if r != drop_split:
                fm, fl, fa = _fold(fm, fl, fa, bm, bl, ba)
        out[b] = fa / fl.clamp_min(1e-30)[..., None]
        lse[b] = torch.where(fl > 0, fm.clamp_min(SAFE) + torch.log(fl),
                             NEG)
    out = out.reshape(B, Hq, hd).to(q.dtype)
    return (out, lse.reshape(B, Hq)) if return_lse else out


def _inputs(case, dtype, seed):
    B, Hkv, G, hd, Sc, lens = case[:6]
    rng = np.random.default_rng(seed)

    def randn(shape):
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return t.to(getattr(torch, dtype))

    return (randn((B, Hkv * G, hd)), randn((B, Sc, Hkv, hd)),
            randn((B, Sc, Hkv, hd)), torch.tensor(lens, dtype=torch.int32))


def _within_gate(out, ref, dtype):
    if dtype == "float32":
        return float((out - ref).abs().max()) <= F32_TOL
    return _bf16_ulps(out, ref) <= BF16_ULPS


#: (B, Hkv, G, hd, Sc, kv_len, window, ring, softcap, batch rows the
#: split count is picked for). The first is one row of the smollm serving
#: shape with the serving batch's S = 7.
SPLIT_CASES = [
    (1, 5, 3, 64, 2048, (1040,), 0, False, 0.0, 8),
    (2, 2, 2, 32, 256, (300, 100), 0, True, 0.0, 2),     # ring past Sc
    (2, 2, 3, 64, 512, (500, 40), 100, False, 50.0, 2),  # window < S x 64
    (2, 2, 2, 32, 256, (0, 1), 0, False, 0.0, 2),        # kv_len 0 and 1
    (3, 1, 4, 32, 512, (3, 9, 200), 0, False, 0.0, 3),   # empty splits
    (2, 4, 1, 80, 256, (256, 77), 0, False, 0.0, 2),     # hd = 80, G = 1
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_plan_matches_plain_and_reference(jref, dtype, case):
    B, Hkv, G, hd, Sc, lens, window, ring, softcap, rows = case
    splits = gd.decode_splits(rows, Hkv, Sc, H100_SMS)
    q, kc, vc, kv_len = _inputs(case, dtype, seed=20)
    kw = dict(window=window, ring=ring, softcap=softcap)
    out = _split_plan(q, kc, vc, kv_len, splits=splits, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    plain = gd.gqa_decode_ref(q, kc, vc, kv_len, **kw)
    assert _within_gate(out, plain, dtype)
    jq, jk, jv = (jref.jnp.asarray(t.float().numpy(),
                                   getattr(jref.jnp, dtype))
                  for t in (q, kc, vc))
    jl = jref.jnp.asarray(np.asarray(lens, np.int32))
    refs = [jref.gqa_decode(jq, jk, jv, jl, block_kv=64, interpret=True,
                            **kw)]   # Sc % 64 == 0 in every case (§C)
    oracle = jref.gqa_decode_ref(jq, jk, jv, jl, **kw)
    has = torch.tensor(lens) > 0     # the oracle's empty rows are NaN
    for ref in refs + [oracle]:
        ref = torch.from_numpy(np.array(ref, np.float32)).to(out.dtype)
        assert _within_gate(out[has], ref[has], dtype)
    assert not out[~has].any()       # a row with no valid slot gives 0


def test_split_plan_control_misses_the_gate():
    """A plan that leaves one non-empty split out of the merge lands far
    outside the gate, so the gate sees a lost split."""
    case = SPLIT_CASES[0]
    q, kc, vc, kv_len = _inputs(case, "float32", seed=20)
    plain = gd.gqa_decode_ref(q, kc, vc, kv_len)
    bad = _split_plan(q, kc, vc, kv_len, splits=7, drop_split=3)
    assert float((bad - plain).abs().max()) > 100 * F32_TOL


def test_decode_splits():
    for B in (1, 2, 8, 64):
        for Hkv in (1, 2, 5, 32):
            for Sc in (1, 40, 64, 65, 300, 2048, 4500):
                S = gd.decode_splits(B, Hkv, Sc, H100_SMS)
                assert 1 <= S <= gd.MAX_SPLITS
                assert S <= max(1, -(-Sc // 64))   # 64 slots or more a split
    # smollm serving: 40 (KV head, row) pairs, 7 splits, 280 blocks
    assert gd.decode_splits(8, 5, 2048, H100_SMS) == 7
    assert 8 * 5 * gd.decode_splits(8, 5, 2048, H100_SMS) == 280
    assert gd.decode_splits(8, 32, 2048, H100_SMS) == 2   # zamba2: 512
    assert gd.decode_splits(1, 1, 64, H100_SMS) == 1
    assert gd.decode_splits(64, 32, 2048, H100_SMS) == 1
