"""The flash-attention backward of the port (B5 dQ, B6 dK/dV): its plain
version ``flash_attention_bwd_ref`` and the autograd Function
``FlashAttention`` (plain on the CPU) against the reference's trainable
attention (``make_trainable_attention``, the Pallas forward and backward in
interpret mode) and against JAX's and torch's autograd through the plain
attention, on the same seeded inputs; the dispatchers' rules under grad;
and — on a CUDA card only — B5/B6 against the plain version.

JAX is imported by a fixture, so the kernel tests also run where only the
port is installed."""
import math
import types

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss

#: The reference's backward tolerances (tests/test_kernels.py): 3e-4 for
#: the trainable kernel, 5e-4 for its property sweep.
TOL_TRAINABLE, TOL_SWEEP = 3e-4, 5e-4
#: Port against torch's autograd through its own plain forward: the same
#: float32 formulas summed in another order.
TOL_AUTOGRAD = 1e-5
#: B5/B6 against the plain version on the card: float32 within 3e-4 of the
#: plain output's largest value, or of 1 where that is smaller (the
#: reference's absolute 3e-4: a query that sees one key has dQ = 0 up to
#: rounding); bfloat16 within 2 bf16 ulps + 1e-5 (both compute the same
#: float32 values, then round once).
KERNEL_F32, BF16_ULPS, BF16_ATOL = 3e-4, 2, 1e-5


@pytest.fixture
def jref():
    """The reference's trainable attention and plain attention."""
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention.ops import make_trainable_attention
    from repro.kernels.flash_attention.ref import attention_ref

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, attention_ref=attention_ref,
        make_trainable_attention=make_trainable_attention)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, B, Sq, Skv, Hq, Hkv, hd, dtype=torch.float32,
            device="cpu"):
    """q, k, v and an upstream gradient w, seeded, as torch tensors."""
    shapes = ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd),
              (B, Sq, Hq, hd))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(dtype).to(device) for s in shapes]


def _port_grads(q, k, v, w, *, causal, window):
    """``(plain backward, Function)`` gradients of ``sum(attn(q,k,v)·w)``."""
    o, lse = fa.attention_ref(q, k, v, causal=causal, window=window,
                              return_lse=True)
    plain = fa.flash_attention_bwd_ref(q, k, v, o, w, lse, causal=causal,
                                       window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    func = torch.autograd.grad((out * w).sum(), leaves)
    return plain, func


def _close(port, ref, tol):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), atol=tol,
                                   rtol=tol)


# ===========================================================================
# the plain backward and the Function vs the reference
# ===========================================================================

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_backward_matches_jax_trainable_attention(jref, causal, window):
    """The reference test's shapes (tests/test_kernels.py): B=2, S=64,
    Hq=4, Hkv=2, hd=32, Pallas blocks of 16 in interpret mode."""
    B, S, Hq, Hkv, hd = 2, 64, 4, 2, 32
    q, k, v, w = _inputs(np.random.default_rng(0), B, S, S, Hq, Hkv, hd)
    jnp, jax = jref.jnp, jref.jax
    attn = jref.make_trainable_attention(causal=causal, window=window,
                                         block_q=16, block_kv=16,
                                         interpret=True)
    jw = jnp.asarray(w.numpy())
    ref = jax.grad(lambda *a: (attn(*a) * jw).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    plain, func = _port_grads(q, k, v, w, causal=causal, window=window)
    _close(plain, ref, TOL_TRAINABLE)
    _close(func, ref, TOL_TRAINABLE)


def _sweep_case(jref, B, Sq, G, seed):
    """The reference's property sweep (tests/test_kernels.py): causal,
    Hkv=2, hd=16, against JAX's autograd through its plain attention."""
    Hkv, hd = 2, 16
    q, k, v, w = _inputs(np.random.default_rng(seed), B, Sq, Sq, Hkv * G,
                         Hkv, hd)
    jax, jnp = jref.jax, jref.jnp
    ref = jax.grad(lambda *a: jref.attention_ref(*a, causal=True).sum(),
                   argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    plain, func = _port_grads(q, k, v, torch.ones_like(w), causal=True,
                              window=0)
    _close(plain, ref, TOL_SWEEP)
    _close(func, ref, TOL_SWEEP)


@pytest.mark.parametrize("B,Sq,G,seed", [(1, 20, 1, 0), (2, 45, 2, 1),
                                         (1, 70, 4, 2), (2, 33, 1, 3)])
def test_backward_sweep_cases(jref, B, Sq, G, seed):
    _sweep_case(jref, B, Sq, G, seed)


@settings(deadline=None, max_examples=5)
@given(st.integers(1, 2), st.integers(20, 70), st.sampled_from([1, 2, 4]),
       st.integers(0, 99))
def test_backward_property_sweep(B, Sq, G, seed):
    pytest.importorskip("jax")
    from repro.kernels.flash_attention.ref import attention_ref
    import jax

    _sweep_case(types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                      attention_ref=attention_ref),
                B, Sq, G, seed)


BWD_CASES = [  # (B, Sq, Skv, Hq, Hkv, hd, causal, window)
    (2, 37, 37, 6, 2, 16, True, 0),
    (1, 40, 40, 4, 2, 32, True, 8),
    (2, 20, 33, 4, 4, 16, False, 0),     # ragged, non-causal
    (1, 30, 50, 3, 1, 16, True, 0),      # Skv > Sq, G = 3
    (1, 45, 30, 2, 1, 16, True, 5),      # rows 34..44 see no key
]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_backward_matches_torch_autograd(case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window = case
    q, k, v, w = _inputs(np.random.default_rng(1), B, Sq, Skv, Hq, Hkv, hd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.attention_ref(*leaves, causal=causal, window=window)
    ref = torch.autograd.grad((out * w).sum(), leaves)
    plain, func = _port_grads(q, k, v, w, causal=causal, window=window)
    for port in (plain, func):
        for a, b in zip(port, ref):
            torch.testing.assert_close(a, b, atol=TOL_AUTOGRAD,
                                       rtol=TOL_AUTOGRAD)
    if window == 5:       # the unseeing rows get no gradient at all
        assert float(plain[0][:, Skv + window - 1:].abs().max()) == 0.0


def test_backward_ref_keeps_dtypes():
    q, k, v, w = _inputs(np.random.default_rng(2), 1, 9, 9, 2, 1, 16,
                         dtype=torch.bfloat16)
    o, lse = fa.attention_ref(q, k, v, return_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, o, w, lse)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


# ===========================================================================
# dispatchers under grad
# ===========================================================================

def test_make_trainable_attention_is_the_function():
    q, k, v, w = _inputs(np.random.default_rng(3), 1, 24, 24, 4, 2, 16)
    attn = fa.make_trainable_attention(causal=True, window=8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attn(*leaves)
    assert torch.equal(out.detach(), fa.attention_ref(q, k, v, window=8))
    got = torch.autograd.grad((out * w).sum(), leaves)
    _, func = _port_grads(q, k, v, w, causal=True, window=8)
    for a, b in zip(got, func):
        assert torch.equal(a, b)


def test_softcap_under_grad_raises_and_serves_without_grad():
    q, k, v, _ = _inputs(np.random.default_rng(4), 1, 12, 12, 2, 1, 16)
    with pytest.raises(NotImplementedError, match="softcap"):
        fa.attention(q.clone().requires_grad_(), k, v, softcap=50.0)
    out = fa.attention(q, k, v, softcap=50.0)       # no grad: as before
    assert torch.equal(out, fa.attention_ref(q, k, v, softcap=50.0))
    with torch.no_grad():
        out = fa.attention(q.clone().requires_grad_(), k, v, softcap=50.0)
    assert out.grad_fn is None


def test_kernel_paths_never_hand_back_a_detached_tensor():
    """Under grad, ``attention`` insisting on the kernel reaches the
    kernel's guard (no CPU fallback), and ``ssd`` refuses: the SSD kernel
    has no backward."""
    q, k, v, _ = _inputs(np.random.default_rng(5), 1, 8, 8, 2, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.attention(q.requires_grad_(), k, v, use_kernel=True)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 8, 1, 64)).astype(np.float32))
    dtA = -torch.rand(1, 8, 1)
    b = torch.randn(1, 8, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        ss.ssd(x.requires_grad_(), dtA, b, b, chunk=8, use_kernel=True)
    y, _ = ss.ssd(x, dtA, b, b, chunk=8)           # plain: differentiable
    assert y.grad_fn is not None


@pytest.mark.parametrize("bad", ["hd", "dtype", "groups", "lse"])
def test_backward_wrappers_reject_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 4, 4, 32)
    k = torch.zeros(1, 4, 2, 32)
    lse = torch.zeros(1, 4, 4)
    if bad == "hd":
        q, k = q[..., :16].contiguous(), k[..., :16].contiguous()
    elif bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "groups":
        k = torch.zeros(1, 4, 3, 32)
    else:
        lse = lse.double()
    n0 = dict(fa.LAUNCHES)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_dq_cuda(q, k, k, q, lse, lse)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention_dkv_cuda(q, k, k, q, lse, lse)
    assert fa.LAUNCHES == n0


def _bf16_ulps(out, ref) -> float:
    """Largest ``(|out - ref| - BF16_ATOL)`` in bf16 ulps of ``ref``."""
    d = (out.float() - ref.float()).abs()
    _, e = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    excess = (d - BF16_ATOL) / torch.where(ref != 0, ulp, 0.0)
    return float(excess.nan_to_num(nan=0.0).max().clamp(min=0))


# ===========================================================================
# the bf16 kernels' precision plan, rehearsed on the CPU
# ===========================================================================

#: (B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale): one head group of
#: smollm's training shape, a windowed shape with ragged 64-row tiles, and
#: the first with q scaled by 8 (exactly), so that the scores are large.
REHEARSAL_CASES = [(1, 1024, 1024, 3, 1, 64, True, 0, 1.0),
                   (1, 300, 300, 4, 2, 32, True, 100, 1.0),
                   (1, 1024, 1024, 3, 1, 64, True, 0, 8.0)]


def _bf16_terms(x: torch.Tensor, n: int) -> list:
    """``x`` (float32) as ``n`` bf16 terms, each the bf16 rounding of what
    the earlier ones leave: ``[bf16(x)]``, or ``[hi, bf16(x - hi)]``."""
    terms, rest = [], x
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def _visible(Sq, Skv, causal, window) -> torch.Tensor:
    iq, ik = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    ok = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        ok &= ik <= iq
    if window:
        ok &= ik > iq - window
    return ok


def _p_and_ds(q, k, v, o, do, lse, *, causal, window, dtype):
    """The backward's first half in ``dtype`` (float32 as the kernels and
    the plain version compute it, or float64): ``(q, k, dO, P, dS)`` with
    q and dO as ``[B, Hkv, G, Sq, hd]``, k as ``[B, Hkv, 1, Skv, hd]``,
    ``P = exp(scale·q kᵀ − lse)`` where visible and ``dS = P∘(dO vᵀ −
    D)``."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, scale = Hq // Hkv, 1.0 / math.sqrt(hd)

    def heads(t):   # [B, Sq, Hq, hd] -> [B, Hkv, G, Sq, hd]
        return t.to(dtype).reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4)

    qf, of, dof = heads(q), heads(o), heads(do)
    kf, vf = (t.to(dtype).permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    s = qf @ kf.transpose(-1, -2)
    p = torch.where(_visible(Sq, Skv, causal, window),
                    torch.exp(s * scale
                              - lse.to(dtype).reshape(B, Hkv, G, Sq, 1)),
                    0.0)
    ds = p * (dof @ vf.transpose(-1, -2)
              - (of * dof).sum(-1, keepdim=True))
    return qf, kf, dof, p, ds


def _dkv_bf16_emulated(q, k, v, o, do, lse, *, causal, window, p_terms,
                       ds_terms):
    """The bf16 B6 kernel's arithmetic: float32 Sᵀ and dPᵀ of the bf16
    inputs (exact products), ``Pᵀ = exp(scale·Sᵀ − lse)`` where visible,
    ``dSᵀ = Pᵀ∘(dPᵀ − D)``, and ``dV = Pᵀ dO``, ``dK = scale·dSᵀ q`` with
    the float32 Pᵀ and dSᵀ split into ``p_terms`` and ``ds_terms`` bf16
    terms, each multiplied into one float32 accumulator."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, _, dof, p, ds = _p_and_ds(q, k, v, o, do, lse, causal=causal,
                                  window=window, dtype=torch.float32)
    dv = sum(t.transpose(-1, -2) @ dof for t in _bf16_terms(p, p_terms))
    dk = sum(t.transpose(-1, -2) @ qf for t in _bf16_terms(ds, ds_terms))
    return ((dk.sum(2) * scale).transpose(1, 2).to(k.dtype),
            dv.sum(2).transpose(1, 2).to(v.dtype))


@pytest.mark.parametrize("case", REHEARSAL_CASES, ids=str)
def test_bf16_split_of_p_and_ds_holds_the_ulp_gate(case):
    """B6 multiplies Pᵀ and dSᵀ, computed in float32, into bf16 tensor-core
    products as bf16 terms, Pᵀ as two (hi + lo) and dSᵀ as three: dK and dV
    then land within the card's gate of the plain version, 2 bf16 ulps +
    1e-5. The control, one bf16 term each, lands far above it, so the gate
    tells them apart; with large scores, two terms of dSᵀ land above it too
    (the sum over queries in dK cancels), which is why dSᵀ takes three."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale = case
    q, k, v, do = _inputs(np.random.default_rng(10), B, Sq, Skv, Hq, Hkv,
                          hd, dtype=torch.bfloat16)
    q = q * q_scale
    kw = dict(causal=causal, window=window)
    o, lse = fa.attention_ref(q, k, v, return_lse=True, **kw)
    _, dk, dv = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)

    def ulps(p_terms, ds_terms):
        got = _dkv_bf16_emulated(q, k, v, o, do, lse, p_terms=p_terms,
                                 ds_terms=ds_terms, **kw)
        return _bf16_ulps(got[0], dk), _bf16_ulps(got[1], dv)

    assert max(ulps(2, 3)) <= BF16_ULPS
    assert min(ulps(1, 1)) > BF16_ULPS
    if q_scale > 1:
        assert ulps(2, 2)[0] > BF16_ULPS


#: The bf16 terms into which B5 splits dS for dQ += dS·k
#: (flash_attention_bwd.cu, flash_attention_dq_mma_kernel).
DQ_DS_TERMS = 2


def _dq_bf16_emulated(q, k, v, o, do, lse, *, causal, window, ds_terms):
    """The bf16 B5 kernel's arithmetic: float32 S and dP of the bf16 inputs
    (exact products), ``P = exp(scale·S − lse)`` where visible, ``dS =
    P∘(dP − D)``, and ``dQ = scale·dS k`` with the float32 dS split into
    ``ds_terms`` bf16 terms, each multiplied into one float32 sum."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, kf, _, _, ds = _p_and_ds(q, k, v, o, do, lse, causal=causal,
                                window=window, dtype=torch.float32)
    dq = sum(t @ kf for t in _bf16_terms(ds, ds_terms)) * scale
    return dq.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


@pytest.mark.parametrize("case", REHEARSAL_CASES, ids=str)
def test_bf16_split_of_ds_in_dq_holds_the_ulp_gate(case):
    """B5 multiplies dS, computed in float32, into the bf16 tensor-core
    product dS·k as DQ_DS_TERMS bf16 terms (hi + lo): dQ then lands within
    the card's gate of the plain version, 2 bf16 ulps + 1e-5, also with
    large scores (dQ sums over keys without the cancellation that makes
    B6's dK take three terms). The control, one bf16 term, lands far above
    it, so the gate tells them apart."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale = case
    q, k, v, do = _inputs(np.random.default_rng(10), B, Sq, Skv, Hq, Hkv,
                          hd, dtype=torch.bfloat16)
    q = q * q_scale
    kw = dict(causal=causal, window=window)
    o, lse = fa.attention_ref(q, k, v, return_lse=True, **kw)
    dq = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)[0]

    def ulps(ds_terms):
        return _bf16_ulps(_dq_bf16_emulated(q, k, v, o, do, lse,
                                            ds_terms=ds_terms, **kw), dq)

    assert ulps(DQ_DS_TERMS) <= BF16_ULPS
    assert ulps(1) > BF16_ULPS


def _bwd_float64(q, k, v, o, do, lse, *, causal, window):
    """dQ and dK of the plain version's formulas evaluated in float64 on
    the same inputs (o and lse as given)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, _, _, ds = _p_and_ds(q, k, v, o, do, lse, causal=causal,
                                 window=window, dtype=torch.float64)
    dq = (ds @ kf * scale).permute(0, 3, 1, 2, 4).reshape(q.shape)
    dk = (ds.transpose(-1, -2) @ qf).sum(2).transpose(1, 2) * scale
    return dq, dk


def test_plain_dk_at_large_scores_is_float32_limited():
    """Where the scores are large (q scaled by 8) over 1,024 positions, the
    plain version's own float32 dK lies more than 2 bf16 ulps + 1e-5 from
    the same formulas in float64: P = exp(scale·S − lse) carries the
    float32 rounding of arguments up to ~47, and a dK element that cancels
    to ~3e-4 from much larger terms keeps that error (~1.6e-5). So a bf16
    kernel whose S differs from the plain version's in the last float32
    bit cannot be held at the ulp gate there for dK (the card case of this
    shape with B = 2, Hq = 15 reads B6's dK 3.4 ulps from the plain
    version), while dQ, which does not cancel so, stays within it."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale = REHEARSAL_CASES[2]
    q, k, v, do = _inputs(np.random.default_rng(10), B, Sq, Skv, Hq, Hkv,
                          hd, dtype=torch.bfloat16)
    q = q * q_scale
    kw = dict(causal=causal, window=window)
    o, lse = fa.attention_ref(q, k, v, return_lse=True, **kw)
    dq, dk, _ = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    dq64, dk64 = _bwd_float64(q, k, v, o, do, lse, **kw)
    assert _bf16_ulps(dk, dk64.float()) > BF16_ULPS
    assert _bf16_ulps(dq, dq64.float()) <= BF16_ULPS


# ===========================================================================
# phase 12's per-call reading of B5/B6 (chip_smoke.py), on the CPU
# ===========================================================================

def _chip_smoke():
    """chip_smoke.py at the root of the checkout, imported by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["none", "dq moved 4 ulps",
                                   "dq at 4 mantissa bits"])
def test_scaled_call_reading_sees_what_the_floor_hides(fault):
    """Phase 12 holds each B5/B6 call of a training step at 2 bf16 ulps +
    1e-5, and a step's gradients are below 1e-5, so that reading is 0 for
    any fault of a few ulps. Its second reading runs the call again with dO
    scaled by a power of two (exact: the backward is linear in dO) and sees
    the fault. Here the "kernel" is the plain version, moved where a fault
    is asked for: by 4 bf16 ulps inside the stand-in backward, or by the
    control's rounding of dq to 4 mantissa bits."""
    cs = _chip_smoke()
    q, k, v, do = _inputs(np.random.default_rng(12), 1, 64, 64, 4, 2, 32,
                          dtype=torch.bfloat16)
    do = do * 2.0 ** -20                   # gradients below the 1e-5 floor
    o, lse = fa.attention_ref(q, k, v, return_lse=True)

    def backward(*args, use_kernel=None, **kw):
        dq, dk, dv = fa.flash_attention_bwd_ref(*args, **kw)
        if use_kernel and fault == "dq moved 4 ulps":
            dq = (dq.float() + 4 * cs.bf16_ulp(dq)).to(dq.dtype)
        return dq, dk, dv

    args = (q, k, v, o, do, lse)
    ref = fa.flash_attention_bwd_ref(*args)
    assert max(float(t.float().abs().max()) for t in ref) < cs.BF16_ATOL
    if fault == "dq at 4 mantissa bits":
        _, reading = cs._held_reading(
            backward, args, dict(causal=True, window=0),
            fault=lambda dq: cs._round_mantissa(dq, cs.CALL_CONTROL_BITS))
    else:
        held, first = [], []
        out = cs._bwd_held(held, first)(backward)(*args, causal=True,
                                                  window=0, use_kernel=None)
        assert len(held) == 1
        assert all(a is b for a, b in zip(first[0][1], args))
        assert all(torch.equal(a, b) for a, b in zip(out, backward(
            *args, causal=True, use_kernel=True)))
        reading = held[0]
    _, unscaled, scaled = reading
    assert unscaled == 0.0
    if fault == "none":
        assert scaled == 0.0
    else:
        assert scaled > cs.BF16_ULPS


# ===========================================================================
# B5/B6 vs the plain version (card only)
# ===========================================================================


KERNEL_CASES = [  # (B, Sq, Skv, Hq, Hkv, hd, causal, window)
    (2, 300, 300, 15, 5, 64, True, 0),     # smollm's heads, ragged tiles
    (1, 200, 200, 4, 4, 80, True, 0),      # hd = 80, G = 1
    (1, 260, 260, 6, 2, 128, True, 100),   # sliding window
    (2, 130, 77, 6, 2, 32, False, 0),      # non-causal, Skv < Sq
    (1, 100, 40, 3, 1, 64, True, 16),      # rows that see no key
    (1, 1, 65, 2, 1, 32, True, 0),
    (2, 1024, 1024, 15, 5, 64, True, 0),   # the training length
]


#: Shapes at the edges of the tensor-core kernels' fragments and tiles:
#: (B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale). q_scale multiplies
#: q (exactly, a power of two) so that the scores reach large magnitudes,
#: where exp's range and the lo term of the bf16 split are exercised.
FRAGMENT_EDGE_CASES = [
    (1, 17, 17, 3, 1, 64, True, 0, 1.0),
    (2, 17, 17, 4, 2, 32, False, 0, 1.0),
    (1, 40, 8, 2, 1, 64, False, 0, 1.0),      # Skv = 8
    (1, 8, 8, 2, 1, 128, True, 0, 1.0),
    (1, 130, 130, 4, 4, 80, True, 0, 1.0),    # hd = 80, ragged tiles
    (1, 130, 130, 4, 2, 80, True, 48, 1.0),
    (2, 200, 200, 6, 2, 64, True, 0, 8.0),    # large scores
    (1, 130, 150, 4, 1, 128, False, 0, 8.0),
    # the training length with large scores; B6's dK reads 3.4 ulps here,
    # beyond what float32 itself holds (see
    # test_plain_dk_at_large_scores_is_float32_limited)
    (2, 1024, 1024, 15, 5, 64, True, 0, 8.0),
    (1, 1024, 1024, 4, 2, 128, True, 0, 1.0),  # hd = 128 over 16 key tiles
]


def _check_backward(got, ref, dt):
    """B5/B6 outputs against the plain version's: float32 within
    KERNEL_F32 of the largest value (or of 1), bf16 within the ulp gate."""
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == b.dtype == dt, name
        assert bool(torch.isfinite(a).all()), name
        if dt == torch.float32:
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1.0))
            assert err <= KERNEL_F32, (name, err)
        else:
            assert _bf16_ulps(a, b) <= BF16_ULPS, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_backward_kernels_match_plain(cuda, dtype, case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window = case
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(np.random.default_rng(7), B, Sq, Skv, Hq, Hkv, hd,
                          dtype=dt, device=cuda)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    n0 = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                      window=window)
    ref = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_dq"] == n0["flash_attention_dq"] + 1
    assert fa.LAUNCHES["flash_attention_dkv"] == \
        n0["flash_attention_dkv"] + 1
    _check_backward(got, ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FRAGMENT_EDGE_CASES, ids=str)
def test_backward_kernels_at_fragment_edges(cuda, dtype, case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, q_scale = case
    dt = getattr(torch, dtype)
    q, k, v, do = _inputs(np.random.default_rng(11), B, Sq, Skv, Hq, Hkv,
                          hd, dtype=dt, device=cuda)
    q = q * q_scale
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_cuda(q, k, v, **kw)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    ref = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    _check_backward(got, ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES[:3], ids=str)
def test_function_on_the_card_matches_torch_autograd(cuda, case):
    """B4 → B5/B6 through the Function against torch's autograd through
    the plain forward, float32."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window = case
    q, k, v, w = _inputs(np.random.default_rng(8), B, Sq, Skv, Hq, Hkv, hd,
                         device=cuda)
    kl = [t.clone().requires_grad_() for t in (q, k, v)]
    rl = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(
        (fa.attention(*kl, causal=causal, window=window) * w).sum(), kl)
    ref = torch.autograd.grad(
        (fa.attention_ref(*rl, causal=causal, window=window) * w).sum(), rl)
    for a, b in zip(got, ref):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= KERNEL_F32, err


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(cuda):
    q, k, v, do = _inputs(np.random.default_rng(9), 2, 300, 300, 15, 5, 64,
                          dtype=torch.bfloat16, device=cuda)
    o, lse = fa.flash_attention_cuda(q, k, v)
    first = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
