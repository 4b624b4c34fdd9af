"""The port's Mamba2 SSD scan (B8) and Mamba2 block: the plain PyTorch
versions (``ssd_scan_ref``, the sequential recurrence; ``ssd_chunked``, the
model layer's chunked form) against the JAX reference (the Pallas kernel
in interpret mode, its oracle and the layer's ``ssd_chunked``) on the
same seeded inputs; the dispatcher's padding and device rules; the decode
step and the whole block; and — on a CUDA card only — the CUDA kernel
against its plain versions.

JAX is imported by a fixture, so this file also runs where only the port
is installed (as on a card without JAX): the JAX comparisons skip there and
the kernel tests run. Tolerances: the reference's own, 3e-4 in float32 and
5e-2 for bf16 inputs (tests/test_kernels.py), 1e-4 for the resumed scan
(tests/test_models.py), 1e-4 / 3e-2 for the block (the port's model
tolerances)."""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import layers as TL
from torch_split_plan import PLANS, SSD_TOL, _plan_mm

TOL = {"float32": 3e-4, "bfloat16": 5e-2}


@pytest.fixture(autouse=True)
def _forward_only():
    """The port's parameters are trainable; these tests compare forward
    values, so they run without autograd, as serving does."""
    with torch.no_grad():
        yield


@pytest.fixture
def jref():
    """The JAX reference's SSD kernel, oracle and model layer."""
    jnp = pytest.importorskip("jax.numpy")
    import jax

    from repro.kernels.ssd_scan.ref import ssd_scan_ref
    from repro.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro.models import layers

    return types.SimpleNamespace(jax=jax, jnp=jnp, ssd_scan=ssd_scan,
                                 ssd_scan_ref=ssd_scan_ref, layers=layers)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, B, L, H, P, N, dtype="float32", lo=0.01, hi=0.4,
            device="cpu"):
    """x, dtA, b, c drawn as the reference's kernel tests draw them; x, b
    and c rounded to ``dtype`` once and handed over as float32, dtA
    float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P))
    dtA = -rng.uniform(lo, hi, size=(B, L, H))
    b = rng.normal(size=(B, L, N))
    c = rng.normal(size=(B, L, N))
    dt = getattr(torch, dtype)
    out = [torch.from_numpy(a.astype(np.float32)).to(dt).float()
           for a in (x, b, c)]
    x, b, c = (t.to(device) for t in out)
    return x, torch.from_numpy(dtA.astype(np.float32)).to(device), b, c


def _np(t):
    return t.float().cpu().numpy()


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# ===========================================================================
# plain versions vs the reference
# ===========================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_plain_versions_match_jax_kernel_and_oracle(jref, dtype, chunk):
    """tests/test_kernels.py::test_ssd_scan_kernel's inputs through the
    port's two plain versions and the reference's Pallas kernel, oracle
    and model layer."""
    args = _inputs(2, 2, 64, 3, 8, 16, dtype)
    jargs = [jref.jnp.asarray(_np(t)) for t in args]
    ky, ks = jref.ssd_scan(*jargs, chunk=chunk, interpret=True)
    ry, rs = jref.ssd_scan_ref(*jargs)
    cy, cs = jref.layers.ssd_chunked(*jargs, chunk)
    tol = TOL[dtype]
    y, s = ss.ssd_scan_ref(*args)
    for want_y, want_s in ((ky, ks), (ry, rs)):
        _close(y, want_y, tol)
        _close(s, want_s, tol)
    y, s = ss.ssd_chunked(*args, chunk)
    for want_y, want_s in ((ky, ks), (ry, rs), (cy, cs)):
        _close(y, want_y, tol)
        _close(s, want_s, tol)


@pytest.mark.parametrize("B,L,H,seed", [(1, 16, 1, 0), (2, 48, 5, 1),
                                        (1, 80, 5, 2), (2, 80, 1, 3)])
def test_plain_versions_match_jax_kernel_sweep(jref, B, L, H, seed):
    """tests/test_kernels.py::test_ssd_scan_property_sweep's ranges (P = 4,
    N = 8, chunk 16, dtA down to -0.6), at fixed draws."""
    args = _inputs(seed, B, L, H, 4, 8, lo=0.01, hi=0.6)
    jargs = [jref.jnp.asarray(_np(t)) for t in args]
    ky, ks = jref.ssd_scan(*jargs, chunk=16, interpret=True)
    for y, s in (ss.ssd_scan_ref(*args), ss.ssd_chunked(*args, 16)):
        _close(y, ky, TOL["float32"])
        _close(s, ks, TOL["float32"])


def test_chunked_matches_jax_layer_with_initial_state(jref):
    """An initial state enters both plain versions as it enters the
    reference's ssd_chunked."""
    args = _inputs(5, 1, 32, 2, 4, 8)
    s0 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 2, 4, 8)).astype(np.float32))
    jargs = [jref.jnp.asarray(_np(t)) for t in args]
    jy, js = jref.layers.ssd_chunked(*jargs, 8,
                                     initial_state=jref.jnp.asarray(_np(s0)))
    for y, s in (ss.ssd_chunked(*args, 8, initial_state=s0),
                 ss.ssd_scan_ref(*args, initial_state=s0)):
        _close(y, jy, 2e-4)
        _close(s, js, 2e-4)


@pytest.mark.parametrize("plain", ["chunked", "sequential"])
def test_initial_state_resume(plain):
    """Two calls with the state carried equal one call over the whole
    sequence (tests/test_models.py::test_ssd_chunked_initial_state_resume)."""
    x, dtA, b, c = _inputs(1, 1, 64, 2, 4, 4, hi=0.5)

    def scan(*a, initial_state=None):
        if plain == "chunked":
            return ss.ssd_chunked(*a, 8, initial_state=initial_state)
        return ss.ssd_scan_ref(*a, initial_state=initial_state)

    y_full, s_full = scan(x, dtA, b, c)
    h = 32
    _, s1 = scan(x[:, :h], dtA[:, :h], b[:, :h], c[:, :h])
    y2, s2 = scan(x[:, h:], dtA[:, h:], b[:, h:], c[:, h:], initial_state=s1)
    torch.testing.assert_close(y2, y_full[:, h:], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=1e-4)


# ===========================================================================
# the dispatcher
# ===========================================================================

@pytest.mark.parametrize("L,chunk,P,N", [(50, 16, 4, 8), (300, 256, 16, 16),
                                         (7, 8, 16, 16)])
def test_dispatcher_pads_to_the_chunk(L, chunk, P, N):
    """An L that is not a multiple of the chunk: the padded positions leave
    the final state unchanged and y is cut back to L."""
    x, dtA, b, c = _inputs(7, 2, L, 3, P, N)
    s0 = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 3, P, N)).astype(np.float32))
    y, s = ss.ssd(x, dtA, b, c, chunk=chunk, initial_state=s0)
    ry, rs = ss.ssd_scan_ref(x, dtA, b, c, initial_state=s0)
    assert y.shape == x.shape and s.shape == (2, 3, P, N)
    torch.testing.assert_close(y, ry, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(s, rs, atol=3e-4, rtol=3e-4)


def test_dispatcher_device_rules():
    x, dtA, b, c = _inputs(9, 1, 32, 2, 64, 64)
    ref = ss.ssd_chunked(x, dtA, b, c, 16)
    for use_kernel in (None, False):
        got = ss.ssd(x, dtA, b, c, chunk=16, use_kernel=use_kernel)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd(x, dtA, b, c, chunk=16, use_kernel=True)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ss.ssd_scan_cuda(x[..., :8].contiguous(), dtA, b, c, chunk=16)
    with pytest.raises(ValueError, match="multiple"):
        ss.ssd_scan_cuda(x, dtA, b, c, chunk=24)
    assert ss.LAUNCHES["ssd_scan"] == 0


# ===========================================================================
# the decode step and the Mamba2 block vs the reference
# ===========================================================================

def test_ssd_decode_step_matches_jax(jref):
    rng = np.random.default_rng(10)
    x, dtA, b, c, st = (rng.normal(size=s).astype(np.float32) for s in
                        ((2, 3, 4), (2, 3), (2, 8), (2, 8), (2, 3, 4, 8)))
    dtA = -np.abs(dtA)
    jy, js = jref.layers.ssd_decode_step(*(jref.jnp.asarray(a) for a in
                                           (x, dtA, b, c, st)))
    y, s = TL.ssd_decode_step(*(torch.from_numpy(a) for a in
                                (x, dtA, b, c, st)))
    _close(y, jy, 1e-5)
    _close(s, js, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_jax(jref, dtype):
    """No cache (a full sequence), then a prefill from a cache and one
    decode step, with the conv and ssm states."""
    from repro.configs import get_smoke_config as jax_smoke

    jnp = jref.jnp
    tol = {"float32": 1e-4, "bfloat16": 3e-2}[dtype]
    jcfg = jax_smoke("mamba2_2p7b").with_(dtype=dtype)
    tcfg = get_smoke_config("mamba2_2p7b").with_(dtype=dtype)
    p = jref.layers.init_mamba(jcfg, jref.jax.random.PRNGKey(3), jnp.float32)
    names = ("in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
             "norm_scale", "out_proj")
    blk = TL.Mamba(*(torch.from_numpy(np.array(p[n])) for n in names))
    B, S = 2, 13                       # not a multiple of the chunk (8)
    x = np.random.default_rng(11).normal(size=(B, S + 1, jcfg.d_model))
    x = x.astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))

    ref, _ = jref.layers.mamba_block(p, jcfg, jx[:, :S], ctx=None)
    port, _ = TL.mamba_block(blk, tcfg, tx[:, :S])
    _close(port, ref, tol)

    cw, ch = jcfg.conv_width, jcfg.d_inner + 2 * jcfg.ssm_state
    H, P, N = jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state
    jc = (jnp.zeros((B, cw - 1, ch), dtype), jnp.zeros((B, H, P, N)))
    tc = (torch.zeros(B, cw - 1, ch, dtype=getattr(torch, dtype)),
          torch.zeros(B, H, P, N))
    for sl in (slice(0, S), slice(S, S + 1)):    # prefill, decode step
        ref, jc = jref.layers.mamba_block(p, jcfg, jx[:, sl], ctx=None,
                                          cache=jc)
        port, tc = TL.mamba_block(blk, tcfg, tx[:, sl], cache=tc)
        _close(port, ref, tol)
        _close(tc[0], jc[0], tol)
        _close(tc[1], jc[1], tol)


def test_init_mamba_follows_the_reference_schedules():
    cfg = get_smoke_config("mamba2_2p7b")
    blk = TL.init_mamba(cfg, torch.Generator().manual_seed(0), torch.float32)
    H = cfg.ssm_heads
    np.testing.assert_allclose(blk.A_log.numpy(),
                               np.log(np.linspace(1.0, 16.0, H)), rtol=1e-6)
    np.testing.assert_allclose(
        torch.nn.functional.softplus(blk.dt_bias.double()).numpy(),
        np.linspace(1e-3, 0.1, H), rtol=1e-5)
    assert blk.in_proj.shape == (cfg.d_model, 2 * cfg.d_inner
                                 + 2 * cfg.ssm_state + H)
    assert 0.015 < float(blk.in_proj.std()) < 0.025
    assert not blk.conv_b.any() and not blk.norm_scale.any()


# ===========================================================================
# the CUDA kernel vs its plain versions (card only)
# ===========================================================================

@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, L, H, P, N, chunk, initial state)
    (2, 64, 3, 64, 64, 16, False),
    (2, 64, 3, 64, 64, 64, True),
    (1, 512, 4, 64, 128, 256, False),
    (2, 512, 3, 64, 64, 256, True),
    (1, 200, 2, 64, 128, 40, True),          # chunk not a multiple of 64
    (1, 96, 2, 64, 64, 96, False),
], ids=str)
def test_ssd_kernel_matches_plain(cuda, case):
    B, L, H, P, N, chunk, with_init = case
    x, dtA, b, c = _inputs(12, B, L, H, P, N, device=cuda)
    s0 = (torch.randn((B, H, P, N), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda) if with_init else None)
    n0 = ss.LAUNCHES["ssd_scan"]
    y, s = ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == n0 + 1
    for ry, rs in (ss.ssd_scan_ref(x, dtA, b, c, initial_state=s0),
                   ss.ssd_chunked(x, dtA, b, c, chunk, initial_state=s0)):
        scale = float(ry.abs().max())
        torch.testing.assert_close(y / scale, ry / scale, atol=3e-4,
                                   rtol=3e-4)
        scale = float(rs.abs().max())
        torch.testing.assert_close(s / scale, rs / scale, atol=3e-4,
                                   rtol=3e-4)


@pytest.mark.cuda
def test_ssd_dispatcher_pads_on_the_card(cuda):
    x, dtA, b, c = _inputs(13, 1, 300, 1, 64, 128, device=cuda)
    s0 = torch.ones((1, 1, 64, 128), device=cuda)
    y, s = ss.ssd(x, dtA, b, c, chunk=256, initial_state=s0)
    ry, rs = ss.ssd_scan_ref(x, dtA, b, c, initial_state=s0)
    assert y.shape == x.shape
    torch.testing.assert_close(y / ry.abs().max(), ry / ry.abs().max(),
                               atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(s / rs.abs().max(), rs / rs.abs().max(),
                               atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
def test_ssd_wrapper_refuses_bad_tensors(cuda):
    x, dtA, b, c = _inputs(14, 1, 64, 2, 64, 64, device=cuda)
    n = x.numel()
    misaligned = torch.zeros(n + 1, device=cuda)[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        ss.ssd_scan_cuda(misaligned, dtA, b, c, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        ss.ssd_scan_cuda(x.double(), dtA, b, c, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan_cuda(x, dtA, torch.zeros(1, 64, 128, device=cuda)[..., :64],
                         c, chunk=16)


# ===========================================================================
# the kernel's precision plan, emulated on the CPU
# ===========================================================================

def _plan_scan(x, dtA, b, c, chunk: int, plan: str):
    """The four steps of the CUDA kernel's launches (kernels/ssd_scan/
    ref.py::ssd_chunked's), every product through :func:`_plan_mm`:
    C·Bᵀ once per chunk, the chunk states Xwᵀ·B, the recurrence over
    chunks in float32, and y = (C·Bᵀ ∘ L)·X + (C·prevᵀ) exp(a_cum)."""
    Bsz, L, H, P = x.shape
    nc = L // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)  # b,c,h,s,p
    ac = torch.cumsum(dtA.reshape(Bsz, nc, chunk, H), dim=2
                      ).permute(0, 1, 3, 2)                       # b,c,h,q
    bc = b.reshape(Bsz, nc, chunk, -1)
    cc = c.reshape(Bsz, nc, chunk, -1)
    cb = _plan_mm(cc, bc.transpose(-1, -2), plan)[:, :, None]     # b,c,1,q,s
    seg = ac[..., :, None] - ac[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    scores = torch.where(causal, cb * torch.exp(
        torch.where(causal, seg, 0.0)), 0.0)
    y = _plan_mm(scores, xc, plan)
    xw = xc * torch.exp(ac[..., -1:] - ac)[..., None]
    states = _plan_mm(xw.transpose(-1, -2), bc[:, :, None], plan)  # b,c,h,p,n
    s = torch.zeros_like(states[:, 0])
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * torch.exp(ac[:, ci, :, -1])[..., None, None] + states[:, ci]
    prev = torch.stack(prev, dim=1)
    y = y + _plan_mm(cc[:, :, None], prev.transpose(-1, -2), plan) \
        * torch.exp(ac)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, L, H, P), s


def _recurrence_f64(x, dtA, b, c):
    """The sequential recurrence h ← h·exp(ΔA) + B ⊗ x, y = C·h, in
    float64 from a zero state: the oracle of the plan's readings."""
    x, dtA, b, c = (t.double() for t in (x, dtA, b, c))
    Bsz, L, H, P = x.shape
    state = torch.zeros((Bsz, H, P, b.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(L):
        state = state * torch.exp(dtA[:, t])[..., None, None] \
            + torch.einsum("bn,bhp->bhpn", b[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], state))
    return torch.stack(ys, dim=1), state


@functools.lru_cache(maxsize=None)
def _plan_readings(N: int) -> dict:
    """Scale-free error of each plan against the float64 sequential
    recurrence at one row and two heads of a serving shape (L = 1024,
    chunk 256, P = 64)."""
    args = _inputs(21, 1, 1024, 2, 64, N)
    ref = _recurrence_f64(*args)
    out = {}
    for plan in PLANS:
        got = _plan_scan(*args, 256, plan)
        out[plan] = max(float((g.double() - r).abs().max() / r.abs().max())
                        for g, r in zip(got, ref))
    print(f"N={N}: " + ", ".join(f"{k} {v:.3g}" for k, v in out.items()))
    return out


@pytest.mark.parametrize("N", [128, 64], ids=["mamba2", "zamba2"])
def test_split_bf16_plan_holds_the_ssd_gate(N):
    """The kernel's plan (two bf16 terms a float32 operand, three products)
    stays within SSD_TOL of the float64 recurrence."""
    assert _plan_readings(N)["bf16x3"] <= SSD_TOL


@pytest.mark.parametrize("N", [128, 64], ids=["mamba2", "zamba2"])
def test_one_term_bf16_plan_exceeds_the_ssd_gate(N):
    """Control: operands rounded once to bf16 read above the gate, so the
    gate sees the precision the second term buys."""
    assert _plan_readings(N)["bf16x1"] > SSD_TOL


@pytest.mark.parametrize("N", [128, 64], ids=["mamba2", "zamba2"])
def test_one_term_tf32_reading_lies_between(N):
    """One TF32 term reads between the split plan and one bf16 term (its
    reading is printed, and PERF.md keeps it)."""
    r = _plan_readings(N)
    assert r["bf16x3"] < r["tf32x1"] < r["bf16x1"]


def _scale_free(got, want) -> float:
    """max |got - want| over max |want| (chip_smoke.py's reading)."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
@pytest.mark.parametrize("case", [
    # (B, L, H, N, chunk): 1, 4 and 5 chunks
    (2, 256, 3, 128, 256),
    (1, 1024, 2, 64, 256),
    (2, 200, 3, 128, 40),
], ids=["1-chunk", "4-chunks", "5-chunks"])
def test_ssd_kernel_chunk_counts(cuda, case, with_init):
    """y and the final state within SSD_TOL of both plain versions."""
    B, L, H, N, chunk = case
    x, dtA, b, c = _inputs(22, B, L, H, 64, N, device=cuda)
    s0 = (torch.from_numpy(np.random.default_rng(23).normal(
        size=(B, H, 64, N)).astype(np.float32)).to(cuda)
        if with_init else None)
    got = ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    for ref in (ss.ssd_scan_ref(x, dtA, b, c, initial_state=s0),
                ss.ssd_chunked(x, dtA, b, c, chunk, initial_state=s0)):
        for g, r in zip(got, ref):
            assert _scale_free(g, r) <= SSD_TOL


@pytest.mark.cuda
def test_ssd_kernel_over_several_waves(cuda):
    """Enough (row, chunk, head) units for several waves of every launch
    (the output launch: 4 x 2 x 80 x 4 = 2,560 blocks)."""
    x, dtA, b, c = _inputs(24, 4, 512, 80, 64, 128, device=cuda)
    got = ss.ssd_scan_cuda(x, dtA, b, c, chunk=256)
    ref = ss.ssd_chunked(x, dtA, b, c, 256)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _scale_free(g, r) <= SSD_TOL


@pytest.mark.cuda
def test_ssd_kernel_is_bitwise_reproducible(cuda):
    """No atomics: two calls give the same bits."""
    x, dtA, b, c = _inputs(25, 2, 768, 16, 64, 128, device=cuda)
    s0 = torch.ones((2, 16, 64, 128), device=cuda)
    one = ss.ssd_scan_cuda(x, dtA, b, c, chunk=256, initial_state=s0)
    two = ss.ssd_scan_cuda(x, dtA, b, c, chunk=256, initial_state=s0)
    assert all(torch.equal(p, q) for p, q in zip(one, two))


@pytest.mark.cuda
@pytest.mark.parametrize("N,chunk", [(128, 256), (64, 96)])
def test_ssd_kernel_intermediates_match_chunked(cuda, N, chunk):
    """Each launch's scratch against ssd_chunked's intermediate: C·Bᵀ (on
    and below the diagonal), the chunk states, the states entering each
    chunk and each chunk's decay."""
    B, L, H = 2, 3 * chunk, 5
    x, dtA, b, c = _inputs(26, B, L, H, 64, N, device=cuda)
    s0 = torch.from_numpy(np.random.default_rng(27).normal(
        size=(B, H, 64, N)).astype(np.float32)).to(cuda)
    got = ss.ssd_scan_cuda_steps(x, dtA, b, c, chunk=chunk, initial_state=s0)
    want = ss.ssd_chunked_steps(x, dtA, b, c, chunk, initial_state=s0)
    torch.cuda.synchronize()
    low = torch.ones(chunk, chunk, dtype=torch.bool, device=cuda).tril()
    cb = got["cb"][:, :, :chunk, :chunk]
    assert _scale_free(cb[:, :, low], want["cb"][:, :, low]) <= SSD_TOL
    for name in ("chunk_states", "entering_states", "y", "final_state"):
        assert _scale_free(got[name], want[name]) <= SSD_TOL, name
    # each chunk's summed dtA (down to about -100 here), which the kernel
    # adds in another order than torch.cumsum: within 1e-4 in the exponent
    a_last = torch.cumsum(dtA.reshape(B, L // chunk, chunk, H),
                          dim=2)[:, :, -1]
    torch.testing.assert_close(torch.log(got["chunk_decay"]), a_last,
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, L, H, chunk, initial state): the smoke configs' P = N = 16, which
    # the edge cluster serves (mamba2, zamba2)
    (4, 16, 8, 8, False),
    (4, 16, 8, 8, True),
    (2, 40, 8, 8, True),
    (1, 300, 3, 64, False),
    (2, 96, 2, 96, True),
], ids=str)
def test_ssd_kernel_at_p16_n16_matches_plain(cuda, case):
    """y, the final state and each launch's scratch against
    ``ssd_chunked_steps``'s intermediates, scale-free within SSD_TOL; two
    calls bit-equal; a ragged length through the padding dispatcher."""
    B, L, H, chunk, with_init = case
    x, dtA, b, c = _inputs(32, B, L, H, 16, 16, device=cuda)
    s0 = (torch.from_numpy(np.random.default_rng(33).normal(
        size=(B, H, 16, 16)).astype(np.float32)).to(cuda)
        if with_init else None)
    if L % chunk:
        got = ss.ssd(x, dtA, b, c, chunk=chunk, initial_state=s0,
                     use_kernel=True)
        torch.cuda.synchronize()
        for g, r in zip(got, ss.ssd_scan_ref(x, dtA, b, c,
                                             initial_state=s0)):
            assert _scale_free(g, r) <= SSD_TOL
        return
    got = ss.ssd_scan_cuda_steps(x, dtA, b, c, chunk=chunk,
                                 initial_state=s0)
    want = ss.ssd_chunked_steps(x, dtA, b, c, chunk, initial_state=s0)
    torch.cuda.synchronize()
    low = torch.ones(chunk, chunk, dtype=torch.bool, device=cuda).tril()
    assert _scale_free(got["cb"][:, :, :chunk, :chunk][:, :, low],
                       want["cb"][:, :, low]) <= SSD_TOL
    for k in ("chunk_states", "entering_states", "y", "final_state"):
        assert _scale_free(got[k], want[k]) <= SSD_TOL, k
    again = ss.ssd_scan_cuda(x, dtA, b, c, chunk=chunk, initial_state=s0)
    assert torch.equal(again[0], got["y"])
    assert torch.equal(again[1], got["final_state"])
