"""The SSD scan's backward: the plain explicit gradient ``ssd_chunked_bwd``
against torch's autograd of ``ssd_chunked`` (float64) and against
``jax.grad`` of the JAX reference's ``ssd_chunked`` (float32), the
``SSDScan`` autograd Function (gradcheck), the dispatcher under grad on
the CPU, the backward kernel's precision plan emulated on the CPU (its
products as split bf16 terms, the sums over heads in its order) against
the float64 plain version, and — on a CUDA card only — the backward kernel
against the plain version and two calls bit for bit.

JAX is imported by a fixture, so this file also runs where only the port
is installed (as on a card without JAX). Tolerances: 1e-10 of each
gradient's largest |value| in float64 (the same function, another order
of sums); 1e-5 in float32 against the reference (float32 rounding of two
orders of sums); 3e-4 on the card against the float64 plain version, the
forward kernel's gate (tests/test_torch_ssd.py)."""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as ss
from torch_recorders import recorders_off  # noqa: F401  (autouse)
from torch_split_plan import PLANS, SSD_TOL, _plan_mm

F64_TOL, JAX_TOL, KERNEL_TOL = 1e-10, 1e-5, 3e-4
#: (B, L, H, P, N, chunk): 1 to 4 chunks, and L not a multiple of it.
CASES = [(2, 8, 3, 16, 16, 8), (1, 16, 2, 8, 4, 8), (2, 24, 2, 16, 16, 8),
         (1, 32, 3, 8, 4, 8), (2, 21, 2, 8, 4, 8), (1, 13, 2, 16, 16, 4)]
NAMES = ("dx", "ddtA", "db", "dc", "dinit")


@pytest.fixture
def jax():
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, B, L, H, P, N, with_init, with_dfinal, dtype=np.float64):
    """x, dtA, b, c, the initial state and the upstream dy, dfinal as the
    reference's kernel tests draw them (dtA = -U(0.01, 0.4)), as NumPy."""
    rng = np.random.default_rng(seed)
    arrs = dict(x=rng.normal(size=(B, L, H, P)),
                dtA=-rng.uniform(0.01, 0.4, size=(B, L, H)),
                b=rng.normal(size=(B, L, N)), c=rng.normal(size=(B, L, N)),
                init=rng.normal(size=(B, H, P, N)) if with_init else None,
                dy=rng.normal(size=(B, L, H, P)),
                dfinal=rng.normal(size=(B, H, P, N)) if with_dfinal
                else None)
    return {k: None if a is None else a.astype(dtype)
            for k, a in arrs.items()}


def _t(a, device="cpu", grad=False):
    return None if a is None else torch.from_numpy(a).to(device) \
        .requires_grad_(grad)


def _padded(arrs, chunk):
    """The inputs and dy padded with zeros to a multiple of ``chunk``, as
    the dispatcher pads (a padded position's dy is 0: the slice back cuts
    its gradient off)."""
    L = arrs["x"].shape[1]
    pad = (-L) % chunk
    out = dict(arrs)
    for k in ("x", "dtA", "b", "c", "dy"):
        widths = [(0, 0)] * arrs[k].ndim
        widths[1] = (0, pad)
        out[k] = np.pad(arrs[k], widths)
    return out


def _autograd(arrs, chunk):
    """Autograd of ``ssd_chunked`` (through the dispatcher's padding) in
    the inputs' dtype: the gradients of x, dtA, b, c and the initial state
    (of a zero one where there is none)."""
    x, dtA, b, c = (_t(arrs[k], grad=True) for k in ("x", "dtA", "b", "c"))
    init = _t(arrs["init"], grad=True) if arrs["init"] is not None else \
        torch.zeros(arrs["x"].shape[0], arrs["x"].shape[2],
                    arrs["x"].shape[3], arrs["b"].shape[-1],
                    dtype=x.dtype, requires_grad=True)
    L = x.shape[1]
    pad = (-L) % chunk
    y, s = ss.ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                          F.pad(dtA, (0, 0, 0, pad)), F.pad(b, (0, 0, 0, pad)),
                          F.pad(c, (0, 0, 0, pad)), chunk, init)
    loss = (y[:, :L] * _t(arrs["dy"])).sum()
    if arrs["dfinal"] is not None:
        loss = loss + (s * _t(arrs["dfinal"])).sum()
    return torch.autograd.grad(loss, (x, dtA, b, c, init))


def _explicit(arrs, chunk, device="cpu", use_kernel=False):
    """``ssd_scan_bwd`` on the padded inputs, cut back to ``L``."""
    L = arrs["x"].shape[1]
    p = _padded(arrs, chunk)
    x, dtA, b, c, init = (_t(p[k], device) for k in
                          ("x", "dtA", "b", "c", "init"))
    steps = ss.ssd_chunked_steps(x, dtA, b, c, chunk, init)
    out = ss.ssd_scan_bwd(x, dtA, b, c, _t(p["dy"], device), chunk=chunk,
                          entering_states=steps["entering_states"],
                          chunk_decay=steps["chunk_decay"],
                          dfinal=_t(p["dfinal"], device),
                          use_kernel=use_kernel)
    return tuple(g[:, :L] if i < 4 else g for i, g in enumerate(out))


def _scale_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("with_dfinal", [False, True], ids=["dy", "dfinal"])
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_autograd_in_float64(case, with_init,
                                                    with_dfinal):
    B, L, H, P, N, chunk = case
    arrs = _inputs(sum(case), B, L, H, P, N, with_init, with_dfinal)
    for name, got, ref in zip(NAMES, _explicit(arrs, chunk),
                              _autograd(arrs, chunk)):
        assert got.dtype == torch.float64 and got.shape == ref.shape, name
        assert _scale_err(got, ref) <= F64_TOL, (name, _scale_err(got, ref))


@pytest.mark.parametrize("with_dfinal", [False, True], ids=["dy", "dfinal"])
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_plain_backward_matches_jax_grad(jax, case, with_init, with_dfinal):
    """float32, against ``jax.grad`` of the reference layer's
    ``ssd_chunked`` (which is what the reference's Mamba block
    differentiates)."""
    from repro.models.layers import ssd_chunked as jssd

    jnp = jax.numpy
    B, L, H, P, N, chunk = case
    arrs = _inputs(sum(case) + 1, B, L, H, P, N, with_init, with_dfinal,
                   np.float32)
    init = arrs["init"] if with_init else np.zeros((B, H, P, N), np.float32)

    def loss(x, dtA, b, c, s0):
        y, s = jssd(x, dtA, b, c, chunk, initial_state=s0)
        out = jnp.sum(y * arrs["dy"])
        if with_dfinal:
            out = out + jnp.sum(s * arrs["dfinal"])
        return out

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (arrs["x"], arrs["dtA"], arrs["b"],
                                   arrs["c"], init)))
    for name, got, r in zip(NAMES, _explicit(arrs, chunk), ref):
        r = torch.from_numpy(np.array(r))
        assert got.dtype == torch.float32, name
        assert _scale_err(got, r) <= JAX_TOL, (name, _scale_err(got, r))


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("case", [(1, 16, 2, 8, 4, 8), (2, 8, 1, 16, 16, 4)],
                         ids=str)
def test_ssd_scan_function_passes_gradcheck(case, with_init):
    B, L, H, P, N, chunk = case
    arrs = _inputs(7, B, L, H, P, N, with_init, False)
    args = [_t(arrs[k], grad=True) for k in ("x", "dtA", "b", "c")]
    args.append(_t(arrs["init"], grad=True))
    assert torch.autograd.gradcheck(
        lambda *a: ss.SSDScan.apply(*a, chunk, False), args, eps=1e-6,
        atol=1e-8, rtol=1e-6)


@pytest.mark.parametrize("case", [CASES[2], CASES[4]], ids=str)
def test_dispatcher_under_grad_gives_the_plain_gradients(case):
    """``ssd`` under grad on the CPU goes through ``SSDScan`` (it used to
    refuse the kernel path) and returns autograd's gradients of the plain
    scan, the padding's cut off."""
    B, L, H, P, N, chunk = case
    arrs = _inputs(11, B, L, H, P, N, True, True)
    x, dtA, b, c, init = (_t(arrs[k], grad=True) for k in
                          ("x", "dtA", "b", "c", "init"))
    y, s = ss.ssd(x, dtA, b, c, chunk=chunk, initial_state=init)
    assert type(s.grad_fn).__name__ == "SSDScanBackward"
    assert y.grad_fn.next_functions[0][0] is s.grad_fn
    loss = (y * _t(arrs["dy"])).sum() + (s * _t(arrs["dfinal"])).sum()
    got = torch.autograd.grad(loss, (x, dtA, b, c, init))
    for name, g, r in zip(NAMES, got, _autograd(arrs, chunk)):
        assert _scale_err(g, r) <= F64_TOL, name
    assert ss.LAUNCHES["ssd_scan"] == ss.LAUNCHES["ssd_scan_bwd"] == 0


def test_unused_final_state_and_no_grad_paths():
    """A loss that never reads the final state (training's) passes no
    dfinal; without grad the dispatcher keeps its no-graph path."""
    arrs = _inputs(12, 1, 16, 2, 8, 4, False, False)
    x = _t(arrs["x"], grad=True)
    y, _ = ss.ssd(x, *(_t(arrs[k]) for k in ("dtA", "b", "c")), chunk=8)
    (y * _t(arrs["dy"])).sum().backward()
    ref = _autograd(arrs, 8)[0]
    assert _scale_err(x.grad, ref) <= F64_TOL
    with torch.no_grad():
        y, s = ss.ssd(x, *(_t(arrs[k]) for k in ("dtA", "b", "c")), chunk=8)
    assert y.grad_fn is None and s.grad_fn is None


def test_backward_wrapper_refuses_cpu_tensors_and_bad_shapes():
    arrs = _inputs(13, 1, 16, 2, 16, 16, False, False, np.float32)
    x, dtA, b, c, dy = (_t(arrs[k]) for k in ("x", "dtA", "b", "c", "dy"))
    steps = ss.ssd_chunked_steps(x, dtA, b, c, 8)
    kw = dict(entering_states=steps["entering_states"],
              chunk_decay=steps["chunk_decay"])
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_bwd(x, dtA, b, c, dy, chunk=8, use_kernel=True, **kw)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ss.ssd_scan_bwd_cuda(x[..., :8].contiguous(), dtA, b, c,
                             dy[..., :8].contiguous(), chunk=8, **kw)
    with pytest.raises(ValueError, match="multiple"):
        ss.ssd_scan_bwd_cuda(x, dtA, b, c, dy, chunk=24, **kw)
    assert ss.LAUNCHES["ssd_scan_bwd"] == 0


# ===========================================================================
# the backward kernel's precision plan, emulated on the CPU
# ===========================================================================

def _plan_bwd(x, dtA, b, c, dy, chunk, entering, decay, dfinal, plan):
    """The backward kernel's steps (csrc/ssd_scan_bwd.cu), every product
    through :func:`_plan_mm` and every sum over heads in the kernel's
    order: C·Bᵀ once per row and chunk; each chunk's state gradient (e^a
    dy)ᵀ·C and the reverse recurrence in float32; dCB = Σ_h L_h ∘ (dy_h
    x_hᵀ) per 64 x 64 tile, heads in order (off the diagonal tile one
    product of depth H·P with L's two factors folded into the operands);
    dc = Σ_h (e^a dy_h)·S_h, each head's product formed apart and added in
    order, whose row sums against C are da's Σ_p dy y_off, plus dCB·B; db
    one product of depth H·P, (w x)·dS over the heads in order, plus
    dCBᵀ·C; per head, U = B·dSᵀ (dx's state term w U and -w Σ_p x U) and
    Mᵀ = x·dyᵀ with the scores (C Bᵀ ∘ L)ᵀ, whose product with dy adds to
    dx and whose product with Mᵀ gives da's row and column sums. Returns
    ``(dx, ddtA, db, dc, dinit)``."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    nc, Q = L // chunk, chunk

    def heads(t):                                   # -> [b, c, h, q, p]
        return t.reshape(Bsz, nc, Q, H, -1).permute(0, 1, 3, 2, 4)

    def flat(t):                                    # -> [b, c, q, h p]
        return t.permute(0, 1, 3, 2, 4).reshape(Bsz, nc, t.shape[3], H * P)

    xc, dyc = heads(x), heads(dy)
    bc, cc = b.reshape(Bsz, nc, Q, N), c.reshape(Bsz, nc, Q, N)
    a = torch.cumsum(dtA.reshape(Bsz, nc, Q, H), dim=2).permute(0, 1, 3, 2)
    eq, w = torch.exp(a), torch.exp(a[..., -1:] - a)          # [b, c, h, q]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    seg = a[..., :, None] - a[..., None, :]
    lm = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)

    cb = _plan_mm(cc, bc.transpose(-1, -2), plan)             # [b, c, q, s]
    g = _plan_mm((dyc * eq[..., None]).transpose(-1, -2), cc[:, :, None],
                 plan)                                        # [b, c, h, p, n]
    ds = torch.zeros_like(g[:, 0]) if dfinal is None else dfinal
    dst = [None] * nc
    for ci in reversed(range(nc)):
        dst[ci] = ds
        ds = g[:, ci] + decay[:, ci, :, None, None] * ds
    dst = torch.stack(dst, dim=1)                             # [b, c, h, p, n]

    u = _plan_mm(bc[:, :, None], dst.transpose(-1, -2), plan)  # rows s
    ys = _plan_mm(dyc * eq[..., None], entering, plan)        # [b, c, h, q, n]
    cbl = (cb[:, :, None] * lm).transpose(-1, -2)             # [b, c, h, s, q]
    t = cbl * _plan_mm(xc, dyc.transpose(-1, -2), plan)
    wdw = w * (xc * u).sum(-1)
    dx = w[..., None] * u + _plan_mm(cbl, dyc, plan)
    da = t.sum(-2) - t.sum(-1) + (cc[:, :, None] * ys).sum(-1) - wdw
    da[..., -1] += wdw.sum(-1) + decay * (entering * dst).sum((-1, -2))
    ddtA = torch.flip(torch.cumsum(torch.flip(da, (-1,)), -1), (-1,))

    dcb = torch.zeros(Bsz, nc, Q, Q)
    for q0 in range(0, Q, 64):
        for s0 in range(0, q0 + 1, 64):
            qs, ss_ = slice(q0, q0 + 64), slice(s0, s0 + 64)
            if q0 == s0:    # each head apart, times L element by element
                m = _plan_mm(dyc[..., qs, :], xc[..., ss_, :]
                             .transpose(-1, -2), plan)
                for h in range(H):
                    dcb[..., qs, ss_] += lm[:, :, h, qs, ss_] * m[:, :, h]
                continue
            # off the diagonal L = exp(a_q - a_r) exp(a_r - a_s), a_r at the
            # s tile's last row, folded into the operands: one product of
            # depth H P, heads in order
            a_r = a[..., min(s0 + 63, Q - 1), None]
            dq = dyc[..., qs, :] * torch.exp(a[..., qs] - a_r)[..., None]
            xs = xc[..., ss_, :] * torch.exp(a_r - a[..., ss_])[..., None]
            dcb[..., qs, ss_] = _plan_mm(flat(dq), flat(xs).transpose(-1, -2),
                                         plan)
    dc = ys[:, :, 0]
    for h in range(1, H):
        dc = dc + ys[:, :, h]
    dc = dc + _plan_mm(dcb, bc, plan)
    db = _plan_mm(torch.cat([flat(xc * w[..., None]),
                             dcb.transpose(-1, -2)], -1),
                  torch.cat([dst.reshape(Bsz, nc, H * P, N), cc], -2), plan)
    return (flat(dx).reshape(Bsz, L, H, P),
            ddtA.permute(0, 1, 3, 2).reshape(Bsz, L, H),
            db.reshape(Bsz, L, N), dc.reshape(Bsz, L, N), ds)


@functools.lru_cache(maxsize=None)
def _bwd_plan_readings(N: int) -> dict:
    """Scale-free error of each plan's gradients against the float64 plain
    backward at one row and two heads of a training shape (L = 1024, chunk
    256, P = 64), with an initial state and dfinal; the forward's entering
    states and chunk decay are float64's, rounded to float32."""
    arrs = _inputs(31 + N, 1, 1024, 2, 64, N, True, True)
    d = {k: _t(a) for k, a in arrs.items()}
    steps = ss.ssd_chunked_steps(d["x"], d["dtA"], d["b"], d["c"], 256,
                                 d["init"])
    ref = ss.ssd_chunked_bwd(d["x"], d["dtA"], d["b"], d["c"], d["dy"],
                             d["dfinal"], d["init"], chunk=256)
    f = {k: a.float() for k, a in d.items()}
    out = {}
    for plan in PLANS:
        got = _plan_bwd(f["x"], f["dtA"], f["b"], f["c"], f["dy"], 256,
                        steps["entering_states"].float(),
                        steps["chunk_decay"].float(), f["dfinal"], plan)
        out[plan] = {n: _scale_err(g, r) for n, g, r in zip(NAMES, got, ref)}
        print(f"N={N} {plan}: ddtA {out[plan]['ddtA']:.3g}; "
              + ", ".join(f"{n} {e:.3g}" for n, e in out[plan].items()
                          if n != "ddtA"))
    return out


@pytest.mark.parametrize("N", [128, 64], ids=["mamba2", "zamba2"])
def test_split_bf16_plan_holds_the_backward_gate(N):
    """The kernel's plan (two bf16 terms a float32 operand, three products,
    the sums over heads in its order) keeps every gradient, ddtA
    included, within SSD_TOL of the float64 plain backward."""
    r = _bwd_plan_readings(N)["bf16x3"]
    assert all(e <= SSD_TOL for e in r.values()), r


@pytest.mark.parametrize("N", [128, 64], ids=["mamba2", "zamba2"])
def test_one_term_bf16_backward_exceeds_the_gate(N):
    """Control: operands rounded once to bf16 read above the gate for at
    least one gradient, so the gate sees the precision the second term
    buys."""
    r = _bwd_plan_readings(N)["bf16x1"]
    assert max(r.values()) > SSD_TOL, r


# ===========================================================================
# the backward kernel vs its plain version (card only)
# ===========================================================================

@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, L, H, P, N, chunk, initial state, dfinal)
    (2, 64, 3, 16, 16, 8, True, True),
    (1, 40, 2, 16, 16, 8, False, False),
    (1, 21, 3, 16, 16, 8, True, False),         # L not a multiple
    (2, 256, 3, 64, 64, 64, False, True),
    (1, 512, 2, 64, 128, 256, True, True),
    (1, 200, 2, 64, 128, 40, True, False),      # chunk not a multiple of 64
    (1, 300, 1, 64, 64, 256, False, False),     # 2 chunks, ragged
], ids=str)
def test_backward_kernel_matches_plain(cuda, case):
    B, L, H, P, N, chunk, with_init, with_dfinal = case
    arrs = _inputs(sum(case[:6]), B, L, H, P, N, with_init, with_dfinal,
                   np.float32)
    ref = _explicit({k: None if a is None else a.astype(np.float64)
                     for k, a in arrs.items()}, chunk, cuda)
    n0 = ss.LAUNCHES["ssd_scan_bwd"]
    got = _explicit(arrs, chunk, cuda, use_kernel=True)
    again = _explicit(arrs, chunk, cuda, use_kernel=True)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan_bwd"] == n0 + 2
    for name, g, a, r in zip(NAMES, got, again, ref):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert _scale_err(g, r) <= KERNEL_TOL, (name, _scale_err(g, r))
        assert torch.equal(g, a), f"{name}: two calls differ"


@pytest.mark.cuda
def test_training_path_goes_through_the_backward_kernel(cuda):
    """``ssd`` under grad on the card: B8 forward, the backward kernel
    once, gradients within the gate of the plain version's."""
    arrs = _inputs(21, 2, 300, 2, 64, 64, True, False, np.float32)
    grads = []
    for use_kernel in (None, False):
        ins = [_t(arrs[k], cuda, grad=True) for k in
               ("x", "dtA", "b", "c", "init")]
        ss.reset_launch_counts()
        y, _ = ss.ssd(*ins[:4], chunk=256, initial_state=ins[4],
                      use_kernel=use_kernel)
        (y * _t(arrs["dy"], cuda)).sum().backward()
        torch.cuda.synchronize()
        n = 1 if use_kernel is None else 0
        assert ss.LAUNCHES == {"ssd_scan": n, "ssd_scan_bwd": n}
        grads.append([t.grad for t in ins])
    for name, g, r in zip(NAMES, *grads):
        assert _scale_err(g, r) <= KERNEL_TOL, name
