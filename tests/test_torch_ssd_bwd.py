"""The SSD scan's backward: the plain explicit gradient ``ssd_chunked_bwd``
against torch's autograd of ``ssd_chunked`` (float64) and against
``jax.grad`` of the JAX reference's ``ssd_chunked`` (float32), the
``SSDScan`` autograd Function (gradcheck), the dispatcher under grad on
the CPU, and — on a CUDA card only — the backward kernel against the plain
version and two calls bit for bit.

JAX is imported by a fixture, so this file also runs where only the port
is installed (as on a card without JAX). Tolerances: 1e-10 of each
gradient's largest |value| in float64 (the same function, another order
of sums); 1e-5 in float32 against the reference (float32 rounding of two
orders of sums); 3e-4 on the card against the float64 plain version, the
forward kernel's gate (tests/test_torch_ssd.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as ss
from torch_recorders import recorders_off  # noqa: F401  (autouse)

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
