"""The port's QoS kernels (qos_matrix, qos_candidates, greedy_argmax):
their plain PyTorch versions against the JAX reference's Pallas kernels
(interpret mode) and jnp oracles on the same seeded inputs, the
dispatchers' device rules, and — on a CUDA card only — each CUDA kernel
against its plain version.

JAX is imported by a fixture, so this file also runs where only the port
is installed (as on a card without JAX): the JAX comparisons skip there and
the kernel tests run."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.qos_matrix import ops, ref as tref

#: The reference's own QoS tolerance (tests/test_kernels.py).
QOS_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture
def jref():
    """The JAX reference's Pallas kernels and jnp oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.qos_matrix import qos_matrix as pallas
    from repro.kernels.qos_matrix import ref

    return types.SimpleNamespace(
        jnp=jnp, qos_matrix_pallas=pallas.qos_matrix_pallas,
        qos_candidates_pallas=pallas.qos_candidates_pallas,
        greedy_argmax_pallas=pallas.greedy_argmax_pallas,
        qos_matrix_ref=ref.qos_matrix_ref,
        qos_candidates_ref=ref.qos_candidates_ref,
        greedy_argmax_ref=ref.greedy_argmax_ref)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _qos_args(U, P, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        u_alpha=rng.uniform(0, 1, U).astype(f32),
        u_delta=rng.uniform(0, 10, U).astype(f32),
        u_share_k=rng.uniform(0.01, 1, U).astype(f32),
        u_share_w=rng.uniform(0.01, 1, U).astype(f32),
        u_service=rng.integers(0, 7, U).astype(np.int32),
        sm_acc=rng.uniform(0, 1, P).astype(f32),
        sm_k=rng.uniform(1, 30, P).astype(f32),
        sm_w=rng.uniform(1, 30, P).astype(f32),
        sm_service=rng.integers(0, 7, P).astype(np.int32),
    )


def _cand_args(U, K, seed, frac_valid=0.8):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        u_alpha=rng.uniform(0, 1, U).astype(f32),
        u_delta=rng.uniform(0, 10, U).astype(f32),
        u_share_k=rng.uniform(0.01, 1, U).astype(f32),
        u_share_w=rng.uniform(0.01, 1, U).astype(f32),
        cand_acc=rng.uniform(0, 1, (U, K)).astype(f32),
        cand_k=rng.uniform(1, 30, (U, K)).astype(f32),
        cand_w=rng.uniform(1, 30, (U, K)).astype(f32),
        cand_valid=(rng.random((U, K)) < frac_valid).astype(f32),
    )


def _torch(args, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in args.items()}


def _jax(jref, args):
    return {k: jref.jnp.asarray(v) for k, v in args.items()}


def _argmax_case(E, P, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(E, P)).astype(np.float32)       # negatives too
    v[:, ::3] = np.round(v[:, ::3])                      # exact ties
    m = rng.random((E, P)) < 0.5
    m[::4] = False                                       # empty rows
    return v, m


# ===========================================================================
# plain versions vs the JAX reference (CPU)
# ===========================================================================

@pytest.mark.parametrize("U,P,seed", [(1, 1, 0), (37, 5, 1), (300, 131, 2),
                                      (513, 257, 3)])
def test_qos_matrix_plain_matches_pallas_and_jnp(jref, U, P, seed):
    args = _qos_args(U, P, seed)
    pallas = jref.qos_matrix_pallas(*_jax(jref, args).values(),
                                    delta_max=10.0, block_u=128, block_p=128,
                                    interpret=True)
    oracle = jref.qos_matrix_ref(*_jax(jref, args).values(), delta_max=10.0)
    port = tref.qos_matrix_ref(*_torch(args).values(), delta_max=10.0)
    assert port.dtype == torch.float32 and port.shape == (U, P)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **QOS_TOL)
    np.testing.assert_allclose(port.numpy(), np.asarray(oracle), **QOS_TOL)
    # the dispatcher takes the plain version because the tensors are on CPU
    disp = ops.qos_matrix(*_torch(args).values(), delta_max=10.0)
    assert torch.equal(disp, port)


@pytest.mark.parametrize("U,K,seed", [(1, 1, 0), (300, 7, 1), (257, 10, 2),
                                      (513, 20, 3)])
def test_qos_candidates_plain_matches_pallas_and_jnp(jref, U, K, seed):
    args = _cand_args(U, K, seed)
    pallas = jref.qos_candidates_pallas(*_jax(jref, args).values(),
                                        delta_max=10.0, block_u=128,
                                        block_k=128, interpret=True)
    oracle = jref.qos_candidates_ref(*_jax(jref, args).values(),
                                     delta_max=10.0)
    port = tref.qos_candidates_ref(*_torch(args).values(), delta_max=10.0)
    assert port.shape == (U, K)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **QOS_TOL)
    np.testing.assert_allclose(port.numpy(), np.asarray(oracle), **QOS_TOL)
    assert not port.numpy()[args["cand_valid"] == 0].any()
    disp = ops.qos_candidates(*_torch(args).values(), delta_max=10.0)
    assert torch.equal(disp, port)


@pytest.mark.parametrize("E,P,seed", [(1, 1, 0), (3, 33, 1), (17, 130, 2),
                                      (40, 400, 3)])
def test_greedy_argmax_plain_matches_pallas_and_jnp(jref, E, P, seed):
    v, m = _argmax_case(E, P, seed)
    jnp = jref.jnp
    bp, ip = jref.greedy_argmax_pallas(jnp.asarray(v), jnp.asarray(m),
                                       block_e=4, interpret=True)
    bj, ij = jref.greedy_argmax_ref(jnp.asarray(v), jnp.asarray(m))
    bt, it = tref.greedy_argmax_ref(torch.from_numpy(v), torch.from_numpy(m))
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    has = m.any(axis=1)
    np.testing.assert_array_equal(bt.numpy()[has], np.asarray(bp)[has])
    assert np.all(it.numpy()[~has] == -1)
    # float masks (the reference's form) give the same result as bool ones
    bf, idf = ops.greedy_argmax(torch.from_numpy(v),
                                torch.from_numpy(m.astype(np.float32)))
    assert torch.equal(idf, it) and torch.equal(bf, bt)


def test_greedy_argmax_ties_negatives_and_empty_rows(jref):
    v = np.asarray([[1.0, 3.0, 3.0, -2.0],     # tie → first occurrence
                    [-5.0, -1.0, -9.0, -1.0],  # all-negative tie
                    [7.0, 8.0, 9.0, 10.0],     # mask empty → −1
                    [0.0, 0.0, 0.0, 0.0]],     # uniform zeros
                   np.float32)
    m = np.asarray([[1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0], [0, 1, 0, 1]],
                   bool)
    best, idx = tref.greedy_argmax_ref(torch.from_numpy(v),
                                       torch.from_numpy(m))
    assert idx.tolist() == [1, 1, -1, 1]
    assert best.numpy().tolist() == np.float32([3.0, -1.0, -1e30,
                                                0.0]).tolist()
    bp, ip = jref.greedy_argmax_pallas(jref.jnp.asarray(v),
                                       jref.jnp.asarray(m), block_e=2,
                                       interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ip))
    np.testing.assert_array_equal(best.numpy(), np.asarray(bp))


# ===========================================================================
# guards and device rules
# ===========================================================================

def test_check_service_ids_raises_on_int32_overflow():
    ok = np.array([0, 5, 2**31 - 1], dtype=np.int64)
    ops.check_service_ids(ok, torch.from_numpy(ok))
    for bad in (np.array([0, 2**31], dtype=np.int64),
                np.array([-2**31 - 1], dtype=np.int64)):
        with pytest.raises(OverflowError):
            ops.check_service_ids(ok, bad)
        with pytest.raises(OverflowError):
            ops.check_service_ids(torch.from_numpy(bad))
    args = _torch(_qos_args(4, 3, 0))
    args["u_service"] = torch.tensor([0, 1, 2**31, 3], dtype=torch.int64)
    with pytest.raises(OverflowError):
        ops.qos_matrix(*args.values(), delta_max=10.0)


def test_dispatchers_raise_when_asked_for_the_kernel_on_cpu():
    counts = dict(ops.LAUNCHES)
    q = _torch(_qos_args(5, 4, 0))
    c = _torch(_cand_args(5, 3, 0))
    v, m = _argmax_case(3, 8, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.qos_matrix(*q.values(), delta_max=10.0, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.qos_candidates(*c.values(), delta_max=10.0, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.greedy_argmax(torch.from_numpy(v), torch.from_numpy(m),
                          use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.qos_matrix_cuda(*q.values(), delta_max=10.0)
    assert ops.LAUNCHES == counts            # nothing counted as launched


def test_launch_counters_reset():
    ops.LAUNCHES["greedy_argmax"] += 3
    ops.reset_launch_counts()
    assert set(ops.LAUNCHES) == {"qos_matrix", "qos_candidates",
                                 "greedy_argmax"}
    assert not any(ops.LAUNCHES.values())


# ===========================================================================
# CUDA kernels vs their plain versions (card only)
# ===========================================================================

@pytest.mark.cuda
@pytest.mark.parametrize("U,P,seed", [(1, 1, 0), (37, 5, 1), (513, 257, 3),
                                      (4099, 537, 4)])
def test_qos_matrix_kernel_matches_plain(cuda, U, P, seed):
    args = _torch(_qos_args(U, P, seed), cuda)
    before = ops.LAUNCHES["qos_matrix"]
    out = ops.qos_matrix(*args.values(), delta_max=10.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["qos_matrix"] == before + 1
    plain = ops.qos_matrix(*args.values(), delta_max=10.0, use_kernel=False)
    torch.testing.assert_close(out, plain, **QOS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("U,K,seed", [(1, 1, 0), (300, 7, 1), (257, 10, 2),
                                      (20011, 10, 3)])
def test_qos_candidates_kernel_matches_plain(cuda, U, K, seed):
    args = _torch(_cand_args(U, K, seed), cuda)
    before = ops.LAUNCHES["qos_candidates"]
    out = ops.qos_candidates(*args.values(), delta_max=10.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["qos_candidates"] == before + 1
    plain = ops.qos_candidates(*args.values(), delta_max=10.0,
                               use_kernel=False)
    torch.testing.assert_close(out, plain, **QOS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("E,P,seed", [(1, 1, 0), (3, 33, 1), (40, 400, 3),
                                      (1000, 537, 4)])
def test_greedy_argmax_kernel_matches_plain(cuda, E, P, seed):
    v, m = _argmax_case(E, P, seed)
    vt, mt = torch.from_numpy(v).to(cuda), torch.from_numpy(m).to(cuda)
    before = ops.LAUNCHES["greedy_argmax"]
    best, idx = ops.greedy_argmax(vt, mt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["greedy_argmax"] == before + 1
    pbest, pidx = ops.greedy_argmax(vt, mt, use_kernel=False)
    assert torch.equal(idx, pidx)
    assert torch.equal(best, pbest)
