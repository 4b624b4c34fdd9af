"""The port's QoS kernels (qos_matrix, qos_candidates and the fused
candidate build topk_candidates, greedy_argmax):
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


def _topk_args(U, M, seed, S=7, ties=False, empty_service=False):
    """Users, an impl table [S, M] (each service 1..M implementations, −1
    padded; with ``empty_service`` the last service has none) and the
    models' attributes. With ``ties`` every model record is drawn from a
    few duplicated ones, so a user's QoS ties across implementations."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    counts = rng.integers(1, M + 1, S)
    counts[0] = M                                      # one full row
    if empty_service:
        counts[-1] = 0
    P = int(counts.sum())
    table = np.full((S, M), -1, np.int32)
    order = rng.permutation(P).astype(np.int32)        # not in service order
    start = 0
    for s, c in enumerate(counts):
        table[s, :c] = np.sort(order[start:start + c])
        start += c
    if ties:
        base = rng.integers(0, 3, P)
        sm_acc = np.array([0.3, 0.6, 0.9], f32)[base]
        sm_k = np.array([5.0, 15.0, 25.0], f32)[base]
        sm_w = np.array([5.0, 15.0, 25.0], f32)[base]
    else:
        sm_acc = rng.uniform(0, 1, P).astype(f32)
        sm_k = rng.uniform(1, 30, P).astype(f32)
        sm_w = rng.uniform(1, 30, P).astype(f32)
    return dict(
        u_service=rng.integers(0, S, U).astype(np.int32),
        u_alpha=rng.uniform(0, 1, U).astype(f32),
        u_delta=rng.uniform(0, 10, U).astype(f32),
        u_share_k=rng.uniform(0.01, 1, U).astype(f32),
        u_share_w=rng.uniform(0.01, 1, U).astype(f32),
        table=table, sm_acc=sm_acc, sm_k=sm_k, sm_w=sm_w)


#: (U, M, k, seed, options) of the candidate-build cases: one user and one
#: slot, k < M, k = M, −1 padding with a service that has no
#: implementation, and duplicated model records whose QoS ties at k < M.
_TOPK_CASES = [(1, 1, None, 0, {}), (300, 7, 3, 1, {}), (257, 10, 10, 2, {}),
               (200, 10, 4, 3, dict(empty_service=True)),
               (300, 10, 4, 4, dict(ties=True)),
               (1, 10, 4, 5, dict(ties=True))]


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


def _topk_composed(a, k):
    """The build as the pre-gathered path composes it: the table gather,
    the segmented QoS of ``qos_candidates``, a stable descending sort at
    k < M."""
    table = a["table"].long()
    M = table.shape[1]
    k_eff = M if k is None else min(k, M)
    cand = table[a["u_service"].long()]
    valid = cand >= 0
    safe = cand.clamp_min(0)
    q = ops.qos_candidates(a["u_alpha"], a["u_delta"], a["u_share_k"],
                           a["u_share_w"], a["sm_acc"][safe],
                           a["sm_k"][safe], a["sm_w"][safe],
                           valid.float(), delta_max=10.0)
    q = torch.where(valid, q, -1.0)
    vals, idx = q, cand                                # k = M: table order
    if k_eff < M:
        vals, order = torch.sort(q, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k_eff], torch.gather(cand, 1, order[:, :k_eff])
    kept = vals >= 0
    return (torch.where(kept, idx, -1).int(), torch.where(kept, vals, 0.0))


@pytest.mark.parametrize("U,M,k,seed,opts", _TOPK_CASES)
def test_topk_candidates_plain_matches_jnp_and_composition(jref, U, M, k,
                                                           seed, opts):
    """The plain candidate build (and the dispatcher on the CPU) against
    the reference's topk_candidates_jnp on a JaxInstance of the same
    arrays, and exactly against the pre-gathered composition."""
    from repro.core.candidates import topk_candidates_jnp
    from repro.core.instance import JaxInstance

    args = _topk_args(U, M, seed, **opts)
    a = _torch(args)
    cols = ("u_service", "u_alpha", "u_delta", "u_share_k", "u_share_w",
            "table", "sm_acc", "sm_k", "sm_w")
    idx, q = tref.topk_candidates_ref(*(a[c] for c in cols), k,
                                      delta_max=10.0)
    k_eff = M if k is None else min(k, M)
    assert idx.dtype == torch.int32 and q.dtype == torch.float32
    assert idx.shape == q.shape == (U, k_eff)
    di, dq = ops.topk_candidates(*(a[c] for c in cols), k, delta_max=10.0)
    assert torch.equal(di, idx) and torch.equal(dq, q)
    ci, cq = _topk_composed(a, k)
    assert torch.equal(ci, idx) and torch.equal(cq, q)

    jinst = JaxInstance(**{f: None for f in JaxInstance.__dataclass_fields__})
    for f in ("u_service", "u_alpha", "u_delta", "u_share_k", "u_share_w",
              "sm_acc", "sm_k", "sm_w"):
        setattr(jinst, f, jref.jnp.asarray(args[f]))
    jinst.delta_max = 10.0
    ji, jq = topk_candidates_jnp(jinst, args["table"], k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **QOS_TOL)
    if opts.get("ties") and U > 1:       # the case really ties at k < M
        qs = np.asarray(jq)
        assert any(len(set(r[r > 0].tolist())) < (r > 0).sum() for r in qs)
    if opts.get("empty_service"):        # its users get no candidate
        none = args["u_service"] == args["table"].shape[0] - 1
        assert none.any()
        assert (idx.numpy()[none] == -1).all() and not q.numpy()[none].any()


def test_topk_candidates_plain_treats_unknown_services_as_empty():
    """A service id outside the table, and an entry outside [0, P), give no
    candidate: the kernel reads nothing out of range, and neither does the
    plain version."""
    a = _torch(_topk_args(6, 4, 0))
    a["u_service"][[1, 4]] = torch.tensor([-1, 7], dtype=torch.int32)
    a["table"][0, 0] = a["sm_acc"].shape[0]              # one past P
    cols = ("u_service", "u_alpha", "u_delta", "u_share_k", "u_share_w",
            "table", "sm_acc", "sm_k", "sm_w")
    idx, q = tref.topk_candidates_ref(*(a[c] for c in cols), 3,
                                      delta_max=10.0)
    assert (idx[[1, 4]] == -1).all() and not q[[1, 4]].any()
    row0 = a["u_service"] == 0
    assert not (idx[row0] == a["sm_acc"].shape[0]).any()


def test_topk_candidates_kernel_limit_raises():
    """An impl table wider than the kernel's register slots raises, naming
    M and the limit, before anything else is looked at."""
    M = ops.TOPK_MAX_IMPLS + 1
    a = _torch(_topk_args(5, M, 0))
    cols = ("u_service", "u_alpha", "u_delta", "u_share_k", "u_share_w",
            "table", "sm_acc", "sm_k", "sm_w")
    with pytest.raises(ValueError, match=f"M = {M}.*{ops.TOPK_MAX_IMPLS}"):
        ops.topk_candidates_cuda(*(a[c] for c in cols), delta_max=10.0)
    with pytest.raises(ValueError, match=f"M = {M}"):
        ops.topk_candidates(*(a[c] for c in cols), 3, delta_max=10.0,
                            use_kernel=True)
    # on the CPU the plain version takes any width
    idx, _ = ops.topk_candidates(*(a[c] for c in cols), 3, delta_max=10.0)
    assert idx.shape == (5, 3)


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
@pytest.mark.parametrize("U,P,seed", [
    (1, 1, 0), (37, 5, 1), (513, 257, 3), (4099, 537, 4),
    # U * P not a multiple of 4 (the kernel's 16-byte groups cross rows and
    # leave a scalar tail), P below 4, and one user
    (1, 3, 5), (7, 1, 6), (5, 3, 7), (1, 537, 8), (1001, 537, 9),
    (3, 2, 10)])
def test_qos_matrix_kernel_matches_plain(cuda, U, P, seed):
    args = _torch(_qos_args(U, P, seed), cuda)
    before = ops.LAUNCHES["qos_matrix"]
    out = ops.qos_matrix(*args.values(), delta_max=10.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["qos_matrix"] == before + 1
    plain = ops.qos_matrix(*args.values(), delta_max=10.0, use_kernel=False)
    torch.testing.assert_close(out, plain, **QOS_TOL)
    assert torch.equal(out, plain)   # the route's OMS argmax needs the bits


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
@pytest.mark.parametrize("U,M,k,seed,opts", _TOPK_CASES + [
    (20011, 10, None, 6, {}), (20011, 10, 3, 7, dict(ties=True)),
    (4099, 16, 16, 8, {}), (4099, 16, 15, 9, {}),
    (5003, 16, 5, 10, dict(S=4000)), (5003, 16, None, 11, dict(S=4000))])
def test_topk_candidates_kernel_matches_plain(cuda, U, M, k, seed, opts):
    """The fused candidate build: cand_idx equal and cand_q bit-equal to
    the plain version, one launch a build, two calls bit-equal. At S =
    4000, M = 16 the table and model records exceed a block's shared
    memory, so the kernel reads them through L2."""
    a = _torch(_topk_args(U, M, seed, **opts), cuda)
    cols = ("u_service", "u_alpha", "u_delta", "u_share_k", "u_share_w",
            "table", "sm_acc", "sm_k", "sm_w")
    before = ops.LAUNCHES["qos_candidates"]
    idx, q = ops.topk_candidates(*(a[c] for c in cols), k, delta_max=10.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["qos_candidates"] == before + 1
    pidx, pq = tref.topk_candidates_ref(*(a[c] for c in cols), k,
                                        delta_max=10.0)
    assert torch.equal(idx, pidx)
    assert torch.equal(q, pq)
    idx2, q2 = ops.topk_candidates_cuda(*(a[c] for c in cols), k,
                                        delta_max=10.0)
    assert torch.equal(idx2, idx) and torch.equal(q2, q)


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


#: Columns on the boundaries of the kernel's per-row split: a row's warp
#: takes 32 consecutive columns a stride, lane l owning l, l + 32, ..., so
#: a tie across lanes is settled by the shuffle merge and one across
#: strides by each lane's scan order.
_SPLIT_EDGES = (0, 1, 30, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256,
                511, 512, 1023, 1024, 2047, 2048, 4095)


def _split_tie_case(P, seed):
    """Rows of width P: for every pair of split-edge columns a < b below P,
    a row with equal maxima at a and b (the first must win) and one with
    a masked off (b must win); an empty row; a row whose only masked-on
    value is -1e30 behind a masked-off column (the masked-off column, -1e30
    too, must win, as in the reference); and random rows with ties."""
    rng = np.random.default_rng(seed)
    edges = [p for p in _SPLIT_EDGES if p < P] + [P - 1]
    pairs = sorted({(a, b) for a in edges for b in edges if a < b})
    rows_v, rows_m = [], []
    for a, b in pairs:
        for mask_a in (True, False):
            v = rng.uniform(-3, 3, P).astype(np.float32)
            m = rng.random(P) < 0.7
            v[[a, b]] = 4.0
            m[a], m[b] = mask_a, True
            rows_v.append(v)
            rows_m.append(m)
    v = rng.normal(size=P).astype(np.float32)
    rows_v.append(v)
    rows_m.append(np.zeros(P, bool))                     # empty row
    v = np.full(P, 7.0, np.float32)
    m = np.zeros(P, bool)
    v[P - 1], m[P - 1] = -1e30, True                     # -1e30 behind
    rows_v.append(v)
    rows_m.append(m)
    v, m = _argmax_case(37, P, seed + 1)
    return (np.concatenate([np.stack(rows_v), v]),
            np.concatenate([np.stack(rows_m), m]))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 31, 32, 33, 127, 128, 129, 537, 1025,
                               4096])
def test_greedy_argmax_kernel_at_split_boundaries(cuda, P):
    """idx exact and best bit-equal against the plain version, with exact
    ties on the boundaries of the kernel's per-row split."""
    v, m = _split_tie_case(P, P)
    vt, mt = torch.from_numpy(v).to(cuda), torch.from_numpy(m).to(cuda)
    before = ops.LAUNCHES["greedy_argmax"]
    best, idx = ops.greedy_argmax_cuda(vt, mt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["greedy_argmax"] == before + 1
    pbest, pidx = tref.greedy_argmax_ref(vt, mt)
    assert torch.equal(idx, pidx)
    assert torch.equal(best, pbest)
    neg = float(np.float32(-1e30))
    if P > 1:                      # the -1e30 row: column 0, masked off
        assert int(idx[-38]) == 0 and float(best[-38]) == neg
    assert int(idx[-39]) == -1 and float(best[-39]) == neg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_greedy_argmax_dispatcher_mask_types(cuda, dtype):
    """The dispatcher takes a bool mask as it is and any other as mask > 0;
    both give the plain version's result."""
    v, m = _argmax_case(1000, 537, 5)
    vt = torch.from_numpy(v).to(cuda)
    mt = torch.from_numpy(m).to(cuda).to(dtype)
    before = ops.LAUNCHES["greedy_argmax"]
    best, idx = ops.greedy_argmax(vt, mt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["greedy_argmax"] == before + 1
    pbest, pidx = ops.greedy_argmax(vt, mt, use_kernel=False)
    assert torch.equal(idx, pidx) and torch.equal(best, pbest)
