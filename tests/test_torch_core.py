"""The port's core (repro_torch.core, repro_torch.convert) against the JAX
reference's repro.core on the same seeds: generators byte for byte, the
device instance bit for bit, and the torch twins of the jnp functions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.convert import (from_jax_instance, placement_to_numpy,
                                 to_numpy)

_GENERATORS = [
    ("synthetic_instance", dict(n_users=400, n_edges=5, seed=0)),
    ("synthetic_instance", dict(n_users=57, n_edges=3, n_services=9,
                                max_impls=4, seed=11)),
    ("realworld_instance", dict(n_users=300, seed=2)),
    ("tiny_instance", dict(seed=5)),
]

_JAX_FIELDS = ("u_alpha", "u_delta", "u_service", "u_edge", "u_share_k",
               "u_share_w", "sm_service", "sm_acc", "sm_k", "sm_w", "sm_r",
               "R", "delta_max")


def _pair(seed=2, n_users=300, n_edges=10, **kw):
    return (R.synthetic_instance(n_users, n_edges=n_edges, seed=seed, **kw),
            T.synthetic_instance(n_users, n_edges=n_edges, seed=seed, **kw))


def _jax_arrays(ri):
    ji = ri.as_jax()
    return {f: np.asarray(getattr(ji, f)) for f in _JAX_FIELDS}


@pytest.mark.parametrize("name,kw", _GENERATORS)
def test_generators_byte_identical(name, kw):
    ri, ti = getattr(R, name)(**kw), getattr(T, name)(**kw)
    for f in dataclasses.fields(R.PIESInstance):
        a, b = getattr(ri, f.name), getattr(ti, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed", [0, 3])
def test_draw_helpers_byte_identical(seed):
    for fn, args in (("draw_edge_capacities", (7,)),
                     ("draw_service_catalog", (12, 5))):
        a = getattr(R, fn)(np.random.default_rng(seed), *args)
        b = getattr(T, fn)(np.random.default_rng(seed), *args)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name,kw", _GENERATORS)
def test_torch_instance_bit_equal_to_as_jax(name, kw):
    ri, pi = getattr(R, name)(**kw), getattr(T, name)(**kw)
    ref = _jax_arrays(ri)
    ti = T.TorchInstance.from_pies(pi, "cpu")
    assert isinstance(ti.delta_max, float)
    assert np.float32(ti.delta_max) == ref["delta_max"]
    for f in _JAX_FIELDS[:-1]:
        got = getattr(ti, f).numpy()
        assert got.dtype == ref[f].dtype, f          # f32 / i32, never f64
        assert got.tobytes() == ref[f].tobytes(), f


def test_from_jax_instance_round_trip():
    ri, _ = _pair(seed=4)
    arrays = _jax_arrays(ri)
    ti = from_jax_instance(arrays, "cpu")
    back = to_numpy(ti)
    for f in _JAX_FIELDS:
        assert back[f].dtype == arrays[f].dtype, f
        np.testing.assert_array_equal(back[f], arrays[f])
    x = torch.rand(ri.E, ri.P, generator=torch.Generator().manual_seed(0))
    xn = placement_to_numpy(x < 0.3)
    assert xn.dtype == bool and xn.shape == (ri.E, ri.P)
    # a port placement scored by the reference's host oracle
    assert R.sigma_np(ri, xn) == pytest.approx(T.sigma_np(ri, xn), abs=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_oracles_identical(seed):
    ri, pi = _pair(seed=seed, n_users=250, n_edges=4)
    Qr, Qp = R.qos_matrix_np(ri), T.qos_matrix_np(pi)
    assert Qr.tobytes() == Qp.tobytes()
    np.testing.assert_array_equal(R.eligibility_np(ri), T.eligibility_np(pi))
    xr, xp = R.egp_np(ri, Qr), T.egp_np(pi, Qp)
    np.testing.assert_array_equal(xr, xp)
    yr, vr = R.oms_np(ri, xr, Qr)
    yp, vp = T.oms_np(pi, xp, Qp)
    np.testing.assert_array_equal(yr, yp)
    assert vr == vp
    np.testing.assert_array_equal(R.sigma_user_np(ri, xr, Qr),
                                  T.sigma_user_np(pi, xp, Qp))
    np.testing.assert_array_equal(R.impl_table_np(ri.sm_service, ri.S),
                                  T.impl_table_np(pi.sm_service, pi.S))
    assert R.max_impls_of(ri) == T.max_impls_of(pi)
    for k in (None, 2):
        cr, cp = R.topk_candidates_np(ri, k, Qr), T.topk_candidates_np(pi, k,
                                                                       Qp)
        np.testing.assert_array_equal(cr.cand_idx, cp.cand_idx)
        np.testing.assert_array_equal(cr.cand_q, cp.cand_q)
        assert (cr.k, cr.exact) == (cp.k, cp.exact)
        assert R.sigma_sparse_np(ri, xr, cr) == T.sigma_sparse_np(pi, xp, cp)


def test_qos_matrix_torch_matches_jnp():
    ri, pi = _pair(seed=5)
    Qj = np.asarray(R.qos_matrix_jnp(ri.as_jax()))
    ti = T.TorchInstance.from_pies(pi, "cpu")
    Qt = T.qos_matrix_torch(ti)
    assert Qt.dtype == torch.float32
    np.testing.assert_allclose(Qt.numpy(), Qj, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(T.eligibility_torch(ti).numpy(),
                                  np.asarray(R.eligibility_jnp(ri.as_jax())))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oms_and_sigma_torch_match_jnp(seed):
    ri, pi = _pair(seed=seed)
    ji = ri.as_jax()
    Q = np.array(R.qos_matrix_jnp(ji))                 # one Q for both
    elig = np.array(R.eligibility_jnp(ji))
    rng = np.random.default_rng(seed)
    x = rng.random((ri.E, ri.P)) < 0.4
    yj, qj = R.oms_jnp(jnp.asarray(Q), jnp.asarray(elig), ji.u_edge,
                       jnp.asarray(x))
    sj = float(R.sigma_jnp(jnp.asarray(Q), jnp.asarray(elig), ji.u_edge,
                           jnp.asarray(x)))
    ti = T.TorchInstance.from_pies(pi, "cpu")
    args = (torch.from_numpy(Q), torch.from_numpy(elig), ti.u_edge,
            torch.from_numpy(x))
    yt, qt = T.oms_torch(*args)
    st = float(T.sigma_torch(*args))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert (yt.numpy() == -1).any() and (yt.numpy() >= 0).any()
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-6)
    np.testing.assert_allclose(st, sj, rtol=1e-6)


def _tied_pair(seed):
    """An instance whose implementations of a service often share identical
    attributes, so their QoS ties exactly."""
    ri, _ = _pair(seed=seed, n_users=200, n_edges=3)
    rng = np.random.default_rng(100 + seed)
    P = ri.P
    ri.sm_acc = np.round(ri.sm_acc, 1)
    ri.sm_k = rng.choice([15.0, 20.0], P)
    ri.sm_w = rng.choice([15.0, 20.0], P)
    pi = T.PIESInstance(**{f.name: getattr(ri, f.name)
                           for f in dataclasses.fields(T.PIESInstance)})
    return ri, pi


@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_candidates_torch_matches_jnp_with_ties(k, seed):
    ri, pi = _tied_pair(seed)
    table = R.impl_table_np(ri.sm_service, ri.S)
    ij, qj = R.topk_candidates_jnp(ri.as_jax(), table, k)
    ti = T.TorchInstance.from_pies(pi, "cpu")
    it, qt = T.topk_candidates_torch(ti, T.impl_table_np(pi.sm_service,
                                                         pi.S), k)
    assert it.dtype == torch.int32 and qt.dtype == torch.float32
    q = np.asarray(qj)
    # the case really has ties among a user's kept candidates
    assert any(len(set(r[r > 0].tolist())) < (r > 0).sum() for r in q)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(qt.numpy(), q, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["unserved_service", "one_user",
                                  "uploaded_table"])
@pytest.mark.parametrize("k", [None, 3])
def test_topk_candidates_torch_instance_edges_match_jnp(case, k):
    """The instance-level build at its edges against the reference: users of
    a service with no implementation (its table row all −1), a one-user
    instance, and a table already uploaded as an int32 tensor (used as it
    is) giving what the host table gives."""
    if case == "one_user":
        ri, pi = _pair(seed=4, n_users=1, n_edges=1)
    else:
        ri, pi = _pair(seed=3, n_users=120, n_edges=3)
    n_services = ri.S
    if case == "unserved_service":
        n_services = ri.S + 1                        # row S: no model
        for inst in (ri, pi):
            inst.u_service = inst.u_service.copy()
            inst.u_service[::7] = ri.S
    table = R.impl_table_np(ri.sm_service, n_services)
    assert (table[-1] == -1).any()                   # −1 padded rows
    ij, qj = R.topk_candidates_jnp(ri.as_jax(), table, k)
    ti = T.TorchInstance.from_pies(pi, "cpu")
    host_table = T.impl_table_np(pi.sm_service, n_services)
    it, qt = T.topk_candidates_torch(ti, host_table, k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-6,
                               rtol=1e-6)
    if case == "unserved_service":
        none = pi.u_service == ri.S
        assert (it.numpy()[none] == -1).all() and not qt.numpy()[none].any()
    if case == "uploaded_table":
        up = torch.from_numpy(host_table.astype(np.int32))
        iu, qu = T.topk_candidates_torch(ti, up, k)
        assert torch.equal(iu, it) and torch.equal(qu, qt)
