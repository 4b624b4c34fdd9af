"""The port's placement algorithms and batched evaluation against the JAX
reference on the same instances: the host algorithms (AGP, SCK, RND, OPT
and the rest) output for output, the dense lock-step EGP/AGP against
``egp_place_jax``/``agp_place_jax``, padding and bucketing array for
array, ``evaluate_batch`` padded and bucketed, and the router's three
placement algorithms."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.workloads as RW
from repro.core.placement import sigma_upper_bound_np as jax_sigma_bound
from repro.workloads.batched import bucket_indices as jax_bucket_indices
from repro.workloads.batched import single_evaluator as jax_single_evaluator
import repro_torch.core as T
import repro_torch.workloads as TW
from repro.serving.router import Router as JaxRouter
from repro_torch.kernels.qos_matrix import ops
from repro_torch.serving import Router

#: The reference's batched-vs-host tolerance (tests/test_workloads.py).
BATCH_ATOL = 1e-4


def _pair(fn: str, *args, **kw):
    return getattr(R, fn)(*args, **kw), getattr(T, fn)(*args, **kw)


def _mix(sizes_seeds):
    """tests/test_workloads.py's mixed-size batches, from both packages."""
    return ([R.synthetic_instance(n_users=u, n_edges=max(2, u // 40), seed=s)
             for u, s in sizes_seeds],
            [T.synthetic_instance(n_users=u, n_edges=max(2, u // 40), seed=s)
             for u, s in sizes_seeds])


# ===========================================================================
# host algorithms (tests/test_placement.py's instances)
# ===========================================================================

@pytest.mark.parametrize("algo", ["egp", "agp", "sck", "rnd", "opt"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_place_and_schedule_identical(algo, seed):
    ri, pi = _pair("synthetic_instance", 50, n_edges=4, n_services=15,
                   seed=seed)
    xr, yr, vr = R.place_and_schedule(ri, algo, seed=seed)
    xt, yt, vt = T.place_and_schedule(pi, algo, seed=seed)
    np.testing.assert_array_equal(xt, xr)
    np.testing.assert_array_equal(yt, yr)
    assert vt == vr
    used = (xt * pi.sm_r[None, :]).sum(axis=1)
    assert np.all(used <= pi.R + 1e-9)


@pytest.mark.parametrize("seed", [0, 3])
def test_agp_sck_and_bound_identical(seed):
    ri, pi = _pair("synthetic_instance", 30, n_edges=3, n_services=8,
                   seed=seed)
    Q = R.qos_matrix_np(ri)
    np.testing.assert_array_equal(T.agp_np(pi, Q), R.agp_np(ri, Q))
    for res in (1, 2):
        np.testing.assert_array_equal(T.sck_np(pi, Q, resolution=res),
                                      R.sck_np(ri, Q, resolution=res))
    assert T.sigma_upper_bound_np(pi) == jax_sigma_bound(ri)
    assert T.sigma_upper_bound_np(pi) >= T.sigma_np(pi, T.opt_np(pi, Q), Q)


@pytest.mark.parametrize("seed", [0, 5])
def test_agp_literal_identical(seed):
    ri, pi = _pair("synthetic_instance", 16, n_edges=2, n_services=5,
                   max_impls=3, seed=seed)
    Q = R.qos_matrix_np(ri)
    x = T.agp_literal_np(pi, Q)
    np.testing.assert_array_equal(x, R.agp_literal_np(ri, Q))
    # the closed-form marginal makes the same picks up to ties
    np.testing.assert_allclose(T.sigma_np(pi, x, Q),
                               T.sigma_np(pi, T.agp_np(pi, Q), Q), atol=1e-9)


@pytest.mark.parametrize("seed", [0, 2, 7])
def test_rnd_draws_byte_identical(seed):
    ri, pi = _pair("synthetic_instance", 30, seed=2)
    xr, yr = R.rnd_np(ri, seed=seed)
    xt, yt = T.rnd_np(pi, seed=seed)
    assert xt.tobytes() == xr.tobytes() and yt.tobytes() == yr.tobytes()
    assert yt.dtype == yr.dtype
    Q = R.qos_matrix_np(ri)
    assert T.schedule_value_np(pi, yt, Q) == R.schedule_value_np(ri, yr, Q)
    assert T.schedule_value_np(pi, yt) == R.schedule_value_np(ri, yr)


@pytest.mark.parametrize("seed", [0, 1, 4, 9])
def test_opt_and_brute_force_identical(seed):
    ri, pi = _pair("tiny_instance", seed=seed, n_users=10, n_edges=2,
                   n_services=4, max_impls=3)
    Q = R.qos_matrix_np(ri)
    xb, vb = T.brute_force_np(pi, Q)
    xbr, vbr = R.brute_force_np(ri, Q)
    np.testing.assert_array_equal(xb, xbr)
    assert vb == vbr
    xo = T.opt_np(pi, Q)
    np.testing.assert_array_equal(xo, R.opt_np(ri, Q))
    np.testing.assert_allclose(T.sigma_np(pi, xo, Q), vb, atol=1e-9)
    for e in range(pi.E):
        xe, ve = T.opt_edge_np(pi, e, Q)
        xer, ver = R.opt_edge_np(ri, e, Q)
        np.testing.assert_array_equal(xe, xer)
        assert ve == ver


def test_opt_on_the_realworld_catalog_identical():
    ri, pi = _pair("realworld_instance", 120)
    Q = R.qos_matrix_np(ri)
    np.testing.assert_array_equal(T.opt_np(pi, Q), R.opt_np(ri, Q))


def test_place_and_schedule_rejects_unknown_algorithm():
    with pytest.raises(ValueError, match="unknown algorithm"):
        T.place_and_schedule(T.tiny_instance(), "greedy")


# ===========================================================================
# dense EGP / AGP on the device path (tests/test_placement.py's instances)
# ===========================================================================

def _dense_args(ri, pi):
    ji = ri.as_jax()
    Qj, ej = R.qos_matrix_jnp(ji), R.eligibility_jnp(ji)
    ti = T.TorchInstance.from_pies(pi, "cpu")
    Qt = ops.qos_matrix_from_instance(ti)
    return ji, Qj, ej, ti, Qt, T.eligibility_torch(ti)


@pytest.mark.parametrize("max_iters", [512, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_egp_place_torch_matches_jax(seed, max_iters):
    ri, pi = _pair("synthetic_instance", 40, n_edges=3, n_services=10,
                   seed=seed)
    ji, Qj, ej, ti, Qt, et = _dense_args(ri, pi)
    xj = np.asarray(R.egp_place_jax(Qj, ej, ji.u_edge, ji.u_service,
                                    ji.sm_service, ji.sm_r, ji.R, ri.S,
                                    max_iters=max_iters))
    xt = T.egp_place_torch(Qt, et, ti.u_edge, ti.u_service, ti.sm_service,
                           ti.sm_r, ti.R, pi.S, max_iters=max_iters)
    assert xt.dtype == torch.bool and xt.shape == (pi.E, pi.P)
    np.testing.assert_array_equal(xt.numpy(), xj)
    if max_iters == 512:
        np.testing.assert_array_equal(xt.numpy(), T.egp_np(pi))
    else:
        assert int(xt.sum(dim=1).max()) <= max_iters


@pytest.mark.parametrize("max_iters", [256, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_agp_place_torch_matches_jax(seed, max_iters):
    ri, pi = _pair("synthetic_instance", 40, n_edges=3, n_services=10,
                   seed=seed)
    ji, Qj, ej, ti, Qt, et = _dense_args(ri, pi)
    xj = np.asarray(R.agp_place_jax(Qj, ej, ji.u_edge, ji.sm_r, ji.R,
                                    max_iters=max_iters))
    xt = T.agp_place_torch(Qt, et, ti.u_edge, ti.sm_r, ti.R,
                           max_iters=max_iters)
    np.testing.assert_array_equal(xt.numpy(), xj)
    if max_iters == 256:
        np.testing.assert_array_equal(xt.numpy(), T.agp_np(pi))


def test_dense_placement_on_the_realworld_catalog_matches_jax():
    ri, pi = _pair("realworld_instance", 200)
    ji, Qj, ej, ti, Qt, et = _dense_args(ri, pi)
    xj = np.asarray(R.egp_place_jax(Qj, ej, ji.u_edge, ji.u_service,
                                    ji.sm_service, ji.sm_r, ji.R, ri.S))
    xt = T.egp_place_torch(Qt, et, ti.u_edge, ti.u_service, ti.sm_service,
                           ti.sm_r, ti.R, pi.S)
    np.testing.assert_array_equal(xt.numpy(), xj)
    xj = np.asarray(R.agp_place_jax(Qj, ej, ji.u_edge, ji.sm_r, ji.R))
    xt = T.agp_place_torch(Qt, et, ti.u_edge, ti.sm_r, ti.R)
    np.testing.assert_array_equal(xt.numpy(), xj)


# ===========================================================================
# padding and bucketing
# ===========================================================================

_MIXES = [[(20, 0), (160, 1), (40, 2), (20, 3), (90, 4)], [(30, 7)],
          [(8, 1), (200, 2), (33, 5)]]


@pytest.mark.parametrize("sizes", _MIXES)
def test_pad_instances_identical(sizes):
    rs, ts = _mix(sizes)
    rb = RW.pad_instances(rs)
    tb = TW.pad_instances(ts, device="cpu")
    assert tb.n_services == rb.n_services and tb.dims == rb.dims
    assert tb.B == rb.B
    for f in dataclasses.fields(T.TorchInstance):
        a = getattr(tb.torch_instance, f.name).numpy()
        b = np.asarray(getattr(rb.jax_instance, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    # an explicit envelope, and one the instances do not fit
    big = TW.pad_instances(ts, 256, 1024, 9, device="cpu")
    rbig = RW.pad_instances(rs, 256, 1024, 9)
    np.testing.assert_array_equal(big.torch_instance.sm_r.numpy(),
                                  np.asarray(rbig.jax_instance.sm_r))
    with pytest.raises(ValueError, match="envelope"):
        TW.pad_instances(ts, 4, device="cpu")


@pytest.mark.parametrize("sizes", _MIXES)
def test_bucket_envelopes_indices_and_batches_identical(sizes):
    rs, ts = _mix(sizes)
    assert TW.bucket_indices(ts) == jax_bucket_indices(rs)
    for cap in (None, (4096, 1024, 16)):
        for i in ts:
            assert TW.bucket_envelope(i.U, i.P, i.E, cap) == \
                RW.bucket_envelope(i.U, i.P, i.E, cap)
    rb = RW.bucket_instances(rs)
    tb = TW.bucket_instances(ts, device="cpu")
    assert tb.envelopes == rb.envelopes and tb.dims == rb.dims
    assert [i.tolist() for i in tb.index] == [i.tolist() for i in rb.index]
    assert tb.pad_waste == rb.pad_waste and 0.0 <= tb.pad_waste < 1.0
    for t, r in zip(tb.buckets, rb.buckets):
        np.testing.assert_array_equal(t.torch_instance.u_service.numpy(),
                                      np.asarray(r.jax_instance.u_service))
        np.testing.assert_array_equal(t.torch_instance.u_share_k.numpy(),
                                      np.asarray(r.jax_instance.u_share_k))
    with pytest.raises(ValueError, match="cap"):
        TW.bucket_envelope(100, 10, 3, cap=(64, 16, 8))


# ===========================================================================
# evaluate_batch (tests/test_workloads.py's mixes and tolerance)
# ===========================================================================

@pytest.mark.parametrize("algo", ["egp", "agp"])
@pytest.mark.parametrize("sizes", _MIXES)
def test_evaluate_batch_padded_matches_jax_and_host(sizes, algo):
    rs, ts = _mix(sizes)
    vj, xj = RW.evaluate_batch(RW.pad_instances(rs), algo=algo)
    batch = TW.pad_instances(ts, device="cpu")
    vt, xt = TW.evaluate_batch(batch, algo=algo)
    assert vt.dtype == np.float64 and vt.shape == (len(ts),)
    assert xt.dtype == torch.bool
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    host = TW.evaluate_host(ts, algo=algo)
    np.testing.assert_allclose(vt, host, atol=BATCH_ATOL)
    np.testing.assert_allclose(host, RW.evaluate_host(rs, algo=algo),
                               atol=0)
    for b, inst in enumerate(ts):
        U, P, E = batch.dims[b]
        x = xt[b].numpy()
        assert not x[:, P:].any() and not x[E:, :].any()
        np.testing.assert_allclose(vt[b], T.sigma_np(inst, x[:E, :P]),
                                   atol=BATCH_ATOL)


@pytest.mark.parametrize("algo", ["egp", "agp"])
@pytest.mark.parametrize("sizes", _MIXES)
def test_evaluate_batch_bucketed_matches_jax_padded_and_host(sizes, algo):
    rs, ts = _mix(sizes)
    vj, xj = RW.evaluate_batch(RW.bucket_instances(rs), algo=algo)
    vt, xt = TW.evaluate_batch(TW.bucket_instances(ts, device="cpu"),
                               algo=algo)
    assert len(xt) == len(ts)
    for inst, a, b in zip(ts, xt, xj):
        env = TW.bucket_envelope(inst.U, inst.P, inst.E)
        assert tuple(a.shape) == (env[2], env[1])
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    vg, _ = TW.evaluate_batch(TW.pad_instances(ts, device="cpu"), algo=algo)
    np.testing.assert_allclose(vt, vg, atol=BATCH_ATOL)
    np.testing.assert_allclose(vt, TW.evaluate_host(ts, algo=algo),
                               atol=BATCH_ATOL)


def test_evaluate_batch_plain_flag_and_max_iters():
    _, ts = _mix(_MIXES[0])
    batch = TW.bucket_instances(ts, device="cpu")
    v0, x0 = TW.evaluate_batch(batch)
    v1, x1 = TW.evaluate_batch(batch, use_kernel=False)
    assert np.array_equal(v0, v1)
    assert all(torch.equal(a, b) for a, b in zip(x0, x1))
    # one lock-step iteration places at most one model per edge
    _, x2 = TW.evaluate_batch(batch, max_iters=1)
    assert max(int(x.sum(dim=1).max()) for x in x2) <= 1
    with pytest.raises(ValueError, match="algorithm"):
        TW.evaluate_batch(batch, algo="opt")


@pytest.mark.parametrize("algo", ["egp", "agp"])
def test_single_evaluator_matches_jax(algo):
    rs, ts = _mix([(60, 3)])
    ji = rs[0].as_jax()
    vj, xj = jax_single_evaluator(algo, rs[0].S, 512)(ji)
    ti = T.TorchInstance.from_pies(ts[0], "cpu")
    vt, xt = TW.single_evaluator(algo, ts[0].S, 512)(ti)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(float(vt), float(vj), atol=BATCH_ATOL)
    with pytest.raises(ValueError, match="algorithm"):
        TW.single_evaluator("rnd", 4, 8)


# ===========================================================================
# the router's placement algorithms
# ===========================================================================

@pytest.mark.parametrize("algo", ["egp", "agp", "opt"])
@pytest.mark.parametrize("seed", [0, 1])
def test_router_placement_algorithms_match_reference(algo, seed):
    ri, pi = _pair("synthetic_instance", 120, n_edges=3, seed=seed)
    jr = JaxRouter(placement_algo=algo, use_kernel=True)
    tr = Router(placement_algo=algo, device="cpu")
    xt = tr.place(pi)
    np.testing.assert_array_equal(xt, jr.place(ri))
    jd, td = jr.route(ri), tr.route(pi)
    np.testing.assert_array_equal(td.assignment, jd.assignment)
    np.testing.assert_allclose(td.value, jd.value, rtol=1e-5)
    Q = T.qos_matrix_np(pi)
    host = {"egp": T.egp_np, "agp": T.agp_np, "opt": T.opt_np}[algo](pi, Q)
    np.testing.assert_allclose(T.sigma_np(pi, xt, Q), T.sigma_np(pi, host, Q),
                               atol=1e-4)


def test_router_rejects_unknown_placement_algo():
    with pytest.raises(ValueError, match="placement_algo"):
        Router(placement_algo="sck", device="cpu")
