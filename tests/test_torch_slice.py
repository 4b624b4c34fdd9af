"""The port's main path as a whole against the JAX reference on the same
instances: sparse EGP placement + σ (evaluate_sparse), the host oracle
(evaluate_host), and the OMS router (place/route)."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.serving.router import Router as JaxRouter
from repro.sweeps.shard import HOST_PARITY_ATOL
from repro.workloads import evaluate_host as jax_evaluate_host
from repro.workloads import evaluate_sparse as jax_evaluate_sparse
from repro_torch.serving import Router
from repro_torch.workloads import evaluate_host, evaluate_sparse


def _check_against_reference(ri, pi, k=None):
    jv, jx = jax_evaluate_sparse([ri], k=k)
    tv, tx = evaluate_sparse([pi], k=k, device="cpu")
    x = tx[0].numpy()
    assert x.dtype == bool and x.shape == (pi.E, pi.P)
    np.testing.assert_array_equal(x, np.asarray(jx[0]))
    np.testing.assert_allclose(tv, np.asarray(jv), atol=HOST_PARITY_ATOL)
    used = (x * pi.sm_r[None, :]).sum(axis=1)
    assert np.all(used <= pi.R + 1e-5)                 # storage feasible
    return tv, x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_sparse_matches_jax_and_host(seed):
    ri = R.synthetic_instance(400, n_edges=5, seed=seed)
    pi = T.synthetic_instance(400, n_edges=5, seed=seed)
    tv, x = _check_against_reference(ri, pi)
    host = evaluate_host([pi])
    np.testing.assert_allclose(tv, host, atol=HOST_PARITY_ATOL)
    np.testing.assert_allclose(host, jax_evaluate_host([ri]), atol=0)
    # σ recomputed on the port's placement by the host oracle agrees
    np.testing.assert_allclose(float(tv[0]), T.sigma_np(pi, x),
                               atol=HOST_PARITY_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_sparse_topk_matches_jax(seed):
    ri = R.synthetic_instance(400, n_edges=5, seed=seed)
    pi = T.synthetic_instance(400, n_edges=5, seed=seed)
    tv, _ = _check_against_reference(ri, pi, k=4)
    # k < M is a lower bound on the exact path
    assert tv[0] <= evaluate_host([pi])[0] + HOST_PARITY_ATOL


def test_evaluate_sparse_realworld_matches_jax_and_host():
    ri, pi = R.realworld_instance(300), T.realworld_instance(300)
    tv, _ = _check_against_reference(ri, pi)
    np.testing.assert_allclose(tv, evaluate_host([pi]),
                               atol=HOST_PARITY_ATOL)


def test_evaluate_sparse_plain_flag_and_max_iters():
    pi = T.synthetic_instance(120, n_edges=3, seed=7)
    v0, x0 = evaluate_sparse([pi], device="cpu")
    v1, x1 = evaluate_sparse([pi], device="cpu", use_kernel=False)
    assert v0[0] == v1[0] and bool((x0[0] == x1[0]).all())
    # one lock-step iteration places at most one model per edge
    _, x2 = evaluate_sparse([pi], device="cpu", max_iters=1)
    assert int(x2[0].sum(dim=1).max()) <= 1 < int(x0[0].sum(dim=1).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_router_place_and_route_match_reference(seed):
    ri = R.synthetic_instance(400, n_edges=5, seed=seed)
    pi = T.synthetic_instance(400, n_edges=5, seed=seed)
    # the reference router over its float32 QoS kernel path
    jr = JaxRouter(use_kernel=True)
    tr = Router(device="cpu")
    np.testing.assert_array_equal(tr.place(pi), jr.place(ri))
    jd, td = jr.route(ri), tr.route(pi)
    np.testing.assert_array_equal(td.assignment, jd.assignment)
    np.testing.assert_allclose(td.value, jd.value, rtol=1e-5)
    np.testing.assert_allclose(td.expected_qos, jd.expected_qos, atol=1e-6)
    np.testing.assert_array_equal(td.placement, jd.placement)
    # routing an explicit placement (the sparse path's) gives its σ
    _, xs = evaluate_sparse([pi], device="cpu")
    d = tr.route(pi, placement=xs[0])
    np.testing.assert_allclose(d.value, T.sigma_np(pi, xs[0].numpy()),
                               rtol=1e-5)


def test_router_edge_failure_matches_reference():
    ri = R.synthetic_instance(200, n_edges=4, seed=3)
    pi = T.synthetic_instance(200, n_edges=4, seed=3)
    jnew, jx = JaxRouter(use_kernel=True).handle_edge_failure(ri, [1])
    tnew, tx = Router(device="cpu").handle_edge_failure(pi, [1])
    np.testing.assert_array_equal(tnew.u_edge, jnew.u_edge)
    np.testing.assert_array_equal(tx, jx)
    assert not tx[1].any()
