"""The port's MoE layer and MoE family (repro_torch.models) against the JAX
reference on the CPU: the capacity rule, the single-device MoE block
(``_moe_local`` / ``moe_block`` with ``ctx=None``) on the mixtral-8x7b and
qwen3-moe-235b smoke configs, exact router ties (the lower expert first,
as ``lax.top_k`` orders them), capacity overflow under a skewed router
(the same assignments dropped), and the whole model's forward, prefill and
decode logits and ``ModelServer.generate`` tokens.

Weights come from the reference's ``init_moe`` / ``init_params`` and are
converted with ``repro_torch.convert.model_params_from_jax``; inputs from a
NumPy seed. Tolerances: 1e-5 for the float32 block (the two frameworks sum
the router and expert products in different orders), 1e-4 for float32
model logits, 3e-2 in bfloat16 (the port's model tolerances); tokens
exact."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ModelServer as JaxModelServer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import ModelServer  # noqa: E402

ARCHS = ["mixtral_8x7b", "qwen3_moe_235b"]
BLOCK_TOL = 1e-5
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _forward_only():
    """The port's parameters are trainable; these tests compare forward
    values, so they run without autograd, as serving does."""
    with torch.no_grad():
        yield


def _cfgs(arch, dtype="float32", **over):
    kw = dict(dtype=dtype, remat=False, **over)
    return jax_smoke(arch).with_(**kw), get_smoke_config(arch).with_(**kw)


def _moe_pair(jcfg, seed=0, router=None):
    """The reference's ``init_moe`` tree (router replaced by ``router`` if
    given) and the port's :class:`~repro_torch.models.layers.MoE` of the
    same numbers."""
    p = JL.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if router is not None:
        p = dict(p, router=jnp.asarray(router))
    return p, TL.MoE(*(torch.from_numpy(np.array(p[n])) for n in
                       ("router", "w_gate", "w_up", "w_down")))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _kept_by_rule(idx: np.ndarray, n_experts: int, capacity: int
                  ) -> np.ndarray:
    """The reference's drop rule written out: each expert keeps its first
    ``capacity`` assignments in (token, slot) order."""
    seen = np.zeros(n_experts, int)
    kept = np.zeros(idx.shape, bool)
    for t in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            e = idx[t, j]
            kept[t, j] = seen[e] < capacity
            seen[e] += 1
    return kept


# ===========================================================================
# the layer
# ===========================================================================

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_tokens", [1, 8, 128, 129, 200, 4096])
def test_capacity_matches_reference(arch, n_tokens):
    jcfg, tcfg = _cfgs(arch)
    assert TL.moe_capacity(n_tokens, tcfg) == JL._moe_capacity(n_tokens,
                                                               jcfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 6), (2, 100), (1, 300)],
                         ids=["lossless", "capacity", "overflow"])
def test_moe_block_matches_reference(arch, shape):
    """``moe_block`` (and ``moe_local`` under it) against the reference's
    ``moe_block(ctx=None)``: lossless decode capacity (T·k ≤ 256) and the
    capacity-factor rule above it."""
    jcfg, tcfg = _cfgs(arch)
    p, moe = _moe_pair(jcfg)
    x = np.random.default_rng(1).normal(
        size=shape + (jcfg.d_model,)).astype(np.float32)
    ref = JL.moe_block(p, jcfg, jnp.asarray(x), ctx=None)
    _close(TL.moe_block(moe, tcfg, torch.from_numpy(x)), ref, BLOCK_TOL)
    T = shape[0] * shape[1]
    cap = JL._moe_capacity(T, jcfg)
    ref_local = JL._moe_local(jnp.asarray(x.reshape(T, -1)), p["w_gate"],
                              p["w_up"], p["w_down"], p["router"], jcfg, 0,
                              jcfg.n_experts, cap)
    _close(TL.moe_local(torch.from_numpy(x.reshape(T, -1)), moe, tcfg, cap),
           ref_local, BLOCK_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bf16_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    p, moe = _moe_pair(jcfg, seed=2)
    x = np.random.default_rng(3).normal(size=(2, 40, jcfg.d_model))
    ref = JL.moe_block(p, jcfg, jnp.asarray(x, jnp.bfloat16), ctx=None)
    got = TL.moe_block(moe, tcfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, ref, TOL["bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_pick_the_lower_expert(arch):
    """A router whose columns repeat gives exactly tied probabilities:
    ``lax.top_k`` puts the lower expert first, and so does the port's
    stable sort; the outputs agree."""
    jcfg, tcfg = _cfgs(arch)
    E = jcfg.n_experts
    rng = np.random.default_rng(4)
    router = rng.normal(size=(jcfg.d_model, E)).astype(np.float32) * 0.05
    router[:, E - 1] = router[:, 0]            # expert E-1 ties expert 0
    router[:, 2] = router[:, 1]                # expert 2 ties expert 1
    p, moe = _moe_pair(jcfg, router=router)
    T = 24
    x = rng.normal(size=(T, jcfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, want = jax.lax.top_k(probs, jcfg.top_k)
    r = TL.moe_route(torch.from_numpy(x), moe.router, tcfg, 10 ** 6)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(want))
    # every token holds a tie; where both tied experts are chosen the
    # lower comes first
    for t in range(T):
        row = list(r.idx[t].numpy())
        for lo, hi in ((0, E - 1), (1, 2)):
            if lo in row and hi in row:
                assert row.index(lo) < row.index(hi)
    assert any(0 in row and E - 1 in row for row in r.idx.numpy().tolist()) \
        or any(1 in row and 2 in row for row in r.idx.numpy().tolist())
    cap = JL._moe_capacity(T, jcfg)
    ref = JL._moe_local(jnp.asarray(x), p["w_gate"], p["w_up"], p["w_down"],
                        p["router"], jcfg, 0, E, cap)
    _close(TL.moe_local(torch.from_numpy(x), moe, tcfg, cap), ref,
           BLOCK_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_overflow_drops_the_reference_tokens(arch):
    """T·k > 256 with a router skewed towards expert 0: most assignments
    overflow its capacity. The port keeps each expert's first ``capacity``
    assignments in token order (the reference's stable-sort rule), and its
    output matches the reference's, which a different dropped set would
    move."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(5)
    T, D = 200, jcfg.d_model
    x = rng.normal(size=(T, D)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 2.0
    router = rng.normal(size=(D, jcfg.n_experts)).astype(np.float32) * 0.05
    router[0, 0] = 4.0                          # expert 0 wins everywhere
    p, moe = _moe_pair(jcfg, router=router)
    cap = JL._moe_capacity(T, jcfg)
    assert T * jcfg.top_k > 256 and cap < T
    r = TL.moe_route(torch.from_numpy(x), moe.router, tcfg, cap)
    kept = _kept_by_rule(r.idx.numpy(), jcfg.n_experts, cap)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    assert (~kept).sum() > 0 and (r.idx.numpy()[:, 0] == 0).all()
    dropped_tokens = np.nonzero(~kept[:, 0])[0]
    assert dropped_tokens.min() == cap         # expert 0 keeps tokens < cap
    ref = JL._moe_local(jnp.asarray(x), p["w_gate"], p["w_up"], p["w_down"],
                        p["router"], jcfg, 0, jcfg.n_experts, cap)
    got = TL.moe_local(torch.from_numpy(x), moe, tcfg, cap)
    _close(got, ref, BLOCK_TOL)
    # a token dropped from every expert gets exactly zero
    all_dropped = ~kept.any(axis=1)
    assert np.all(got.numpy()[all_dropped] == 0)


# ===========================================================================
# the MoE family: forward, prefill, decode, generate
# ===========================================================================

@pytest.fixture(scope="module", params=ARCHS)
def moe_models(request):
    """One reference parameter tree per arch, shared by the model tests,
    and the port's model of the same numbers (float32)."""
    jcfg, tcfg = _cfgs(request.param)
    params = JT.init_params(jcfg, jax.random.PRNGKey(7))
    model = model_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, model


def test_moe_forward_matches_reference(moe_models):
    jcfg, tcfg, params, model = moe_models
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 40))
    ref = JT.forward(params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = TT.forward(model, tcfg, torch.from_numpy(toks))
    _close(got, ref, TOL["float32"])
    _close(TT.logits_fn(model, tcfg, got),
           JT.logits_fn(params, jcfg, ref, None), TOL["float32"])


def test_moe_prefill_and_decode_match_reference(moe_models):
    """Prefill 20 tokens into a 32-slot cache (mixtral's smoke window of 16
    makes it a ring), then 6 decode steps fed the same tokens."""
    jcfg, tcfg, params, model = moe_models
    B, S, Sc = 2, 20, 32
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (B, S + 6))
    jcache, jring = JT.init_cache(jcfg, B, Sc)
    tcache, tring = TT.init_cache(tcfg, B, Sc, "cpu")
    assert jring == tring
    ref, jcache = JT.prefill(params, jcfg,
                             {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                             jcache, jring)
    got, tcache = TT.prefill(model, tcfg, torch.from_numpy(toks[:, :S]),
                             tcache, tring)
    _close(got, ref, TOL["float32"])
    for t in range(S, S + 6):
        ref, jcache = JT.decode_step(params, jcfg,
                                     jnp.asarray(toks[:, t], jnp.int32),
                                     jcache, jring)
        got, tcache = TT.decode_step(model, tcfg,
                                     torch.from_numpy(toks[:, t]), tcache,
                                     tring)
        _close(got, ref, TOL["float32"])


def test_moe_generate_gives_the_reference_tokens(moe_models):
    jcfg, tcfg, params, model = moe_models
    ref = JaxModelServer(jcfg, params, bucket_batch=4, bucket_seq=48)
    port = ModelServer(tcfg, model, bucket_batch=4, bucket_seq=48,
                       device="cpu")
    prompts = np.random.default_rng(10).integers(0, tcfg.vocab_size, (3, 24))
    want, _, _ = ref.generate(prompts.astype(np.int32), n_steps=10)
    got, _, _ = port.generate(prompts, n_steps=10)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_prefill_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    params = JT.init_params(jcfg, jax.random.PRNGKey(11))
    model = model_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 16))
    jcache, ring = JT.init_cache(jcfg, 2, 32)
    tcache, _ = TT.init_cache(tcfg, 2, 32, "cpu")
    ref, _ = JT.prefill(params, jcfg,
                        {"tokens": jnp.asarray(toks, jnp.int32)}, jcache,
                        ring)
    got, _ = TT.prefill(model, tcfg, torch.from_numpy(toks), tcache, ring)
    _close(got, ref, TOL["bfloat16"])
