"""Training every attention family of the port against the JAX reference on
the CPU: gemma2 (alternating local/global attention with an attention
softcap, post-norms, logit softcap), command-r and yi (hd 16, G = 8 and
4), the MoE family (mixtral, qwen3-moe) and the frontends (hubert's audio
frames, internvl2's patches before its tokens), each on its smoke config
in float32 with the reference's parameters converted.

For each: the loss and every gradient leaf of ``loss_fn`` against
``jax.grad`` of the reference's ``repro.models.transformer.loss_fn``
within 1e-4 of the leaf's largest |value|, under both remat policies,
and one whole AdamW step (the reference's ``make_train_step``) within the
reference's step tolerance, 2e-3 (tests/test_integration.py: Adam at
step 1 magnifies float32 noise, v ≈ 0). The MoE models also run with a
capacity factor of 0.5 (every expert overflows, assignments are dropped)
and with router columns repeated in every layer (exact router ties, the
lower expert taken first, as ``lax.top_k`` orders them)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import AdamWConfig as JAdamW  # noqa: E402
from repro.training import make_train_step as jmake  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (model_params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import (AdamWConfig, make_train_step,  # noqa: E402
                                  param_tree)
from torch_recorders import recorders_off  # noqa: E402,F401  (autouse)

GRAD_TOL, STEP_TOL = 1e-4, 2e-3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

#: (case id, arch, config overrides, tie the router's columns): every
#: attention family's smoke config, and the MoE models with dropped
#: assignments and exact router ties.
CASES = [("gemma2", "gemma2_27b", {}, False),
         ("command_r", "command_r_35b", {}, False),
         ("yi", "yi_34b", {}, False),
         ("mixtral", "mixtral_8x7b", {}, False),
         ("qwen3_moe", "qwen3_moe_235b", {}, False),
         ("hubert", "hubert_xlarge", {}, False),
         ("internvl2", "internvl2_1b", {}, False),
         ("mixtral_drops_ties", "mixtral_8x7b",
          {"capacity_factor": 0.5}, True),
         ("qwen3_moe_drops_ties", "qwen3_moe_235b",
          {"capacity_factor": 0.5}, True)]
#: Batch rows and positions: 4 x 40 routes 160 tokens, so T·k = 320 > 256
#: and the MoE takes the capacity-factor rule; internvl2's 40 positions are
#: its 8 patches and 32 tokens.
B, S = 4, 40


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tied(params, n_experts: int):
    """The reference's parameters with every layer's router columns E-1
    and 2 repeating columns 0 and 1: their probabilities tie exactly."""
    moe = dict(params["layers"]["moe"])
    r = np.array(moe["router"])                  # [L, D, E]
    r[..., n_experts - 1] = r[..., 0]
    r[..., 2] = r[..., 1]
    moe["router"] = jax.numpy.asarray(r)
    return dict(params, layers=dict(params["layers"], moe=moe))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """Both packages' configs, the reference's train state, and one
    pipeline batch (the two pipelines are byte-identical)."""
    from repro.training import init_train_state as jinit

    _, arch, over, tie = request.param
    kw = dict(dtype="float32", remat=True, **over)
    jcfg, tcfg = jax_smoke(arch).with_(**kw), get_smoke_config(arch).with_(
        **kw)
    jstate = jinit(jcfg, JAdamW(**OPT), jax.random.PRNGKey(0))
    if tie:
        jstate = jstate._replace(params=_tied(jstate.params,
                                              jcfg.n_experts))
    batch = TokenPipeline(tcfg, global_batch=B, seq_len=S, seed=1
                          ).batch_at(0)
    return jcfg, tcfg, jstate, batch, tie


def _routes(tcfg, fn):
    """Run ``fn`` with ``moe_local``'s router spied on: every call's
    routing and router probabilities."""
    seen, orig = [], TL.moe_route

    def spy(x, router, cfg, capacity):
        r = orig(x, router, cfg, capacity)
        with torch.no_grad():       # records nothing a recompute must match
            seen.append((r, torch.softmax(x.float() @ router.float(), -1)))
        return r

    TL.moe_route = spy
    try:
        fn()
    finally:
        TL.moe_route = orig
    return seen


@pytest.mark.parametrize("policy", ["nothing", "save_attn"])
def test_loss_and_gradients_match_jax(case, policy):
    jcfg, tcfg, jstate, batch, tie = case
    jcfg, tcfg = (c.with_(remat_policy=policy) for c in (jcfg, tcfg))
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(JT.loss_fn)(jstate.params, jcfg, jb)
    model = model_params_from_jax(tcfg, _np_tree(jstate.params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = []
    routes = _routes(tcfg, lambda: port.append(TT.loss_fn(model, tcfg, tb)))
    port[0].backward()
    np.testing.assert_allclose(float(port[0].detach()), float(loss),
                               rtol=GRAD_TOL)
    ref = {n: g.detach() for n, g in param_tree(
        model_params_from_jax(tcfg, _np_tree(grads))).items()}
    for name, p in model.named_parameters():
        if not bool(ref[name].any()):
            # hubert embeds frames: its token table gets no gradient
            assert name == "tok" and tcfg.frontend == "audio", name
            assert p.grad is None, name
            continue
        assert p.grad is not None and bool(p.grad.any()), name
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
    if tcfg.n_experts:
        # capacity rule in force; drops and exact ties where asked for
        assert B * S * tcfg.top_k > 256
        kept = torch.cat([r.kept.reshape(-1) for r, _ in routes])
        assert bool((~kept).any()) == (tcfg.capacity_factor < 1)
        E = tcfg.n_experts
        for _, probs in routes:
            tied = torch.equal(probs[:, 0], probs[:, E - 1]) \
                and torch.equal(probs[:, 1], probs[:, 2])
            assert tied == tie


def test_train_step_matches_jax(case):
    jcfg, tcfg, jstate, batch, _ = case
    state = train_state_from_jax(tcfg, _np_tree(jstate))
    jnew, jm = jax.jit(jmake(jcfg, JAdamW(**OPT)))(
        jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    state, m = make_train_step(tcfg, AdamWConfig(**OPT))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=GRAD_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_TOL)
    ref = train_state_from_jax(tcfg, _np_tree(jnew))
    assert int(state.opt.step) == int(ref.opt.step) == 1
    want = param_tree(ref.params)
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(),
                                   atol=STEP_TOL, err_msg=name)
        mscale = float(ref.opt.m[name].abs().max())
        assert float((state.opt.m[name] - ref.opt.m[name]).abs().max()) \
            <= GRAD_TOL * mscale, name
