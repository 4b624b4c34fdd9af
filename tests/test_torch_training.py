"""The port's training path (repro_torch.training, .data, .launch.train and
the loss in models.transformer) against the JAX reference on the CPU: the
token pipeline byte for byte, AdamW and its schedule on the same trees,
the loss and every gradient of one step on the smollm and ring smoke
configs with the reference's parameters converted, one whole step, gradient
accumulation, falling loss, and a bitwise resume from a checkpoint.

Tolerances: the optimizer 1e-6 (the same float32 operations in the same
order); the loss and each gradient leaf 1e-4 of the leaf's largest value
(float32 compute, as the port's models hold their logits); parameters after
a step 2e-3, the reference's own (tests/test_integration.py: Adam at step
1 magnifies float32 noise, v ≈ 0)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import RequestPipeline, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.train import run_training
from repro_torch.models import transformer as TT
from repro_torch.training import (AdamWConfig, AdamWState, adamw_init,
                                  adamw_update, init_train_state,
                                  lr_schedule, make_grad_and_apply,
                                  make_train_step, param_tree)

OPT_TOL, GRAD_TOL, STEP_TOL = 1e-6, 1e-4, 2e-3
RING = dict(block_pattern=("swa",), window=16)


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _batch(cfg, B, S, seed, step=0):
    return {k: torch.from_numpy(v) for k, v in
            TokenPipeline(cfg, global_batch=B, seq_len=S, seed=seed)
            .batch_at(step).items()}


def _state(cfg, seed=0, **opt):
    opt_cfg = AdamWConfig(**{"lr": 1e-3, "warmup_steps": 1,
                             "total_steps": 10, **opt})
    return init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(
        seed)), opt_cfg


# ===========================================================================
# data
# ===========================================================================

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 17), (11, 2)])
def test_token_pipeline_matches_jax(jax, seed, step):
    from repro.configs import get_smoke_config as jsmoke
    from repro.data import TokenPipeline as JPipe

    jcfg = jsmoke("smollm_360m")
    ref = JPipe(jcfg, global_batch=8, seq_len=48, seed=seed)
    port = TokenPipeline(get_smoke_config("smollm_360m"), global_batch=8,
                         seq_len=48, seed=seed)
    a, b = ref.batch_at(step), port.batch_at(step)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for n in (2, 4):
        for r in range(n):
            sa, sb = ref.shard(a, r, n), port.shard(b, r, n)
            assert all(np.array_equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("tick", [0, 9])
def test_request_pipeline_matches_jax(jax, tick):
    from repro.data import RequestPipeline as JReq

    kw = dict(n_users=50, n_services=7, seq_len=12, seed=4)
    a, b = JReq(**kw).requests_at(tick), RequestPipeline(**kw).requests_at(
        tick)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ===========================================================================
# optimizer
# ===========================================================================

def _tree(rng):
    shapes = {"w0": (3, 4), "w1": (5,), "w2": (2, 3, 2), "w3": ()}
    return {n: np.asarray(rng.normal(size=s), np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
def test_adamw_update_matches_jax(jax, state_dtype, grad_scale):
    from repro.training import optimizer as JO

    jnp = jax.numpy
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6,
              state_dtype=state_dtype)
    jcfg, tcfg = JO.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    js, ts = JO.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for _ in range(4):
        g = {n: np.asarray(rng.normal(size=a.shape) * grad_scale,
                           np.float32) for n, a in params.items()}
        jp, js, jm = JO.adamw_update({n: jnp.asarray(a) for n, a in
                                      g.items()}, js, jp, jcfg)
        tp, ts, tm = adamw_update({n: torch.from_numpy(a) for n, a in
                                   g.items()}, ts, tp, tcfg)
        assert int(ts.step) == int(js.step)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       atol=OPT_TOL, rtol=OPT_TOL)
            for port, ref in ((ts.m, js.m), (ts.v, js.v)):
                assert str(port[n].dtype) == f"torch.{state_dtype}"
                np.testing.assert_allclose(
                    port[n].float().numpy(), np.asarray(ref[n], np.float32),
                    atol=OPT_TOL, rtol=OPT_TOL)


def test_lr_schedule_matches_jax(jax):
    from repro.training import optimizer as JO

    for kw in (dict(warmup_steps=3, total_steps=20), dict(warmup_steps=0,
                                                          total_steps=5)):
        for s in range(0, 25):
            ref = JO.lr_schedule(JO.AdamWConfig(**kw), jax.numpy.int32(s))
            port = lr_schedule(AdamWConfig(**kw),
                               torch.tensor(s, dtype=torch.int32))
            assert port.dtype == torch.float32
            np.testing.assert_allclose(float(port), float(ref),
                                       rtol=OPT_TOL, atol=1e-9)


# ===========================================================================
# loss and gradients against the reference
# ===========================================================================

def _ref_setup(jax, over):
    """The same f32-compute smoke config in both packages, the reference's
    parameters and AdamW state, and one pipeline batch."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.training import AdamWConfig as JAdamW
    from repro.training import init_train_state as jinit

    jcfg = jsmoke("smollm_360m").with_(dtype="float32", **over)
    tcfg = get_smoke_config("smollm_360m").with_(dtype="float32", **over)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstate = jinit(jcfg, JAdamW(**kw), jax.random.PRNGKey(0))
    return jcfg, tcfg, kw, jstate, _batch(tcfg, 4, 32, seed=1)


def _np_tree(jax, tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("over", [{}, RING], ids=["smollm", "ring"])
def test_loss_and_gradients_match_jax(jax, over):
    from repro.models import transformer as JT

    from repro_torch.convert import model_params_from_jax

    jcfg, tcfg, _, jstate, batch = _ref_setup(jax, over)
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(JT.loss_fn)(jstate.params, jcfg, jb)
    model = model_params_from_jax(tcfg, _np_tree(jax, jstate.params))
    port = TT.loss_fn(model, tcfg, batch)
    port.backward()
    np.testing.assert_allclose(float(port.detach()), float(loss),
                               rtol=GRAD_TOL)
    ref = {n: g.detach() for n, g in param_tree(
        model_params_from_jax(tcfg, _np_tree(jax, grads))).items()}
    for name, p in model.named_parameters():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("over", [{}, RING], ids=["smollm", "ring"])
def test_train_step_matches_jax(jax, over):
    from repro.training import AdamWConfig as JAdamW
    from repro.training import make_train_step as jmake

    from repro_torch.convert import train_state_from_jax

    jcfg, tcfg, kw, jstate, batch = _ref_setup(jax, over)
    state = train_state_from_jax(tcfg, _np_tree(jax, jstate))
    assert int(state.opt.step) == 0
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    jnew, jm = jax.jit(jmake(jcfg, JAdamW(**kw)))(jstate, jb)
    state, m = make_train_step(tcfg, AdamWConfig(**kw))(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=GRAD_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_TOL)
    ref = train_state_from_jax(tcfg, _np_tree(jax, jnew))
    assert int(state.opt.step) == int(ref.opt.step) == 1
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   param_tree(ref.params)[name]
                                   .detach().numpy(), atol=STEP_TOL)
        mscale = float(ref.opt.m[name].abs().max())
        assert float((state.opt.m[name] - ref.opt.m[name]).abs().max()) \
            <= GRAD_TOL * mscale, name


def test_grad_accumulation_equivalence():
    """grad_accum=2 matches grad_accum=1 on the same global batch."""
    cfg = get_smoke_config("smollm_360m")
    s1, opt = _state(cfg)
    s2, _ = _state(cfg)
    batch = _batch(cfg, 8, 32, seed=0)
    s1, m1 = make_train_step(cfg, opt, grad_accum=1)(s1, batch)
    s2, m2 = make_train_step(cfg, opt, grad_accum=2)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for (n, a), b in zip(s1.params.named_parameters(),
                         s2.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=STEP_TOL, err_msg=n)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt, grad_accum=3)(s1, batch)


def test_grad_and_apply_is_the_step_in_two():
    cfg = get_smoke_config("smollm_360m")
    s1, opt = _state(cfg)
    s2, _ = _state(cfg)
    batch = _batch(cfg, 4, 16, seed=2)
    s1, m1 = make_train_step(cfg, opt)(s1, batch)
    grad_fn, apply_fn = make_grad_and_apply(cfg, opt)
    loss, grads = grad_fn(s2.params, batch)
    s2, m2 = apply_fn(grads, s2)
    assert float(loss) == float(m1["loss"])
    for a, b in zip(s1.params.parameters(), s2.params.parameters()):
        assert torch.equal(a, b)


def test_grad_transform_hook_sees_the_gradients():
    cfg = get_smoke_config("smollm_360m")
    state, opt = _state(cfg)
    before = {n: p.detach().clone() for n, p in
              state.params.named_parameters()}
    seen = []

    def zero(grads):
        seen.append(sorted(grads))
        return {n: torch.zeros_like(g) for n, g in grads.items()}

    state, m = make_train_step(cfg, opt, grad_transform=zero)(
        state, _batch(cfg, 2, 16, seed=0))
    assert seen == [sorted(before)]
    assert float(m["grad_norm"]) == 0.0
    lr = float(m["lr"])
    for n, p in state.params.named_parameters():   # decay only
        torch.testing.assert_close(p.detach(), before[n] * (1 - lr * 0.1),
                                   atol=1e-7, rtol=1e-6)


# ===========================================================================
# model pieces of the training path
# ===========================================================================

def test_every_parameter_gets_a_gradient_through_attention():
    """Under grad the attention dispatcher keeps the graph (through the
    autograd Function), so wq/wk/wv — and every other leaf — get a
    nonzero gradient."""
    cfg = get_smoke_config("smollm_360m").with_(dtype="float32")
    model = TT.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg, 2, 24, seed=0)
    seen = []
    orig = fa.FlashAttention.apply

    def spy(*args):
        out = orig(*args)
        seen.append(type(out.grad_fn).__name__)
        return out

    fa.FlashAttention.apply = spy
    try:
        TT.loss_fn(model, cfg, batch).backward()
    finally:
        fa.FlashAttention.apply = orig
    # each layer's forward, then its recompute under remat
    assert cfg.remat and seen == ["FlashAttentionBackward"] * 2 * cfg.n_layers
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.any()), name


def test_remat_gives_the_same_gradients():
    cfg = get_smoke_config("smollm_360m").with_(dtype="float32")
    batch = _batch(cfg, 2, 24, seed=1)
    grads = []
    for remat in (False, True):
        model = TT.init_params(cfg, torch.Generator().manual_seed(0))
        TT.loss_fn(model, cfg.with_(remat=remat), batch).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="save_attn"):
        TT.loss_fn(model, cfg.with_(remat_policy="save_attn"), batch)


def test_chunked_xent_matches_jax_and_full_logits(jax):
    """Above 16,384 vocabulary slots the loss runs chunk by chunk over the
    sequence (each chunk recomputed in the backward)."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import transformer as JT

    from repro_torch.convert import model_params_from_jax

    over = dict(vocab_size=16400, n_layers=1, dtype="float32")
    jcfg = jsmoke("smollm_360m").with_(**over)
    tcfg = get_smoke_config("smollm_360m").with_(**over)
    assert tcfg.vocab_pad > 16384
    params = JT.init_params(jcfg, jax.random.PRNGKey(2))
    model = model_params_from_jax(tcfg, _np_tree(jax, params))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, tcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    ref = JT.softmax_xent(params, jcfg, jax.numpy.asarray(x),
                          jax.numpy.asarray(tgt), jax.numpy.asarray(mask),
                          None, chunk=16)
    xt = torch.from_numpy(x).requires_grad_()
    args = (torch.from_numpy(tgt), torch.from_numpy(mask))
    chunked = TT.softmax_xent(model, tcfg, xt, *args, chunk=16)
    np.testing.assert_allclose(float(chunked.detach()), float(ref), rtol=1e-5)
    gx = torch.autograd.grad(chunked, xt)[0]
    full = TT._xent_from_logits(TT.logits_fn(model, tcfg, xt), *args)
    torch.testing.assert_close(chunked, full, rtol=1e-6, atol=0)
    torch.testing.assert_close(gx, torch.autograd.grad(full, xt)[0],
                               rtol=1e-5, atol=1e-9)


def test_padded_vocab_logits_stay_differentiable():
    cfg = get_smoke_config("smollm_360m").with_(vocab_size=509,
                                                dtype="float32")
    assert cfg.vocab_pad == 512
    model = TT.init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, cfg.d_model, requires_grad=True)
    logits = TT.logits_fn(model, cfg, x)
    assert bool((logits[..., 509:] < -1e29).all())
    logits[..., :509].sum().backward()
    assert model.head.grad[:, 509:].abs().max() == 0


# ===========================================================================
# run_training
# ===========================================================================

def test_training_loss_decreases():
    out = run_training(arch="smollm_360m", steps=25, global_batch=8,
                       seq_len=64, verbose=False, seed=3, device="cpu")
    losses = out["losses"]
    assert np.isfinite(losses).all() and len(out["step_s"]) == 25
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, \
        f"no learning: {losses[:3]} → {losses[-3:]}"


def test_checkpoint_resume_is_bitwise_identical(tmp_path):
    """Crash/restart: 14 straight steps == 7 steps + restart + 7 steps, on
    every parameter, Adam moment and the step."""
    kw = dict(arch="smollm_360m", global_batch=4, seq_len=32, verbose=False,
              seed=5, lr=1e-3, schedule_steps=14, device="cpu")
    ref = run_training(steps=14, **kw)
    d = tmp_path / "ckpt"
    run_training(steps=7, checkpoint_dir=str(d), ckpt_every=7, **kw)
    resumed = run_training(steps=14, checkpoint_dir=str(d), ckpt_every=7,
                           **kw)
    assert resumed["start_step"] == 7 and len(resumed["losses"]) == 7
    assert resumed["losses"] == ref["losses"][7:]
    a, b = ref["state"], resumed["state"]
    assert int(a.opt.step) == int(b.opt.step) == 14
    for (n, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), n
    for which in ("m", "v"):
        for n, t in getattr(a.opt, which).items():
            assert torch.equal(t, getattr(b.opt, which)[n]), (which, n)


def test_run_training_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(steps=1, verbose=False)


def test_train_cli_runs_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import train

    monkeypatch.setattr("sys.argv", ["train", "--steps", "2", "--seq-len",
                                     "16", "--global-batch", "2",
                                     "--device", "cpu"])
    train.main()
    assert "[train] done" in capsys.readouterr().out


def test_adamw_state_is_a_named_tuple_of_trees():
    cfg = get_smoke_config("smollm_360m")
    state, _ = _state(cfg)
    assert isinstance(state.opt, AdamWState)
    assert list(state.opt.m) == list(param_tree(state.params))
    assert state.opt.step.dtype == torch.int32


@pytest.mark.cuda
def test_training_on_the_card_matches_the_cpu():
    """Three float32 steps through B4/B5/B6 on the card against the same
    steps with the plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = get_smoke_config("smollm_360m").with_(dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for dev in ("cuda", "cpu"):
        state = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
        state = state._replace(params=state.params.to(dev), opt=AdamWState(
            *(x.to(dev) if isinstance(x, torch.Tensor)
              else {n: t.to(dev) for n, t in x.items()} for x in state.opt)))
        step = make_train_step(cfg, opt)
        n0 = fa.LAUNCHES["flash_attention_dkv"]
        losses = []
        for i in range(3):
            batch = {k: v.to(dev) for k, v in _batch(cfg, 4, 64, seed=0,
                                                     step=i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        launched = fa.LAUNCHES["flash_attention_dkv"] - n0
        runs[dev] = (losses, param_tree(state.params), launched)
    assert runs["cuda"][2] == 3 * cfg.n_layers and runs["cpu"][2] == 0
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                               rtol=GRAD_TOL)
    for n, p in runs["cpu"][1].items():
        np.testing.assert_allclose(runs["cuda"][1][n].detach().cpu().numpy(),
                                   p.detach().numpy(), atol=STEP_TOL,
                                   err_msg=n)
