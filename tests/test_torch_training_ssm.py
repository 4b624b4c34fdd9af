"""Training the Mamba2 (ssm) and Zamba2 (hybrid) families with the port on
the CPU, against the JAX reference: the loss and every gradient leaf of
one step on the smoke configs from the reference's parameters converted,
remat against no remat, three whole steps, the layer-by-layer AdamW update
(``chunked_update``), ``run_training`` and its CLI, and a bitwise resume
from a checkpoint.

Tolerances: the loss and each gradient leaf 1e-4 of the leaf's largest
value (float32 compute; tests/test_torch_training.py); parameters after
three steps 2e-3, the reference's own step tolerance (Adam at step 1
magnifies float32 noise, v ≈ 0); the optimizer 1e-6 (the same float32
operations in the same order)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch.train import run_training
from repro_torch.models import transformer as TT
from repro_torch.training import (AdamWConfig, AdamWState, adamw_init,
                                  adamw_update, adamw_update_,
                                  make_train_step, param_tree)
from torch_recorders import recorders_off  # noqa: F401  (autouse)

GRAD_TOL, STEP_TOL, OPT_TOL = 1e-4, 2e-3, 1e-6
ARCHS = ("mamba2_2p7b", "zamba2_2p7b")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _batch(cfg, B, S, seed, step=0):
    return {k: torch.from_numpy(v) for k, v in
            TokenPipeline(cfg, global_batch=B, seq_len=S, seed=seed)
            .batch_at(step).items()}


def _np_tree(jax, tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_setup(jax, arch):
    """The same float32-compute smoke config in both packages, the
    reference's TrainState and one pipeline batch (a length that is no
    multiple of the chunk, so the scan pads)."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.training import AdamWConfig as JAdamW
    from repro.training import init_train_state as jinit

    jcfg = jsmoke(arch).with_(dtype="float32")
    tcfg = get_smoke_config(arch).with_(dtype="float32")
    jstate = jinit(jcfg, JAdamW(**OPT), jax.random.PRNGKey(3))
    return jcfg, tcfg, jstate, _batch(tcfg, 4, 29, seed=1)


def _leaf_errs(got: dict, ref: dict) -> dict:
    return {n: float((got[n] - ref[n]).abs().max()
                     / ref[n].abs().max().clamp_min(1e-30)) for n in ref}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(jax, arch):
    from repro.models import transformer as JT

    from repro_torch.convert import model_params_from_jax

    jcfg, tcfg, jstate, batch = _ref_setup(jax, arch)
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(JT.loss_fn)(jstate.params, jcfg, jb)
    model = model_params_from_jax(tcfg, _np_tree(jax, jstate.params))
    port = TT.loss_fn(model, tcfg, batch)
    port.backward()
    np.testing.assert_allclose(float(port.detach()), float(loss),
                               rtol=GRAD_TOL)
    ref = {n: g.detach() for n, g in param_tree(
        model_params_from_jax(tcfg, _np_tree(jax, grads))).items()}
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == ref.keys() and any("mamba" in n for n in got)
    errs = _leaf_errs(got, ref)
    assert max(errs.values()) <= GRAD_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """Each Mamba layer (and shared-block application) checkpointed
    recomputes the same values: bit-equal gradients, the scan run twice a
    layer."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    batch = _batch(cfg, 2, 21, seed=2)
    grads, calls = [], []
    orig = ss.SSDScan.apply

    def spy(*args):
        calls[-1] += 1
        return orig(*args)

    ss.SSDScan.apply = spy
    try:
        for remat in (False, True):
            calls.append(0)
            model = TT.init_params(cfg, torch.Generator().manual_seed(0))
            TT.loss_fn(model, cfg.with_(remat=remat), batch).backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
    finally:
        ss.SSDScan.apply = orig
    assert calls == [cfg.n_layers, 2 * cfg.n_layers]
    for n, g in grads[0].items():
        assert g is not None and bool(g.any()), n
        assert torch.equal(g, grads[1][n]), n
    # save_attn changes nothing here: the reference applies it in the
    # attention stack only, and the Mamba layers and shared blocks keep
    # nothing_saveable
    model = TT.init_params(cfg, torch.Generator().manual_seed(0))
    TT.loss_fn(model, cfg.with_(remat=True, remat_policy="save_attn"),
               batch).backward()
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, grads[1][n]), n


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(jax, arch):
    """The first step's moments within 1e-4 of each leaf's largest value
    (they are the gradients); after three steps the parameters within
    2e-3 and the moments within 2e-3 of their scale: from the second step
    on the gradients are taken at parameters that differ already (Adam's
    first step moves each by about lr, whatever the gradient's size)."""
    from repro.training import AdamWConfig as JAdamW
    from repro.training import make_train_step as jmake

    from repro_torch.convert import train_state_from_jax

    jcfg, tcfg, jstate, _ = _ref_setup(jax, arch)
    state = train_state_from_jax(tcfg, _np_tree(jax, jstate))
    jstep = jax.jit(jmake(jcfg, JAdamW(**OPT)))
    step = make_train_step(tcfg, AdamWConfig(**OPT))
    for s in range(3):
        batch = _batch(tcfg, 4, 24, seed=4, step=s)
        jstate, jm = jstep(jstate, {k: jax.numpy.asarray(v.numpy())
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=GRAD_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_TOL)
        ref = train_state_from_jax(tcfg, _np_tree(jax, jstate))
        tol = GRAD_TOL if s == 0 else STEP_TOL
        for which in ("m", "v"):
            errs = _leaf_errs(getattr(state.opt, which),
                              getattr(ref.opt, which))
            assert max(errs.values()) <= tol, (s, which, errs)
    assert int(state.opt.step) == int(ref.opt.step) == 3
    ref_p = param_tree(ref.params)
    for name, p in state.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref_p[name].detach().numpy(),
                                   atol=STEP_TOL, err_msg=name)


def _opt_tree(rng):
    """A stacked leaf above 2**24 elements (updated slice by slice), a
    stacked one below it, a matrix, a vector and a scalar."""
    shapes = {"big": (3, 2048, 2731), "small3d": (4, 3, 5), "w": (6, 7),
              "b": (9,), "s": ()}
    return {n: np.asarray(rng.normal(size=s), np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_chunked_update_matches_jax_and_the_unchunked_update(jax,
                                                             state_dtype):
    """Two steps, in place, against the reference's ``chunked_update``
    within 1e-6, and bit-equal to the port's update without it. With
    bfloat16 moments the second step is held to one bf16 ulp of each
    moment, and the parameters to lr 2^-6: XLA fuses ``m b1 + (1 - b1) g``
    into one rounding where torch rounds twice, and over 16.8M elements a
    few of those float32 values land on the other side of a bf16 rounding
    boundary (about 0.005 %), which moves their update by up to 2^-8 of
    itself."""
    from repro.training import optimizer as JO

    jnp = jax.numpy
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    assert params["big"].size > 2 ** 24
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6,
              state_dtype=state_dtype, chunked_update=True)
    jcfg, tcfg = JO.AdamWConfig(**kw), AdamWConfig(**kw)
    flat = AdamWConfig(**{**kw, "chunked_update": False})
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    fp = {n: t.clone() for n, t in tp.items()}
    js, ts, fs = (JO.adamw_init(jp, jcfg), adamw_init(tp, tcfg),
                  adamw_init(fp, flat))
    for step in range(2):
        loose = state_dtype == "bfloat16" and step > 0
        p_tol = kw["lr"] * 2.0 ** -6 if loose else OPT_TOL
        g = {n: np.asarray(rng.normal(size=a.shape), np.float32)
             for n, a in params.items()}
        tg = {n: torch.from_numpy(a) for n, a in g.items()}
        jp, js, jm = JO.adamw_update({n: jnp.asarray(a) for n, a in
                                      g.items()}, js, jp, jcfg)
        ts, tm = adamw_update_(tg, ts, tp, tcfg)           # in place
        fp, fs, fm = adamw_update(tg, fs, fp, flat)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            assert float(tm[key]) == float(fm[key])
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       atol=p_tol, rtol=OPT_TOL)
            assert torch.equal(tp[n], fp[n]), n
            for port, flat_s, ref in ((ts.m, fs.m, js.m),
                                      (ts.v, fs.v, js.v)):
                assert str(port[n].dtype) == f"torch.{state_dtype}"
                assert torch.equal(port[n], flat_s[n]), n
                np.testing.assert_allclose(
                    port[n].float().numpy(), np.asarray(ref[n], np.float32),
                    atol=OPT_TOL, rtol=2.0 ** -8 if loose else OPT_TOL)


def test_functional_update_leaves_its_inputs_alone():
    params = {"w": torch.randn(3, 4), "b": torch.randn(4)}
    cfg = AdamWConfig()
    state = adamw_init(params, cfg)
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    before = ({n: p.clone() for n, p in params.items()},
              {n: t.clone() for n, t in state.m.items()})
    new_p, new_s, _ = adamw_update(grads, state, params, cfg)
    assert isinstance(new_s, AdamWState) and int(new_s.step) == 1
    assert int(state.step) == 0
    for n in params:
        assert torch.equal(params[n], before[0][n])
        assert torch.equal(state.m[n], before[1][n])
        assert not torch.equal(new_p[n], params[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_learns_on_the_cpu(arch):
    out = run_training(arch=arch, steps=12, global_batch=4, seq_len=24,
                       verbose=False, seed=1, device="cpu")
    losses = out["losses"]
    assert np.isfinite(losses).all() and len(out["step_s"]) == 12
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert out["config"].remat and out["config"].family in ("ssm", "hybrid")


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_resume_is_bitwise_identical(tmp_path, arch):
    """8 straight steps == 4 steps + restart + 4 steps, on every parameter
    (the Mamba and shared blocks' too), Adam moment and the step."""
    kw = dict(arch=arch, global_batch=2, seq_len=20, verbose=False, seed=5,
              lr=1e-3, schedule_steps=8, device="cpu")
    ref = run_training(steps=8, **kw)
    d = tmp_path / "ckpt"
    run_training(steps=4, checkpoint_dir=str(d), ckpt_every=4, **kw)
    resumed = run_training(steps=8, checkpoint_dir=str(d), ckpt_every=4,
                           **kw)
    assert resumed["start_step"] == 4 and resumed["losses"] == \
        ref["losses"][4:]
    a, b = ref["state"], resumed["state"]
    assert int(a.opt.step) == int(b.opt.step) == 8
    for (n, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), n
    for which in ("m", "v"):
        for n, t in getattr(a.opt, which).items():
            assert torch.equal(t, getattr(b.opt, which)[n]), (which, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_the_cpu(monkeypatch, capsys, arch):
    from repro_torch.launch import train

    monkeypatch.setattr("sys.argv", ["train", "--arch", arch, "--steps",
                                     "2", "--seq-len", "16",
                                     "--global-batch", "2", "--device",
                                     "cpu"])
    train.main()
    out = capsys.readouterr().out
    assert "[train] step     0" in out and "[train] done" in out


def test_train_state_converts_for_both_trees(jax):
    """``train_state_from_jax`` carries the ssm and hybrid trees' params
    and AdamW moments (bf16 moments too) leaf for leaf."""
    from repro.training import AdamWConfig as JAdamW
    from repro.training import init_train_state as jinit
    from repro.configs import get_smoke_config as jsmoke

    from repro_torch.convert import train_state_from_jax

    for arch in ARCHS:
        for sdt in ("float32", "bfloat16"):
            jcfg = jsmoke(arch)
            jstate = jinit(jcfg, JAdamW(state_dtype=sdt),
                           jax.random.PRNGKey(1))
            m = jax.tree_util.tree_map(lambda a: a + 1, jstate.opt.m)
            jstate = jstate._replace(opt=jstate.opt._replace(m=m))
            state = train_state_from_jax(get_smoke_config(arch),
                                         _np_tree(jax, jstate))
            names = list(param_tree(state.params))
            assert list(state.opt.m) == list(state.opt.v) == names
            assert any(n.startswith("mamba.") for n in names)
            assert (arch == "zamba2_2p7b") == any(
                n.startswith("shared.") for n in names)
            for n in names:
                assert state.opt.m[n].dtype == getattr(torch, sdt)
                assert bool((state.opt.m[n].float() == 1).all()), n
                assert not state.opt.v[n].any(), n
