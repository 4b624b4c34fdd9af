"""repro_torch.distributed.compression and run_training(compression=...)
against the reference's repro.distributed.compression on the CPU:
topk_compress exact (ties at the threshold included), int8_compress exact
given the reference's uniform draws and unbiased over 2,000 draws of its
own, ErrorFeedback.transform over a smoke model's reference gradients for
three steps with their carries (topk exact; int8 exact with the
reference's draws injected), the carry of a stacked leaf spanning every
layer, and the compressed training loop's losses against the reference's.

Tolerances: the compressors are exact (the same float32 operations; the
reference's transform is run as written, op by op: under jax.jit its int8
residual differs from its own eager one in the last bit, XLA's CPU
compiler fusing the product and the difference). The
training losses are held at 2e-3 relative, the step tolerance of
tests/test_torch_training.py: the two frameworks' bf16 gradients differ in
the last bits, and top-k's mask flips wherever such a difference crosses
the threshold, so the runs part by more than float32 rounding."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import (RefLeaf, model_params_from_jax,
                                 reference_leaves)
from repro_torch.distributed import (ErrorFeedback, int8_compress,
                                     int8_round, topk_compress)
from repro_torch.training import param_tree

STEP_TOL = 2e-3


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ===========================================================================
# tests/test_substrate.py's compression cases, on the port
# ===========================================================================

def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, 0.0, -0.3])
    kept, resid = topk_compress(g, frac=0.34)
    assert torch.equal(kept, torch.tensor([0, -5.0, 0, 3.0, 0, 0]))
    assert torch.equal(kept + resid, g)


def test_int8_unbiased_and_bounded():
    """2,000 draws: each element's mean within 4σ of g (σ of the mean of
    a scaled Bernoulli(p), p the fractional part), every sample within
    one quantum."""
    g = _t(np.random.default_rng(0).normal(size=256))
    gen = torch.Generator().manual_seed(0)
    n = 2000
    deqs = torch.stack([int8_compress(g, gen)[0] for _ in range(n)])
    scale = float(g.abs().max()) / 127.0
    x = g.double() / scale
    p = x - torch.floor(x)
    sigma = scale * torch.sqrt(p * (1 - p) / n)
    err = (deqs.double().mean(0) - g.double()).abs()
    assert (err <= 4 * sigma + 1e-7).all(), float((err / sigma).max())
    assert float((deqs - g[None]).abs().max()) <= scale * (1 + 1e-5)


def test_error_feedback_preserves_signal():
    ef = ErrorFeedback(method="topk", frac=0.25)
    rng = np.random.default_rng(0)
    g_total = np.zeros(64)
    applied_total = np.zeros(64)
    carry = ef.init({"w": torch.zeros(64)})
    for _ in range(50):
        g = rng.normal(size=64).astype(np.float32)
        g_total += g
        out, carry = ef.transform({"w": torch.from_numpy(g)}, carry)
        applied_total += out["w"].numpy()
    np.testing.assert_allclose(applied_total + carry["w"].numpy(), g_total,
                               atol=1e-3)


# ===========================================================================
# against the reference
# ===========================================================================

def _grads_with_ties(rng, shape):
    g = rng.normal(size=shape).astype(np.float32)
    flat = g.reshape(-1)
    # a run of equal magnitudes, both signs, where the threshold falls
    order = np.argsort(-np.abs(flat))
    k = max(1, int(flat.size * 0.1))
    tie = np.abs(flat[order[k - 1]])
    run = order[max(0, k - 3):k + 4]
    flat[run] = tie * np.where(np.arange(run.size) % 2, -1.0, 1.0)
    return g


@pytest.mark.parametrize("shape", [(8,), (257,), (4, 37, 5)])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.34])
def test_topk_exact_against_the_reference(jax, shape, frac):
    from repro.distributed.compression import topk_compress as jtopk

    g = _grads_with_ties(np.random.default_rng(len(shape)), shape)
    want_k, want_r = jtopk(jax.numpy.asarray(g), frac)
    kept, resid = topk_compress(torch.from_numpy(g), frac)
    assert np.array_equal(kept.numpy(), np.asarray(want_k))
    assert np.array_equal(resid.numpy(), np.asarray(want_r))
    assert int((kept != 0).sum()) >= max(1, int(g.size * frac))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_int8_exact_with_the_references_draws(jax, seed):
    from repro.distributed.compression import int8_compress as jint8

    g = np.random.default_rng(seed).normal(size=(3, 50)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want_d, want_r = jint8(jax.numpy.asarray(g), key)
    u = _t(jax.random.uniform(key, g.shape))
    deq, resid = int8_round(torch.from_numpy(g), u)
    assert np.array_equal(deq.numpy(), np.asarray(want_d))
    assert np.array_equal(resid.numpy(), np.asarray(want_r))


def _reference_grads(jax, n_steps):
    """A float32 smollm smoke model's gradients on n_steps pipeline
    batches, from the reference, as (reference trees, port dicts)."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.data import TokenPipeline
    from repro.models import transformer as JT

    jcfg = jsmoke("smollm_360m").with_(dtype="float32")
    tcfg = get_smoke_config("smollm_360m").with_(dtype="float32")
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    pipe = TokenPipeline(jcfg, global_batch=4, seq_len=32, seed=1)
    grad = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, jcfg, b)))
    trees, dicts = [], []
    for step in range(n_steps):
        b = {k: jax.numpy.asarray(v) for k, v in pipe.batch_at(step).items()}
        tree = grad(params, b)
        trees.append(tree)
        dicts.append({n: p.detach() for n, p in param_tree(
            model_params_from_jax(tcfg, jax.tree_util.tree_map(
                np.asarray, tree))).items()})
    model = model_params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray,
                                                               params))
    return trees, dicts, reference_leaves(model)


def _stack(tensors, leaf):
    got = [tensors[n] for n in leaf.names]
    return (torch.stack(got) if leaf.stacked else got[0]).numpy()


@pytest.mark.parametrize("method", ["topk", "int8"])
def test_error_feedback_three_steps_against_the_reference(jax, method):
    from repro.distributed.compression import ErrorFeedback as JEF

    trees, dicts, leaves = _reference_grads(jax, 3)
    jef = JEF(method=method, frac=0.05, seed=3)
    ef = ErrorFeedback(method=method, frac=0.05, seed=3, leaves=leaves)
    key = jax.random.PRNGKey(3)

    def reference_draws(i, leaf):
        return _t(jax.random.uniform(jax.random.fold_in(key, i),
                                     tuple(leaf.shape)))

    jcarry, carry = jef.init(trees[0]), ef.init(dicts[0])
    jtransform = jef.transform
    for tree, grads in zip(trees, dicts):
        jout, jcarry = jtransform(tree, jcarry)
        out, carry = ef.transform(grads, carry, uniform=reference_draws)
        for leaf, want_o, want_c in zip(
                leaves, jax.tree_util.tree_leaves(jout),
                jax.tree_util.tree_leaves(jcarry)):
            assert np.array_equal(_stack(out, leaf), np.asarray(want_o)), \
                leaf.path
            assert np.array_equal(_stack(carry, leaf), np.asarray(want_c)), \
                leaf.path


def test_stacked_leaf_takes_one_threshold_over_every_layer():
    """A layer whose gradients are all small keeps nothing when another
    layer's dominate: the threshold spans the stacked leaf."""
    big, small = torch.full((4, 8), 2.0), torch.full((4, 8), 1e-3)
    grads = {"layers.0.w": big, "layers.1.w": small}
    leaves = [RefLeaf("layers/w", ("layers.0.w", "layers.1.w"), True)]
    ef = ErrorFeedback(method="topk", frac=0.5, leaves=leaves)
    out, carry = ef.transform(grads, ef.init(grads))
    assert torch.equal(out["layers.0.w"], big)
    assert not out["layers.1.w"].any()
    assert torch.equal(carry["layers.1.w"], small)
    # one leaf per key (the reference's flattening of a dict): each keeps
    # its own top half
    out, _ = ErrorFeedback(method="topk", frac=0.5).transform(
        grads, ErrorFeedback().init(grads))
    assert out["layers.1.w"].any()


def test_run_training_topk_against_the_references_losses(jax, monkeypatch):
    """Both loops start from the reference's parameters: the port's
    initializer is replaced by the reference's state, converted."""
    import repro_torch.launch.train as LT
    from repro.configs import get_smoke_config as jsmoke
    from repro.launch.train import run_training as jrun
    from repro.training import AdamWConfig as JAdamW
    from repro.training import init_train_state as jinit

    from repro_torch.convert import train_state_from_jax

    steps, kw = 6, dict(arch="smollm_360m", global_batch=4, seq_len=32,
                        compression="topk", verbose=False, seed=0)
    want = jrun(steps=steps, **kw)["losses"]

    def reference_init(cfg, opt_cfg, generator):
        st = jinit(jsmoke("smollm_360m").with_(remat=True),
                   JAdamW(lr=opt_cfg.lr, warmup_steps=opt_cfg.warmup_steps,
                          total_steps=opt_cfg.total_steps),
                   jax.random.PRNGKey(0))
        return train_state_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                                st))

    monkeypatch.setattr(LT, "init_train_state", reference_init)
    out = LT.run_training(steps=steps, device="cpu", **kw)
    np.testing.assert_allclose(out["losses"], want, rtol=STEP_TOL)
    assert set(out["carry"]) == set(param_tree(out["state"].params))


def test_run_training_int8_and_the_cli(monkeypatch, capsys):
    import sys

    from repro_torch.launch.train import main, run_training

    out = run_training(steps=3, global_batch=4, seq_len=32,
                       compression="int8", verbose=False, device="cpu")
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3
    assert all(c.dtype == torch.float32 for c in out["carry"].values())
    monkeypatch.setattr(sys, "argv", [
        "train", "--device", "cpu", "--steps", "2", "--global-batch", "4",
        "--seq-len", "32", "--compression", "topk"])
    main()
    assert "[train] done" in capsys.readouterr().out
