"""The port's audio and vision frontends (repro_torch.models.transformer)
against the JAX reference on the CPU: hubert-xlarge's smoke config (audio
frames through ``frame_in``, a non-causal encoder with its own head) and
internvl2-1b's (patch embeddings through ``patch_in`` before the token
embeddings): ``embed_input``, ``forward`` logits, ``prefill`` and
``decode_step`` logits, and ``loss_fn`` over a frontend batch.

Weights come from the reference's ``init_params`` and are converted with
``repro_torch.convert.model_params_from_jax``; frames, patches and tokens
from a NumPy seed. Tolerances: 1e-4 in float32, 3e-2 in bfloat16 (the
port's model tolerances)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import ModelServer  # noqa: E402

ARCHS = ["hubert_xlarge", "internvl2_1b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _forward_only():
    """The port's parameters are trainable; these tests compare forward
    values, so they run without autograd, as serving does."""
    with torch.no_grad():
        yield


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _models(arch, dtype, seed):
    kw = dict(dtype=dtype, remat=False)
    jcfg, tcfg = jax_smoke(arch).with_(**kw), get_smoke_config(arch).with_(**kw)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    model = model_params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, model


def _batch(cfg, B, S, seed):
    """The reference's batch dict and the port's keyword arguments: S
    frames (audio), or S patches then S // 2 tokens (vision)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        return {"frames": jnp.asarray(emb)}, dict(
            tokens=None, frames=torch.from_numpy(emb))
    toks = rng.integers(0, cfg.vocab_size, (B, S // 2))
    return ({"patches": jnp.asarray(emb),
             "tokens": jnp.asarray(toks, jnp.int32)},
            dict(tokens=torch.from_numpy(toks),
                 patches=torch.from_numpy(emb)))


@pytest.fixture(scope="module", params=ARCHS)
def f32_models(request):
    return _models(request.param, "float32", 0)


def test_frontend_parameters(f32_models):
    jcfg, tcfg, params, model = f32_models
    name = {"audio": "frame_in", "vision": "patch_in"}[tcfg.frontend]
    np.testing.assert_array_equal(getattr(model, name).numpy(),
                                  np.asarray(params["embed"][name]))
    assert model.head is not None and "head" in params
    if tcfg.encoder_only:
        assert not tcfg.causal


def test_embed_input_matches_reference(f32_models):
    jcfg, tcfg, params, model = f32_models
    jb, tb = _batch(tcfg, 2, 12, 1)
    ref = JT.embed_input(params, jcfg, jb, None)
    got = TT.embed_input(model, tcfg, tb.pop("tokens"), **tb)
    assert got.shape == tuple(ref.shape)
    _close(got, ref, TOL["float32"])


def test_forward_matches_reference(f32_models):
    jcfg, tcfg, params, model = f32_models
    jb, tb = _batch(tcfg, 2, 16, 2)
    ref = JT.forward(params, jcfg, jb)
    got = TT.forward(model, tcfg, tb.pop("tokens"), **tb)
    _close(got, ref, TOL["float32"])
    _close(TT.logits_fn(model, tcfg, got),
           JT.logits_fn(params, jcfg, ref, None), TOL["float32"])


def test_prefill_and_decode_match_reference(f32_models):
    """The prompt (frames, or patches + tokens) prefilled into a 40-slot
    cache, then 5 decode steps on tokens (the VLM decodes tokens)."""
    jcfg, tcfg, params, model = f32_models
    B, Sc = 2, 40
    jb, tb = _batch(tcfg, B, 16, 3)
    jcache, ring = JT.init_cache(jcfg, B, Sc)
    tcache, tring = TT.init_cache(tcfg, B, Sc, "cpu")
    assert ring == tring
    ref, jcache = JT.prefill(params, jcfg, jb, jcache, ring)
    got, tcache = TT.prefill(model, tcfg, tb.pop("tokens"), tcache, ring,
                             **tb)
    _close(got, ref, TOL["float32"])
    assert tcache.pos == int(np.asarray(jcache.pos)[0])
    steps = np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, 5))
    for t in range(steps.shape[1]):
        ref, jcache = JT.decode_step(params, jcfg,
                                     jnp.asarray(steps[:, t], jnp.int32),
                                     jcache, ring)
        got, tcache = TT.decode_step(model, tcfg,
                                     torch.from_numpy(steps[:, t]), tcache,
                                     ring)
        _close(got, ref, TOL["float32"])


def test_loss_matches_reference(f32_models):
    jcfg, tcfg, params, model = f32_models
    jb, tb = _batch(tcfg, 2, 16, 5)
    S = 16 + (0 if tcfg.frontend == "audio" else 8)
    targets = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, S))
    ref = JT.loss_fn(params, jcfg,
                     dict(jb, targets=jnp.asarray(targets, jnp.int32)))
    batch = {k: v for k, v in tb.items() if v is not None}
    got = TT.loss_fn(model, tcfg, dict(batch,
                                       targets=torch.from_numpy(targets)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    jcfg, tcfg, params, model = _models(arch, "bfloat16", 7)
    jb, tb = _batch(tcfg, 2, 16, 8)
    ref = JT.forward(params, jcfg, jb)
    got = TT.forward(model, tcfg, tb.pop("tokens"), **tb)
    assert got.dtype == torch.bfloat16
    _close(got, ref, TOL["bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_token_only_calls_name_the_missing_input(arch):
    """A frontend model needs its frames or patches: the token-only paths
    (``ModelServer.generate``, which the reference cannot run for these
    configs either) raise a ValueError that names them."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    model = TT.init_params(cfg, torch.Generator().manual_seed(0))
    what = {"audio": "frames", "vision": "patches"}[cfg.frontend]
    with pytest.raises(ValueError, match=what):
        TT.forward(model, cfg, torch.zeros(1, 4, dtype=torch.long))
    server = ModelServer(cfg, model, bucket_batch=2, bucket_seq=16,
                         device="cpu")
    with pytest.raises(ValueError, match=what):
        server.generate(np.zeros((2, 4), np.int64), n_steps=1)
