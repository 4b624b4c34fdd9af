"""The port's models (repro_torch.models) against the JAX reference
(repro.models) on the CPU: the primitives, one attention and one MLP block,
and the whole model's prefill and decode logits on the smoke configs of
smollm-360m, gemma2-27b, a sliding-window smollm whose cache is a ring,
mamba2-2.7b (ssm) and zamba2-2.7b (hybrid).
The reference's parameters are converted with
``repro_torch.convert.model_params_from_jax``, so both packages compute the
same function. Tolerances: 1e-4 in float32, 3e-2 in bfloat16 (the two
frameworks round bf16 at different places)."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
RING = dict(block_pattern=("swa",), window=16)


@pytest.fixture(autouse=True)
def _forward_only():
    """The port's parameters are trainable; these tests compare forward
    values, so they run without autograd, as serving does."""
    with torch.no_grad():
        yield


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _cfgs(arch, dtype, **over):
    """The same smoke config from both packages."""
    kw = dict(dtype=dtype, remat=False, **over)
    return jax_smoke(arch).with_(**kw), get_smoke_config(arch).with_(**kw)


# ===========================================================================
# primitives and blocks
# ===========================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    scale = rng.normal(size=48).astype(np.float32) * 0.1
    ref = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-5)
    port = TL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(scale), 1e-5)
    assert port.dtype == getattr(torch, dtype)
    _close(port, ref, dtype)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, 47, dtype=np.int32), (2, 7))
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    port = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                         theta)
    _close(port, ref, "float32")


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_block_matches_jax(act):
    jcfg, tcfg = _cfgs("smollm_360m", "float32", act=act)
    p = JL.init_mlp(jcfg, jax.random.PRNGKey(0), jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 6, jcfg.d_model))
    x = x.astype(np.float32)
    ref = JL.mlp_block(p, jcfg, jnp.asarray(x), ctx=None)
    mlp = TL.MLP(*(torch.from_numpy(np.array(p[n]))
                   for n in ("w_gate", "w_up", "w_down")))
    _close(TL.mlp_block(mlp, tcfg, torch.from_numpy(x)), ref, "float32")


@pytest.mark.parametrize("arch,window", [("smollm_360m", 0),
                                         ("gemma2_27b", 5)])
def test_attention_block_matches_jax(arch, window):
    """No cache (full sequence), then a prefill into a cache and one decode
    step that writes it and attends it."""
    jcfg, tcfg = _cfgs(arch, "float32")
    p = JL.init_attention(jcfg, jax.random.PRNGKey(1), jnp.float32)
    attn = TL.Attention(*(torch.from_numpy(np.array(p[n]))
                          for n in ("wq", "wk", "wv", "wo")))
    B, S, Sc = 2, 12, 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S + 1, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    ref, _ = JL.attention_block(p, jcfg, jnp.asarray(x[:, :S]), pos,
                                ctx=None, window=window)
    port, _ = TL.attention_block(attn, tcfg, torch.from_numpy(x[:, :S]), 0,
                                 window=window)
    _close(port, ref, "float32")

    hkv, hd = jcfg.gqa.n_kv_pad, jcfg.head_dim
    jc = (jnp.zeros((B, Sc, hkv, hd)), jnp.zeros((B, Sc, hkv, hd)))
    tc = (torch.zeros(B, Sc, hkv, hd), torch.zeros(B, Sc, hkv, hd))
    ref, jc = JL.attention_block(p, jcfg, jnp.asarray(x[:, :S]), pos,
                                 ctx=None, window=window, kv_cache=jc,
                                 kv_len=jnp.full((B,), S, jnp.int32))
    port, tc = TL.attention_block(attn, tcfg, torch.from_numpy(x[:, :S]), 0,
                                  window=window, kv_cache=tc)
    _close(port, ref, "float32")
    _close(tc[0], jc[0], "float32")
    ref, jc = JL.attention_block(
        p, jcfg, jnp.asarray(x[:, S:]), jnp.full((B, 1), S, jnp.int32),
        ctx=None, window=window, kv_cache=jc,
        kv_len=jnp.full((B,), S + 1, jnp.int32))
    port, tc = TL.attention_block(
        attn, tcfg, torch.from_numpy(x[:, S:]), S, window=window,
        kv_cache=tc, kv_len=torch.full((B,), S + 1, dtype=torch.int32))
    _close(port, ref, "float32")
    _close(tc[1], jc[1], "float32")


# ===========================================================================
# the whole model: prefill and decode logits
# ===========================================================================

@functools.lru_cache(maxsize=None)
def _jax_model(arch, dtype, over):
    jcfg, tcfg = _cfgs(arch, dtype, **dict(over))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, tree


MODEL_CASES = [
    ("smollm_360m", "float32", ()),
    ("smollm_360m", "bfloat16", ()),
    ("gemma2_27b", "float32", ()),
    ("gemma2_27b", "bfloat16", ()),
    ("smollm_360m", "float32", tuple(RING.items())),
    ("smollm_360m", "bfloat16", tuple(RING.items())),
    ("mamba2_2p7b", "float32", ()),
    ("mamba2_2p7b", "bfloat16", ()),
    ("zamba2_2p7b", "float32", ()),
    ("zamba2_2p7b", "bfloat16", ()),
]


@pytest.mark.parametrize("arch,dtype,over", MODEL_CASES,
                         ids=lambda c: str(c) if c else "")
def test_prefill_and_decode_logits_match_jax(arch, dtype, over):
    jcfg, tcfg, params, tree = _jax_model(arch, dtype, over)
    model = model_params_from_jax(tcfg, tree)
    B, S, max_seq, steps = 2, 20, 32, 4
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S))
    jc, ring = JT.init_cache(jcfg, B, max_seq)
    tc, tring = TT.init_cache(tcfg, B, max_seq, "cpu")
    assert ring == tring == bool(over)
    prefill = jax.jit(lambda p, t, c: JT.prefill(p, jcfg, {"tokens": t}, c,
                                                 ring))
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c, ring))
    jl, jc = prefill(params, jnp.asarray(toks, jnp.int32), jc)
    with torch.inference_mode():
        tl, tc = TT.prefill(model, tcfg, torch.from_numpy(toks), tc, ring)
    _close(tl, jl, dtype)
    for _ in range(steps):   # teacher-forced on the reference's tokens
        tok = np.array(jnp.argmax(jl[:, :jcfg.vocab_size], -1))
        jl, jc = decode(params, jnp.asarray(tok, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = TT.decode_step(model, tcfg, torch.from_numpy(tok), tc,
                                    ring)
        _close(tl, jl, dtype)
    assert tc.pos == S + steps
    for name in ("kv_k", "conv", "ssm"):
        _close(getattr(tc, name), getattr(jc, name), dtype)


def _forward_matches_jax(arch):
    jcfg, tcfg, params, tree = _jax_model(arch, "float32", ())
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 18))
    ref = JT.forward(params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    port = TT.forward(model_params_from_jax(tcfg, tree), tcfg,
                      torch.from_numpy(toks))
    _close(port, ref, "float32")


def test_forward_matches_jax():
    _forward_matches_jax("gemma2_27b")


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_2p7b"])
def test_mamba_forward_matches_jax(arch):
    """18 tokens, not a multiple of the smoke configs' chunk (8): the
    dispatcher pads the scan."""
    _forward_matches_jax(arch)


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_2p7b",
                                  "zamba2_2p7b"])
def test_decode_matches_forward(arch):
    """The last position's logits of a full forward equal prefill(S - 1)
    and one decode step (tests/test_models.py::test_decode_matches_forward,
    at the same 2e-3): the KV cache, the conv state and the SSM state
    carry the sequence."""
    cfg = get_smoke_config(arch).with_(dtype="float32", remat=False)
    model = TT.init_params(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.inference_mode():
        x = TT.forward(model, cfg, toks)
        full = TT.logits_fn(model, cfg, x[:, -1:])[:, 0]
        cache, ring = TT.init_cache(cfg, B, S, "cpu")
        _, cache = TT.prefill(model, cfg, toks[:, :-1], cache, ring)
        dec, _ = TT.decode_step(model, cfg, toks[:, -1], cache, ring)
    torch.testing.assert_close(dec, full, atol=2e-3, rtol=2e-3)


def test_converted_params_keep_the_reference_layout():
    jcfg, tcfg, params, tree = _jax_model("gemma2_27b", "float32", ())
    model = model_params_from_jax(tcfg, tree)
    assert model.head is None and len(model.layers) == jcfg.n_layers
    for i, layer in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                getattr(layer.attn, name).numpy(),
                tree["layers"]["attn"][name][i])
        np.testing.assert_array_equal(layer.ln_pf.numpy(),
                                      tree["layers"]["ln_pf"]["scale"][i])
    fresh = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {n: p.shape for n, p in fresh.named_parameters()} == \
        {n: p.shape for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_2p7b"])
def test_converted_mamba_params_keep_the_reference_layout(arch):
    jcfg, tcfg, params, tree = _jax_model(arch, "float32", ())
    model = model_params_from_jax(tcfg, tree)
    assert len(model.mamba) == jcfg.n_layers and not model.layers
    mt = tree["mamba"]
    for i, layer in enumerate(model.mamba):
        for name, val in layer.block.named_parameters():
            np.testing.assert_array_equal(val.numpy(), mt["block"][name][i])
        np.testing.assert_array_equal(layer.ln.numpy(), mt["ln"]["scale"][i])
    assert len(model.shared) == (jcfg.n_shared_blocks
                                 if jcfg.family == "hybrid" else 0)
    for i, blk in enumerate(model.shared):
        np.testing.assert_array_equal(blk.attn.wq.numpy(),
                                      tree["shared"]["attn"]["wq"][i])
    assert (model.head is None) == jcfg.tie_embeddings
    fresh = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {n: p.shape for n, p in fresh.named_parameters()} == \
        {n: p.shape for n, p in model.named_parameters()}
    assert {n: p.dtype for n, p in fresh.named_parameters()} == \
        {n: p.dtype for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_2p7b"])
def test_cache_spec_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jspec, jring = JT.cache_spec(jcfg, 3, 40)
    tspec, tring = TT.cache_spec(tcfg, 3, 40)
    assert jring == tring is False
    for name, (shape, dtype) in tspec.items():
        assert shape == jspec[name][0], name
        assert str(dtype).split(".")[-1] == jspec[name][1], name


def test_init_params_zeroes_padded_heads():
    cfg = get_smoke_config("smollm_360m").with_(tp_shards=2)
    pad = cfg.gqa
    assert not pad.is_identity
    model = TT.init_params(cfg, torch.Generator().manual_seed(1))
    attn = model.layers[0].attn
    dummy = [i for i, o in enumerate(pad.q_slot_to_q) if o < 0]
    assert dummy and not attn.wq[:, dummy].any()
    assert not attn.wo[dummy].any() and attn.wq.std() > 0.01


def test_decode_past_a_full_cache_raises():
    """The reference clamps this write onto the last slot; the port
    refuses it."""
    cfg = get_smoke_config("smollm_360m").with_(dtype="float32")
    model = TT.init_params(cfg, torch.Generator().manual_seed(2))
    cache, ring = TT.init_cache(cfg, 1, 8, "cpu")
    assert not ring
    with torch.inference_mode():
        logits, cache = TT.prefill(model, cfg, torch.zeros(1, 8,
                                                           dtype=torch.long),
                                   cache, ring)
        with pytest.raises(ValueError, match="overruns"):
            TT.decode_step(model, cfg, logits.argmax(-1), cache, ring)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "hubert_xlarge"])
def test_unported_families_raise(arch):
    """No family is left unported: the MoE family builds its MoE layers and
    the audio frontend its frame projection and encoder head, where they
    raised NotImplementedError before."""
    cfg = get_smoke_config(arch)
    model = TT.init_params(cfg, torch.Generator().manual_seed(0))
    assert len(model.layers) == cfg.n_layers
    if cfg.n_experts:
        assert all(lp.mlp is None and isinstance(lp.moe, TL.MoE)
                   for lp in model.layers)
        assert model.layers[0].moe.router.dtype == torch.float32
    else:
        assert model.frame_in.shape == (cfg.d_model, cfg.d_model)
        assert model.head.shape == (cfg.d_model, cfg.vocab_pad)
