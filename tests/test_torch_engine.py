"""The port's ModelServer (repro_torch.serving.engine) against the JAX
reference's ModelServer on the CPU: the same converted parameters give the
same greedy tokens, exactly, in float32, for the dense, ssm and hybrid
families; the port refuses to overrun a non-ring KV cache where the
reference clamps the write, and an ssm model, which has no KV cache,
serves past its bucket."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serving.engine import ModelServer as JaxModelServer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.serving import ModelServer  # noqa: E402


@pytest.mark.parametrize("arch,over", [
    ("smollm_360m", {}),
    ("gemma2_27b", {}),
    ("smollm_360m", {"block_pattern": ("swa",), "window": 16}),
    ("mamba2_2p7b", {}),
    ("zamba2_2p7b", {}),
], ids=["smollm", "gemma2", "smollm-ring", "mamba2", "zamba2"])
def test_generate_gives_the_reference_tokens(arch, over):
    kw = dict(dtype="float32", remat=False, **over)
    ref = JaxModelServer(jax_smoke(arch).with_(**kw), bucket_batch=4,
                         bucket_seq=48, seed=3)
    cfg = get_smoke_config(arch).with_(**kw)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    port = ModelServer(cfg, model_params_from_jax(cfg, tree),
                       bucket_batch=4, bucket_seq=48, device="cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 24))
    want, _, _ = ref.generate(prompts.astype(np.int32), n_steps=10)
    got, prefill_s, decode_s = port.generate(prompts, n_steps=10)
    assert got.shape == (3, 10) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert prefill_s > 0 and decode_s > 0


def test_generate_refuses_to_overrun_the_cache():
    """24 prompt tokens + 10 new ones need 34 slots: the reference clamps
    the last writes onto slot 31; the port raises before it starts."""
    cfg = get_smoke_config("smollm_360m").with_(dtype="float32")
    server = ModelServer(cfg, bucket_batch=2, bucket_seq=32, device="cpu")
    prompts = np.zeros((2, 24), np.int64)
    with pytest.raises(ValueError, match="overrun"):
        server.generate(prompts, n_steps=10)
    assert server.generate(prompts, n_steps=8)[0].shape == (2, 8)
    with pytest.raises(ValueError, match="batch bucket"):
        server.generate(np.zeros((3, 4), np.int64), n_steps=1)


def test_ssm_serves_past_its_bucket():
    """mamba2 keeps only a conv and an SSM state: 24 prompt tokens + 20
    new ones run through a 32-slot bucket, and give the reference's
    tokens; zamba2's shared attention keeps a KV cache and refuses."""
    kw = dict(dtype="float32", remat=False)
    ref = JaxModelServer(jax_smoke("mamba2_2p7b").with_(**kw),
                         bucket_batch=2, bucket_seq=32, seed=4)
    cfg = get_smoke_config("mamba2_2p7b").with_(**kw)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    port = ModelServer(cfg, model_params_from_jax(cfg, tree),
                       bucket_batch=2, bucket_seq=32, device="cpu")
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 24))
    want, _, _ = ref.generate(prompts.astype(np.int32), n_steps=20)
    got, _, _ = port.generate(prompts, n_steps=20)
    np.testing.assert_array_equal(got, np.asarray(want))
    hybrid = ModelServer(get_smoke_config("zamba2_2p7b").with_(**kw),
                         bucket_batch=2, bucket_seq=32, device="cpu")
    with pytest.raises(ValueError, match="overrun"):
        hybrid.generate(prompts, n_steps=20)


def test_ring_cache_serves_past_its_window():
    cfg = get_smoke_config("smollm_360m").with_(
        dtype="float32", block_pattern=("swa",), window=16)
    server = ModelServer(cfg, bucket_batch=2, bucket_seq=32, device="cpu")
    out, _, _ = server.generate(np.ones((1, 24), np.int64), n_steps=12)
    assert out.shape == (1, 12)
    assert ((0 <= out) & (out < cfg.vocab_size)).all()


def test_server_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(get_smoke_config("smollm_360m"))
