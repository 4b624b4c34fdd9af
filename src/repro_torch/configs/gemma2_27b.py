"""gemma2-27b — local/global alternating attention, softcaps [arXiv:2408.00118]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense", n_layers=46, d_model=4608,
        n_heads=32, n_kv_heads=16, d_ff=36864, vocab_size=256000,
        head_dim=128, block_pattern=("swa", "full"), window=4096,
        logit_softcap=30.0, attn_softcap=50.0, scale_embed=True,
        post_norms=True, act="gelu", tie_embeddings=True,
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
        block_pattern=("swa", "full"), window=16, logit_softcap=30.0,
        attn_softcap=50.0, scale_embed=True, post_norms=True, act="gelu",
        tie_embeddings=True, rope_theta=10_000.0,
    )
