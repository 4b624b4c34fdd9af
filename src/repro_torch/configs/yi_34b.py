"""yi-34b — llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64000,
        head_dim=128, rope_theta=5_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=16,
    )
