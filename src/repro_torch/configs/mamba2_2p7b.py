"""mamba2-2.7b — attention-free SSD stack [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
        block_pattern=("mamba",), ssm_state=128, ssm_head_dim=64,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=256,
        block_pattern=("mamba",), ssm_state=16, ssm_head_dim=16,
        ssm_chunk=8, tie_embeddings=True,
    )
