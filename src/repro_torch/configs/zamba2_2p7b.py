"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

Simplification vs the released model (documented in DESIGN.md): the two
alternating shared transformer blocks take the residual stream directly
(no concatenated original-embedding input, no LoRA projectors)."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000,
        head_dim=80, block_pattern=("mamba",), ssm_state=64,
        ssm_head_dim=64, shared_attn_every=6, n_shared_blocks=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        block_pattern=("mamba",), ssm_state=16, ssm_head_dim=16,
        ssm_chunk=8, shared_attn_every=2, n_shared_blocks=2,
    )
