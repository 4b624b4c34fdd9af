"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3 family]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
        n_heads=64, n_kv_heads=4, d_ff=1536, vocab_size=151936,
        head_dim=128, n_experts=128, top_k=8, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=512, head_dim=16,
        n_experts=8, top_k=2,
    )
