"""command-r-35b — GQA, no-bias dense [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense", n_layers=40, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22528, vocab_size=256000,
        head_dim=128, rope_theta=8_000_000.0, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=1, d_ff=256, vocab_size=512, head_dim=16,
        tie_embeddings=True,
    )
