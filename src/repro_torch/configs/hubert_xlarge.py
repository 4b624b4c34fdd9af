"""hubert-xlarge — encoder-only audio backbone [arXiv:2106.07447].

Modality frontend is a STUB: input_specs provide precomputed frame
embeddings at the backbone width (per assignment rules)."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504,
        head_dim=80, encoder_only=True, causal=False, frontend="audio",
        act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=63, head_dim=16,
        encoder_only=True, causal=False, frontend="audio", act="gelu",
    )
