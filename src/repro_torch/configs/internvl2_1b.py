"""internvl2-1b — InternViT + Qwen2-0.5B backbone [arXiv:2404.16821].

VLM frontend is a STUB: input_specs provide precomputed patch embeddings
at the backbone width; a learned adapter projects them in."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151655,
        head_dim=64, frontend="vision", n_vision_tokens=1024,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=1, d_ff=128, vocab_size=512, head_dim=32,
        frontend="vision", n_vision_tokens=8,
    )
